"""The Conformer hybrid CTC/attention ASR recipe on the card (port of
``examples/conformer``): ``dataset``, ``compute_cmvn_stats``, ``train``,
``predict`` and ``convergence_run``, configured by ``conformer.yaml``."""

"""The Conv-TasNet LibriMix recipe on the card (port of
``examples/conv_tasnet``): ``train``, ``eval`` and ``convergence_run`` (the
port of ``benchmarks/separation_convergence.py``), configured by
``conv_tasnet.yaml``. The TasNet recipe (``recipes/tasnet``) runs this
recipe's train and eval loops on its own model."""

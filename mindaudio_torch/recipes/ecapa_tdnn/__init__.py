"""The ECAPA-TDNN speaker-verification recipe on the card (port of
``examples/ECAPA-TDNN``): ``dataset``, ``train_speaker_embeddings``,
``speaker_verification_cosine`` and ``convergence_run`` (a synthetic
multi-speaker corpus and the convergence protocol), configured by
``ecapatdnn.yaml``."""

"""The TasNet LibriMix recipe on the card (port of ``examples/tasnet``):
``train`` and ``eval``, configured by ``tasnet.yaml``, on the loops of
``recipes/conv_tasnet``."""

"""The DeepSpeech2 LibriSpeech recipe on the card (port of
``examples/deepspeech2``): ``dataset``, ``train``, ``eval`` and
``synthetic`` (a corpus in LibriSpeech's layout), configured by
``deepspeech2.yaml``."""

"""The FastSpeech2 text-to-speech recipe on the card (port of
``examples/fastspeech2``): ``preprocess`` (LJSpeech layout → features),
``train``, ``generate`` (text → mel) and ``convergence_run``, configured by
``fastspeech2.yaml``; ``text`` is the front end and ``synthetic`` writes a
small corpus in LJSpeech's layout."""

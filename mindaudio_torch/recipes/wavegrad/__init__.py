"""The WaveGrad vocoder recipe on the card (port of ``examples/wavegrad``):
``preprocess`` (LJSpeech layout → ``(audio, mel)`` features), ``train``,
``reverse`` (mel → audio) and ``convergence_run``, configured by
``wavegrad.yaml``."""

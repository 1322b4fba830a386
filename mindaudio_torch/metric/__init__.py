"""Metrics (port of ``mindaudio_tpu.metric``): the error rates, the equal error
rate and the separation metrics (SI-SNRi, BSS Eval SDRi)."""

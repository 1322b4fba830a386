"""Metrics (port of ``mindaudio_tpu.metric``): the error rates and the equal error rate."""

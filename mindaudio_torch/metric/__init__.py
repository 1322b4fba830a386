"""Metrics (port of ``mindaudio_tpu.metric``): only the error rates so far."""

"""Host-side data layer (port of ``mindaudio_tpu.data``): WAV I/O and resampling."""

"""Host-side data layer (port of ``mindaudio_tpu.data``): WAV I/O, resampling,
waveform augmentation and the VoxCeleb CSVs."""

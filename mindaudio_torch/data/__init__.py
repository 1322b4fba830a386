"""Host-side data layer (port of ``mindaudio_tpu.data``): WAV I/O, resampling,
waveform augmentation, the VoxCeleb CSVs and the LibriMix JSON lists."""

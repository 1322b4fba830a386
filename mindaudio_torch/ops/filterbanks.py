"""Static DSP design math (NumPy), copied from ``mindaudio_tpu.ops.filterbanks``.

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_frontend.py`` pins these functions to the originals bit
for bit. Everything here runs once at set-up and returns ``np.ndarray``s.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import get_window as _scipy_get_window

__all__ = ["kaldi_mel_banks", "get_window", "povey_window"]


def _htk_mel(frequencies):
    """Hz to mel by the HTK formula (``hz_to_mel(..., htk=True)`` there)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    return 2595.0 * np.log10(1.0 + frequencies / 700.0)


def kaldi_mel_banks(num_bins, n_fft, sample_rate, low_freq=20.0, high_freq=None,
                    dtype=np.float32):
    """Kaldi-convention mel filterbank, shape ``(n_fft // 2 + 1, num_bins)``.

    Triangles are evaluated in the mel domain (mel = 1127·ln(1+f/700)) at
    each FFT bin's mel value, with edges on a uniform mel grid over
    ``[low_freq, high_freq]`` and a zero Nyquist row.
    """
    if high_freq is None:
        high_freq = sample_rate / 2.0
    n_freqs = n_fft // 2  # kaldi leaves the nyquist bin out of the triangles
    bin_mels = _htk_mel(sample_rate / n_fft * np.arange(n_freqs))

    edge = np.linspace(_htk_mel(low_freq), _htk_mel(high_freq), num_bins + 2)
    left, center, right = edge[:-2, None], edge[1:-1, None], edge[2:, None]
    rising = (bin_mels[None, :] - left) / (center - left)
    falling = (right - bin_mels[None, :]) / (right - center)
    weights = np.maximum(0.0, np.minimum(rising, falling))  # (num_bins, n_freqs)
    weights = np.pad(weights, ((0, 0), (0, 1)))  # zero nyquist column
    return weights.T.astype(dtype)


def get_window(window, win_length):
    """Periodic analysis window by name ('hann', 'hamming', 'povey', ...)."""
    if window == "povey":
        return povey_window(win_length)
    return _scipy_get_window(window, win_length, fftbins=True)


def povey_window(win_length):
    """Kaldi's 'povey' window: symmetric hann ** 0.85 (denominator ``N-1``)."""
    n = np.arange(win_length, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    return hann**0.85

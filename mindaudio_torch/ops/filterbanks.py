"""Static DSP design math (NumPy), copied from ``mindaudio_tpu.ops.filterbanks``.

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_frontend.py`` pins these functions to the originals bit
for bit. Everything here runs once at set-up and returns ``np.ndarray``s.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import get_window as _scipy_get_window

__all__ = ["kaldi_mel_banks", "melscale_fbanks", "get_window", "povey_window"]


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


def _htk_hz(mels):
    """Mel to Hz by the HTK formula (``mel_to_hz(..., htk=True)`` there)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)


def melscale_fbanks(n_freqs, f_min, f_max, n_mels, sample_rate, dtype=np.float32):
    """torchaudio-convention mel filterbank on HTK mels without area
    normalization (``melscale_fbanks(..., norm=None, mel_scale="htk")``
    there), shape ``(n_freqs, n_mels)``: FFT-bin frequencies span
    ``[0, sample_rate // 2]`` and the triangles are linear in Hz."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = _htk_hz(np.linspace(_htk_mel(f_min), _htk_mel(f_max), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts.reshape(1, -1) - all_freqs.reshape(-1, 1)  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down_slopes, up_slopes)).astype(dtype)


def get_window(window, win_length, fftbins=True):
    """Analysis window by name ('hann', 'hamming', 'povey', ...): periodic by
    default, symmetric with ``fftbins=False``."""
    if window == "povey":
        return povey_window(win_length)
    return _scipy_get_window(window, win_length, fftbins=fftbins)


def povey_window(win_length):
    """Kaldi's 'povey' window: symmetric hann ** 0.85 (denominator ``N-1``)."""
    n = np.arange(win_length, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    return hann**0.85

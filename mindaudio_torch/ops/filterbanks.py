"""Static DSP design math (NumPy), copied from ``mindaudio_tpu.ops.filterbanks``.

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_frontend.py``, ``tests/test_torch_ecapa.py`` and
``tests/test_torch_dsp.py`` pin these functions to the originals bit for
bit. Everything here runs once at set-up and returns ``np.ndarray``s.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import get_window as _scipy_get_window

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "mel", "kaldi_mel_banks",
           "melscale_fbanks", "create_dct", "get_window", "povey_window"]


def hz_to_mel(frequencies, htk=False):
    """Hz to mel: the Slaney formula (linear below 1 kHz, logarithmic above)
    by default, HTK's ``2595 log10(1 + f/700)`` with ``htk=True``."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if frequencies.ndim:
        log_t = frequencies >= min_log_hz
        mels = np.where(
            log_t,
            min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
            mels,
        )
    elif frequencies >= min_log_hz:
        mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk=False):
    """Mel to Hz, the inverse of :func:`hz_to_mel`."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_frequencies(n_mels=128, fmin=0.0, fmax=11025.0, htk=False):
    """``n_mels`` frequencies evenly spaced on the mel axis."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk=htk)


def mel(sr, n_fft, n_mels=128, fmin=0.0, fmax=None, htk=False, norm="slaney", dtype=np.float32):
    """librosa-convention mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``.

    Triangular filters between successive mel-spaced frequencies; ``norm="slaney"``
    area-normalizes each triangle. Parity: reference filters.py:426.
    """
    if fmax is None:
        fmax = float(sr) / 2
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0, float(sr) / 2, n_freqs)
    mel_f = mel_frequencies(n_mels + 2, fmin=fmin, fmax=fmax, htk=htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fftfreqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm.reshape(-1, 1)
    elif norm is not None and norm != "none":
        raise ValueError(f"Unsupported norm={norm!r}")
    return weights.astype(dtype)


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
    bin_mels = hz_to_mel(sample_rate / n_fft * np.arange(n_freqs), htk=True)

    edge = np.linspace(hz_to_mel(low_freq, htk=True), hz_to_mel(high_freq, htk=True),
                       num_bins + 2)
    left, center, right = edge[:-2, None], edge[1:-1, None], edge[2:, None]
    rising = (bin_mels[None, :] - left) / (center - left)
    falling = (right - bin_mels[None, :]) / (right - center)
    weights = np.maximum(0.0, np.minimum(rising, falling))  # (num_bins, n_freqs)
    weights = np.pad(weights, ((0, 0), (0, 1)))  # zero nyquist column
    return weights.T.astype(dtype)


def melscale_fbanks(n_freqs, f_min, f_max, n_mels, sample_rate, norm=None, mel_scale="htk",
                    dtype=np.float32):
    """torchaudio-convention mel filterbank, shape ``(n_freqs, n_mels)``:
    FFT-bin frequencies span ``[0, sample_rate // 2]`` and the triangles are
    linear in Hz, their edges evenly spaced on HTK (default) or Slaney mels;
    ``norm="slaney"`` scales each triangle to unit area."""
    htk = mel_scale == "htk"
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min, htk=htk), hz_to_mel(f_max, htk=htk), n_mels + 2)
    f_pts = mel_to_hz(m_pts, htk=htk)
    f_diff = np.diff(f_pts)
    slopes = f_pts.reshape(1, -1) - all_freqs.reshape(-1, 1)  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])).reshape(1, -1)
    elif norm is not None and norm != "none":
        raise ValueError(f"Unsupported norm={norm!r}")
    return fb.astype(dtype)


def create_dct(n_mfcc, n_mels, norm=None, dtype=np.float32):
    """DCT-II matrix of shape ``(n_mels, n_mfcc)`` (torchaudio ``create_dct``).

    ``norm="ortho"`` applies the orthonormal scaling. Used by features.mfcc
    (parity: reference features.py:337).
    """
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64).reshape(-1, 1)
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None or norm == "none":
        dct *= 2.0
    else:
        if norm != "ortho":
            raise ValueError(f"Unsupported DCT norm={norm!r}")
        dct[0] *= 1.0 / np.sqrt(2.0)
        dct *= np.sqrt(2.0 / n_mels)
    return dct.T.astype(dtype)


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

"""Host-side filtering (the port's copy of ``mindaudio_tpu.data.filters``:
``notch_filter``, pinned to it by ``tests/test_torch_ecapa_recipe.py``, from
which ``augment.drop_freq`` composes its band-stop kernels; the biquads,
SoX-style effects and ``filtfilt``, pinned by
``tests/test_torch_data_copies.py``). The mel helpers are re-exported from
``ops.filterbanks``, as in the JAX package."""

from __future__ import annotations

import numpy as np
import scipy.signal

from ..ops.filterbanks import hz_to_mel, mel, mel_frequencies, mel_to_hz  # noqa: F401  (re-export)

__all__ = [
    "notch_filter",
    "low_pass_filter",
    "peaking_equalizer",
    "contrast",
    "riaa_biquad",
    "treble_biquad",
    "dcshift",
    "filtfilt",
    "mel",
    "hz_to_mel",
    "mel_to_hz",
    "mel_frequencies",
    "cal_filter_by_coffs",
]


def notch_filter(notch_freq, filter_width=101, notch_width=0.05):
    """Windowed-sinc band-stop kernel, shaped ``(1, filter_width, 1)`` for
    ``augment.convolve1d``: a low-pass below the notch plus a spectrally
    inverted low-pass above it (Blackman windows). ``notch_freq`` is a
    fraction of the Nyquist frequency in ``(0, 1]``."""
    assert filter_width % 2 != 0
    assert 0 < notch_freq <= 1

    pad = filter_width // 2
    notch_freq = notch_freq + notch_width
    inputs = np.arange(filter_width) - pad

    def sinc(x):
        safe = np.where(x == 0, 1.0, x)
        return np.where(x == 0, 1.0, np.sin(safe) / safe)

    hlpf = sinc(3 * (notch_freq - notch_width) * inputs)
    hlpf *= np.blackman(filter_width + 1)[:-1]
    hlpf /= np.sum(hlpf)

    hhpf = sinc(3 * (notch_freq + notch_width) * inputs)
    hhpf *= np.blackman(filter_width + 1)[:-1]
    hhpf /= -np.sum(hhpf)
    hhpf[pad] += 1

    return (hlpf + hhpf).reshape(1, -1, 1)


def cal_filter_by_coffs(waveform, b, a):
    """Run a biquad over the time axis (axis 0 for 1-D, per-column for 2-D).

    Vectorized over channels via ``scipy.signal.lfilter``; outputs are clamped
    at 1.0 like the reference loop (filters.py:94). Coefficients follow the
    reference convention: ``b`` already normalized by ``a0``, ``a = [a0, a1/a0,
    a2/a0]`` with only ``a[1:]`` entering the recursion.
    """
    waveform = np.asarray(waveform, dtype=np.float64)
    a_norm = np.array([1.0, a[1], a[2]])
    out = scipy.signal.lfilter(np.asarray(b), a_norm, waveform, axis=0)
    return np.minimum(out, 1.0)


def _biquad_coeffs(b0, b1, b2, a0, a1, a2):
    return np.array([b0 / a0, b1 / a0, b2 / a0]), np.array([a0, a1 / a0, a2 / a0])


def low_pass_filter(waveform, sample_rate, cutoff_freq):
    """Single-pole-pair Butterworth-style low-pass biquad (reference filters.py:125)."""
    q = 0.707
    w0 = 2 * np.pi * cutoff_freq / sample_rate
    alpha = np.sin(w0) / (2 * q)
    cos_w0 = np.cos(w0)

    b, a = _biquad_coeffs(
        (1 - cos_w0) / 2, 1 - cos_w0, (1 - cos_w0) / 2, 1 + alpha, -2 * cos_w0, 1 - alpha
    )
    return cal_filter_by_coffs(waveform, b, a)


def peaking_equalizer(waveform, sample_rate, center_freq, gain, q=0.707):
    """Two-pole peaking EQ biquad (reference filters.py:173)."""
    aa = np.exp(gain / 40 * np.log(10.0))
    w0 = 2 * np.pi * center_freq / sample_rate
    alpha = np.sin(w0) / (2 * q)
    cos_w0 = np.cos(w0)

    b, a = _biquad_coeffs(
        1 + alpha * aa, -2 * cos_w0, 1 - alpha * aa, 1 + alpha / aa, -2 * cos_w0, 1 - alpha / aa
    )
    return cal_filter_by_coffs(waveform, b, a)


def contrast(waveform, enhancement_amount=75.0):
    """SoX contrast effect: ``sin(pi/2 * x + (amount/750) * sin(2*pi*x))``.

    Parity: reference filters.py:225 (msaudio.Contrast).
    """
    if not 0 <= enhancement_amount <= 100:
        raise ValueError("enhancement_amount must be in [0, 100]")
    x = np.asarray(waveform, dtype=np.float64)
    enhancement_zoom = enhancement_amount / 750.0
    return np.sin(x * (np.pi / 2) + enhancement_zoom * np.sin(x * 2 * np.pi)).astype(np.float32)


_RIAA_TABLE = {
    44100: ((-0.2014898, 0.9233820), (0.7083149, 0.9924091)),
    48000: ((-0.1766069, 0.9321590), (0.7396325, 0.9931330)),
    88200: ((-0.1168735, 0.9648312), (0.8590646, 0.9964002)),
    96000: ((-0.1141486, 0.9676817), (0.8699137, 0.9966946)),
}


def riaa_biquad(waveform, sample_rate=44100):
    """RIAA vinyl playback equalization biquad, gain-normalized at 1 kHz.

    Parity: reference filters.py:256 (msaudio.RiaaBiquad / SoX).
    """
    if sample_rate not in _RIAA_TABLE:
        raise ValueError("sample_rate must be one of 44100, 48000, 88200, 96000")
    zeros, poles = _RIAA_TABLE[sample_rate]

    b0, b1, b2 = 1.0, -(zeros[0] + zeros[1]), zeros[0] * zeros[1]
    a0, a1, a2 = 1.0, -(poles[0] + poles[1]), poles[0] * poles[1]

    # Normalize to 0 dB at 1 kHz.
    y = 2 * np.pi * 1000 / sample_rate
    b_re = b0 + b1 * np.cos(-y) + b2 * np.cos(-2 * y)
    a_re = a0 + a1 * np.cos(-y) + a2 * np.cos(-2 * y)
    b_im = b1 * np.sin(-y) + b2 * np.sin(-2 * y)
    a_im = a1 * np.sin(-y) + a2 * np.sin(-2 * y)
    g = 1 / np.sqrt((b_re**2 + b_im**2) / (a_re**2 + a_im**2))
    b0, b1, b2 = b0 * g, b1 * g, b2 * g

    b, a = _biquad_coeffs(b0, b1, b2, a0, a1, a2)
    return cal_filter_by_coffs(waveform, b, a)


def treble_biquad(waveform, sample_rate, gain, central_freq=3000, Q=0.707):
    """SoX treble shelving biquad (reference filters.py:282 / msaudio.TrebleBiquad)."""
    w0 = 2 * np.pi * central_freq / sample_rate
    alpha = np.sin(w0) / (2 * Q)
    A = np.exp(gain / 40 * np.log(10.0))

    t1 = 2 * np.sqrt(A) * alpha
    t2 = (A - 1) * np.cos(w0)
    t3 = (A + 1) * np.cos(w0)

    b0 = A * ((A + 1) + t2 + t1)
    b1 = -2 * A * ((A - 1) + t3)
    b2 = A * ((A + 1) + t2 - t1)
    a0 = (A + 1) - t2 + t1
    a1 = 2 * ((A - 1) - t3)
    a2 = (A + 1) - t2 - t1

    b, a = _biquad_coeffs(b0, b1, b2, a0, a1, a2)
    return cal_filter_by_coffs(waveform, b, a)


def dcshift(waveform, shift, limiter_gain=None):
    """SoX DC shift with optional peak limiter (reference filters.py:312).

    Shifts the waveform by ``shift``; with ``limiter_gain`` set, samples near
    the rail are compressed instead of clipped.
    """
    x = np.asarray(waveform, dtype=np.float64)
    if limiter_gain is not None:
        limiter_threshold = 1.0 - (abs(shift) - limiter_gain)
    if limiter_gain is not None and shift > 0:
        mask = x > limiter_threshold
        temp = (x - limiter_threshold) * limiter_gain / (1 - limiter_threshold)
        peaked = np.minimum(temp + limiter_threshold + shift, limiter_threshold)
        out = np.where(mask, peaked, np.clip(x + shift, -1.0, 1.0))
    elif limiter_gain is not None and shift < 0:
        mask = x < -limiter_threshold
        temp = (x + limiter_threshold) * limiter_gain / (1 - limiter_threshold)
        peaked = np.maximum(temp - limiter_threshold + shift, -limiter_threshold)
        out = np.where(mask, peaked, np.clip(x + shift, -1.0, 1.0))
    else:
        out = np.clip(x + shift, -1.0, 1.0)
    return out.astype(np.float32)


def filtfilt(waveform, N, Wn, btype):
    """Zero-phase Butterworth filtering (reference filters.py:342)."""
    b, a = scipy.signal.butter(N, Wn, btype)
    return scipy.signal.filtfilt(b, a, waveform)


"""Host-side NumPy signal analysis: the port's copies of ``mindaudio_tpu
.data.spectrum``'s signal levels (``compute_amplitude``, ``dB_to_amplitude``,
for the waveform augmentation; pinned by ``tests/test_torch_ecapa_recipe.py``)
and of its librosa-convention ``stft`` and torchaudio-convention
``spectrogram``, ``melscale`` and ``melspectrogram`` (the FastSpeech2
recipe's mels; pinned bit for bit by ``tests/test_torch_fastspeech2_recipe.py``).
"""

from __future__ import annotations

import numpy as np

from ..ops.filterbanks import get_window, melscale_fbanks

__all__ = ["compute_amplitude", "dB_to_amplitude", "stft", "spectrogram", "melscale",
           "melspectrogram"]


def dB_to_amplitude(wavform, ref, power):
    """``ref * (10 ** (0.1 x)) ** power`` (``ref`` may be a callable of ``x``):
    ``power=1`` gives a power, ``power=0.5`` an amplitude."""
    gain = ref(wavform) if callable(ref) else abs(ref)
    return gain * 10.0 ** (np.asarray(wavform) * (0.1 * power))


def compute_amplitude(waveforms, lengths=None, amp_type="avg", dB=False):
    """Average (over ``lengths`` when given) or peak absolute amplitude over
    axis 1 of ``(time,)``, ``(batch, time)`` or ``(batch, time, channels)``,
    kept as a ``(batch, 1[, channels])`` array; ``dB`` gives ``20 log10`` of
    it, floored at -80."""
    if amp_type not in ("avg", "peak"):
        raise TypeError(f"Unsupported amplitude type {amp_type!r}")
    absx = np.abs(np.atleast_2d(np.asarray(waveforms)))
    if amp_type == "peak":
        level = absx.max(1, keepdims=True)
    else:
        level = absx.sum(1, keepdims=True)
        level /= absx.shape[1] if lengths is None else lengths
    if not dB:
        return level
    return np.clip(20 * np.log10(level), -80.0, None)


def _hop_slices(signal, size, hop):
    """Strided ``(..., n, size)`` view of hop-spaced windows (no copy)."""
    view = np.lib.stride_tricks.sliding_window_view(signal, size, axis=-1)
    n = (signal.shape[-1] - size) // hop + 1
    return view[..., ::hop, :][..., :n, :]


def _center_pad(signal, margin, mode):
    widths = [(0, 0)] * (signal.ndim - 1) + [(margin, margin)]
    return np.pad(signal, widths, mode=mode)


def stft(
    waveforms,
    n_fft=512,
    win_length=None,
    hop_length=None,
    window="hann",
    center=True,
    pad_mode="constant",
    return_complex=True,
):
    """Short-time Fourier transform, librosa conventions.

    Args:
        waveforms: 1-D ``(time,)`` or N-D ``(..., time)`` signal.
        n_fft: FFT size; output has ``1 + n_fft // 2`` frequency rows.
        win_length: analysis window length (default ``n_fft``).
        hop_length: hop between frames (default ``win_length // 4``).
        window: window name understood by ``scipy.signal.get_window``.
        center: pad ``n_fft // 2`` on both sides so frame ``t`` is centered at
            ``t * hop_length``.
        pad_mode: numpy pad mode used when ``center``.
        return_complex: if False, stack (real, imag) on a trailing axis.

    Returns:
        ``(..., 1 + n_fft // 2, n_frames)`` complex64 array (or ``(..., 2)``
        float stack).
    """
    waveforms = np.asarray(waveforms)
    win_length = n_fft if win_length is None else win_length
    hop_length = win_length // 4 if hop_length is None else hop_length

    win = _pad_center(get_window(window, win_length, fftbins=True), n_fft)
    if center:
        waveforms = _center_pad(waveforms, n_fft // 2, pad_mode)

    # checked after the centre padding: librosa-convention centred analysis
    # pads a clip shorter than a frame up to one and must succeed
    if n_fft > waveforms.shape[-1]:
        raise ValueError(
            f"n_fft={n_fft} is too large for input signal of "
            f"length={waveforms.shape[-1]}"
        )

    segs = _hop_slices(waveforms, n_fft, hop_length)
    out = np.fft.rfft(segs * win, axis=-1).astype(np.complex64)
    out = np.swapaxes(out, -1, -2)  # (..., freq, n_frames)
    return out if return_complex else np.stack((out.real, out.imag), -1)


def _pad_center(data, size, axis=-1):
    n = data.shape[axis]
    lpad = (size - n) // 2
    if lpad < 0:
        raise ValueError(f"Target size ({size}) must be at least input size ({n})")
    lengths = [(0, 0)] * data.ndim
    lengths[axis] = (lpad, size - n - lpad)
    return np.pad(data, lengths)


def spectrogram(
    waveforms,
    n_fft=400,
    win_length=None,
    hop_length=None,
    pad=0,
    window="hann",
    power=2.0,
    normalized=False,
    center=True,
    pad_mode="reflect",
    onesided=True,
):
    """torchaudio-convention spectrogram.

    Args:
        waveforms: ``(time,)``, ``(batch, time)`` or ``(batch, channel, time)``.
        n_fft: FFT size (``n_fft // 2 + 1`` bins when onesided).
        win_length: window size (default ``n_fft``).
        hop_length: default ``win_length // 2``.
        pad: extra two-sided zero padding of the signal.
        window: window function name.
        power: magnitude exponent (1 energy, 2 power).
        normalized: divide by ``sqrt(sum(window**2))``.
        center / pad_mode: centered framing config.
        onesided: keep only non-negative frequencies.

    Returns:
        float32 array ``(..., freq, time)``.
    """
    signal = np.asarray(waveforms, dtype=np.float64)
    win_length = n_fft if win_length is None else win_length
    hop_length = win_length // 2 if hop_length is None else hop_length

    if pad > 0:
        signal = _center_pad(signal, pad, "constant")
    win = _pad_center(get_window(window, win_length, fftbins=True), n_fft)
    if center:
        signal = _center_pad(signal, n_fft // 2, pad_mode)

    segs = _hop_slices(signal, n_fft, hop_length)
    transform = np.fft.rfft if onesided else np.fft.fft
    out = np.swapaxes(transform(segs * win, axis=-1), -1, -2)  # (..., f, t)

    if normalized:
        out = out / np.sqrt(np.square(win).sum())
    if power is None:
        return out.astype(np.complex64)
    mag = np.abs(out)
    return (mag if power == 1.0 else mag**power).astype(np.float32)


def melscale(
    spec,
    n_mels=128,
    sample_rate=16000,
    f_min=0,
    f_max=None,
    n_stft=201,
    norm="none",
    mel_type="htk",
):
    """Project an STFT spectrogram onto the mel scale (torchaudio ``MelScale``).

    Args:
        spec: ``(..., n_stft, time)`` power/magnitude spectrogram.
        norm: 'none' or 'slaney'.
        mel_type: 'htk' or 'slaney'.
    """
    banks = melscale_fbanks(
        n_freqs=n_stft,
        f_min=f_min,
        f_max=sample_rate // 2 if f_max is None else f_max,
        n_mels=n_mels,
        sample_rate=sample_rate,
        norm=None if norm in (None, "none") else norm,
        mel_scale=mel_type,
    )
    projected = np.einsum("...ft,fm->...mt", np.asarray(spec), banks)
    return projected.astype(np.float32)


def melspectrogram(
    waveforms,
    n_fft=400,
    win_length=None,
    hop_length=None,
    pad=0,
    window="hann",
    power=2.0,
    normalized=False,
    center=True,
    pad_mode="reflect",
    onesided=True,
    n_mels=128,
    sample_rate=16000,
    f_min=0,
    f_max=None,
    norm="none",
    mel_type="htk",
):
    """Mel-scaled spectrogram = ``melscale(spectrogram(x))``."""
    analysis = {
        "n_fft": n_fft,
        "win_length": n_fft if win_length is None else win_length,
        "hop_length": hop_length,
        "pad": pad,
        "window": window,
        "power": power,
        "normalized": normalized,
        "center": center,
        "pad_mode": pad_mode,
        "onesided": onesided,
    }
    if analysis["hop_length"] is None:
        analysis["hop_length"] = analysis["win_length"] // 2
    projection = {
        "n_mels": n_mels,
        "sample_rate": sample_rate,
        "f_min": f_min,
        "f_max": f_max,
        "n_stft": n_fft // 2 + 1,
        "norm": norm,
        "mel_type": mel_type,
    }
    return melscale(spectrogram(waveforms, **analysis), **projection)

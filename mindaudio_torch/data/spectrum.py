"""Host-side NumPy signal analysis: the port's copy of ``mindaudio_tpu
.data.spectrum``. Its signal levels (``compute_amplitude``,
``dB_to_amplitude``, for the waveform augmentation) are pinned by
``tests/test_torch_ecapa_recipe.py``; its librosa-convention ``stft`` and
torchaudio-convention ``spectrogram``, ``melscale`` and ``melspectrogram``
(the FastSpeech2 recipe's mels) bit for bit by
``tests/test_torch_fastspeech2_recipe.py``; ``amplitude_to_dB``, ``frame``,
``overlap_add``, ``istft``, ``magphase`` and ``resynthesize`` by
``tests/test_torch_data_copies.py``.
"""

from __future__ import annotations

import numpy as np

from ..ops.filterbanks import get_window, melscale_fbanks

__all__ = [
    "amplitude_to_dB",
    "dB_to_amplitude",
    "stft",
    "istft",
    "compute_amplitude",
    "spectrogram",
    "melspectrogram",
    "magphase",
    "melscale",
    "resynthesize",
    "frame",
    "overlap_add",
]


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


def amplitude_to_dB(wavform, stype="power", ref=1.0, amin=1e-10, top_db=80.0):
    """Convert an amplitude/power spectrogram to decibels.

    ``top_db`` clamps each *batch element* (leading dims collapsed, channels
    kept together) at ``max - top_db``, matching the reference's batch-expand
    behavior (spectrum.py:79-89).

    Args:
        wavform: real spectrogram shaped ``(..., freq, time)``.
        stype: 'power' (10*log10) or 'magnitude' (20*log10).
        ref: scalar or callable reference value.
        amin: lower clamp before the log.
        top_db: dynamic-range floor in dB; ``None`` disables.
    """
    spec = np.asarray(wavform)
    if np.iscomplexobj(spec):
        raise UserWarning(
            "amplitude_to_dB was called on complex input; "
            "call amplitude_to_dB(np.abs(D)**2) instead."
        )

    scale = {"power": 10.0}.get(stype, 20.0)
    ref_val = float(ref(spec)) if callable(ref) else abs(ref)
    out = scale * np.log10(np.clip(spec, amin, None))
    out -= scale * np.log10(amin if amin > ref_val else ref_val)
    if top_db is None:
        return out

    # one dynamic-range floor per batch element: fold every axis above the
    # trailing (channel?, freq, time) group into one flat batch axis
    group = out.shape[-3:] if out.ndim > 2 else out.shape
    flat = out.reshape((-1,) + group)
    per_elem_max = flat.max(axis=tuple(range(1, flat.ndim)), keepdims=True)
    return np.maximum(flat, per_elem_max - top_db).reshape(out.shape)


def frame(x, frame_length=2048, hop_length=64):
    """Slice a signal into overlapping frames along the last axis.

    Returns shape ``(..., frame_length, n_frames)`` (frame index last, matching
    reference spectrum.py:281).
    """
    if hop_length < 1:
        raise ValueError(f"Invalid hop_length: {hop_length}")
    x = np.asarray(x)
    total = (x.shape[-1] - frame_length) // hop_length + 1
    # (..., total, frame_length) strided view, then put the frame axis last.
    view = np.lib.stride_tricks.sliding_window_view(x, frame_length, axis=-1)
    return np.swapaxes(view[..., ::hop_length, :][..., :total, :], -1, -2)


def overlap_add(output_buffer, frames, hop_length):
    """In-place overlap-add of ``frames`` ``(..., n_fft, n_frames)`` into a signal buffer."""
    _overlap_add_time_major(output_buffer, np.swapaxes(frames, -1, -2), hop_length)


def _overlap_add_time_major(output_buffer, frames, hop_length):
    """Overlap-add of time-major ``(..., n_frames, n_fft)`` frames.

    Vectorized hop-strided scatter (the host twin of the device GCD-subframe
    trick in ``processing.overlap_and_add``): each frame is split into
    ``ceil(n_fft / hop)`` hop-sized segments; for a fixed segment index the
    target slots across frames are disjoint consecutive hop-slots, so the
    whole accumulation is ``n_fft / hop`` strided adds instead of a Python
    loop over ``n_frames`` (a 10-minute file at hop 160 is ~56k iterations
    the loop form paid per call). Time-major keeps every access contiguous.
    """
    from numpy.lib.stride_tricks import as_strided

    n_frames, n_fft = frames.shape[-2:]
    n_seg = -(-n_fft // hop_length)
    width = n_seg * hop_length  # frame stride rounded up to a hop multiple

    # Frames t and t + n_seg never overlap (t*hop + n_fft <= (t+n_seg)*hop),
    # so the frames with t ≡ r (mod n_seg) write DISJOINT n_fft-sized spans
    # spaced exactly `width` apart — each residue class is one strided
    # block add into the accumulator, n_seg passes total.
    n_slots = n_frames + n_seg - 1
    acc = np.zeros(frames.shape[:-2] + (n_slots * hop_length,),
                   dtype=output_buffer.dtype)
    for r in range(n_seg):
        rows = frames[..., r::n_seg, :]  # (..., m_r, n_fft)
        m_r = rows.shape[-2]
        if m_r == 0:
            continue
        base = acc[..., r * hop_length :]
        view = as_strided(
            base,
            shape=acc.shape[:-1] + (m_r, n_fft),
            strides=base.strides[:-1] + (width * base.strides[-1], base.strides[-1]),
        )
        view += rows
    out_len = min(output_buffer.shape[-1], n_fft + hop_length * (n_frames - 1))
    output_buffer[..., :out_len] += acc[..., :out_len]


def istft(
    stft_matrix,
    n_fft=None,
    win_length=None,
    hop_length=None,
    window="hann",
    center=True,
    length=None,
):
    """Inverse STFT via window-sum-square-normalized overlap-add.

    Perfectly reconstructs a signal from an unmodified ``stft`` output (up to
    edge effects), as asserted by tests. Parity: reference spectrum.py:346.
    """
    stft_matrix = np.asarray(stft_matrix)
    n_fft = 2 * (stft_matrix.shape[-2] - 1) if n_fft is None else n_fft
    win_length = n_fft if win_length is None else win_length
    hop_length = win_length // 4 if hop_length is None else hop_length

    synth_win = _pad_center(get_window(window, win_length, fftbins=True), n_fft)

    total = stft_matrix.shape[-1]
    if length:
        span = length + n_fft if center else length
        total = min(total, -(-span // hop_length))

    buf_len = n_fft + hop_length * (total - 1)
    signal = np.zeros(stft_matrix.shape[:-2] + (buf_len,), dtype=np.float64)

    # time-major (..., total, n_fft) windowed inverse frames: the irfft,
    # the window broadcast, and the overlap-add scatter all run on the
    # contiguous last axis
    inv = np.fft.irfft(
        np.swapaxes(stft_matrix[..., :total], -1, -2), n=n_fft, axis=-1
    ) * synth_win
    _overlap_add_time_major(signal, inv, hop_length)

    envelope = _window_sumsquare(
        window=window,
        n_frames=total,
        win_length=win_length,
        n_fft=n_fft,
        hop_length=hop_length,
    )
    live = envelope > 1e-9
    signal[..., live] /= envelope[live]

    margin = n_fft // 2 if center else 0
    if length is None:
        return signal[..., margin: buf_len - margin] if center else signal
    return _fix_length(signal[..., margin:], length)


def _window_sumsquare(window, n_frames, win_length, n_fft, hop_length):
    # the same hop-strided scatter as overlap_add, on the broadcast window
    win_sq = _pad_center(get_window(window, win_length, fftbins=True) ** 2, n_fft)
    x = np.zeros(n_fft + hop_length * (n_frames - 1), dtype=np.float64)
    overlap_add(x, np.broadcast_to(win_sq[:, None], (n_fft, n_frames)), hop_length)
    return x


def _fix_length(y, size):
    if y.shape[-1] > size:
        return y[..., :size]
    if y.shape[-1] < size:
        lengths = [(0, 0)] * y.ndim
        lengths[-1] = (0, size - y.shape[-1])
        return np.pad(y, lengths)
    return y


def magphase(waveform, power, iscomplex=True):
    """Split a spectrogram into magnitude and phase.

    For complex input, phase is the unit-modulus complex array ``x / |x|``
    (zero bins -> 1+0j); for a real ``(..., 2)`` stack, phase is the angle in
    radians (the ``msaudio.Magphase`` convention). ``power`` is applied to the
    magnitude. Parity: reference spectrum.py:701.
    """
    if iscomplex:
        cspec = np.asarray(waveform)
        absS = np.abs(cspec)
        dead = absS == 0
        unit = (cspec / (absS + dead)).astype(np.complex64)
        unit += dead  # zero bins -> exactly 1+0j
        return absS**power, unit
    ri = np.asarray(waveform)
    absS = np.hypot(ri[..., 0], ri[..., 1]) ** power
    return (absS.astype(np.float32),
            np.arctan2(ri[..., 1], ri[..., 0]).astype(np.float32))


def resynthesize(enhanced_mag, noisy_inputs, normalize_wavs=True):
    """Rebuild waveforms from an enhanced magnitude plus the noisy phase.

    Parity: reference spectrum.py:777.
    """
    ri = stft(noisy_inputs, return_complex=False)
    angle = np.arctan2(ri[..., 1], ri[..., 0])
    recon = istft(enhanced_mag * np.exp(1j * angle))

    if not normalize_wavs:
        return recon
    from .processing import normalize

    return normalize(recon, norm="max")


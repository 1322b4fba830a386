"""Host-side feature extraction: the port's copy of
``mindaudio_tpu.data.features``. ``yin``, the FastSpeech2 recipe's pitch, is
pinned to the original by ``tests/test_torch_fastspeech2_recipe.py``; the
rest by ``tests/test_torch_data_copies.py``.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import median_filter

from ..ops.filterbanks import create_dct
from .spectrum import amplitude_to_dB, istft, magphase, melspectrogram, spectrogram, stft

__all__ = [
    "spectral_centroid",
    "context_window",
    "compute_deltas",
    "fbank",
    "mfcc",
    "complex_norm",
    "angle",
    "soft_mask",
    "hpss",
    "harmonic",
    "yin",
]


def yin(
    x,
    fmin=70.0,
    fmax=400.0,
    sample_rate=16000,
    frame_length=1024,
    hop_length=None,
    threshold=0.1,
    center=True,
    voicing_threshold=0.35,
):
    """YIN fundamental-frequency estimation (de Cheveigné & Kawahara 2002).

    Vectorized NumPy: per-frame difference function via FFT
    autocorrelation, cumulative-mean-normalized difference (CMNDF),
    absolute-threshold trough selection with parabolic interpolation.

    Args:
        x: ``(T,)`` waveform.
        threshold: CMNDF absolute threshold for trough selection (YIN step 4).
        voicing_threshold: frames with no sub-``threshold`` trough AND whose
            best CMNDF value exceeds this are reported unvoiced (f0 = 0).

    Returns:
        ``(n_frames,)`` f0 in Hz, 0 where unvoiced;
        ``n_frames = 1 + T // hop`` when ``center`` (matching the centered
        mel frame count) else ``1 + (T - frame_length) // hop``.
    """
    x = np.asarray(x, np.float64)
    hop = hop_length or frame_length // 4
    tau_min = max(int(sample_rate / fmax), 1)
    tau_max = min(int(np.ceil(sample_rate / fmin)), frame_length // 2)
    if tau_min >= tau_max:
        raise ValueError(f"fmin/fmax window empty: tau in [{tau_min},{tau_max})")
    win = frame_length - tau_max  # summation window W

    if center:
        n_frames = 1 + len(x) // hop  # matches the centered-STFT frame count
        pad_l = frame_length // 2
        pad_r = max(0, (n_frames - 1) * hop + frame_length - len(x) - pad_l)
        x = np.pad(x, (pad_l, pad_r))
    else:
        n_frames = 1 + (len(x) - frame_length) // hop
    frames = np.lib.stride_tricks.sliding_window_view(
        x, frame_length)[::hop][:n_frames]

    # difference function d(tau) = e0 + e(tau) - 2*acf_w(tau) per frame,
    # with acf_w the cross-correlation of the fixed [0, win) window against
    # the full frame (one FFT of each)
    nfft = 1 << int(np.ceil(np.log2(2 * frame_length)))
    f = np.fft.rfft(frames, nfft, axis=-1)
    sq = frames**2
    csum = np.concatenate(
        [np.zeros((len(frames), 1)), np.cumsum(sq, axis=-1)], axis=-1
    )
    # energy of x[tau : tau+win] for each tau in [0, tau_max]
    taus = np.arange(tau_max + 1)
    e_tau = csum[:, taus + win] - csum[:, taus]
    e0 = e_tau[:, :1]
    fw = np.fft.rfft(frames[:, :win], nfft, axis=-1)
    acf_w = np.fft.irfft(np.conj(fw) * f, nfft, axis=-1)[:, : tau_max + 1]
    d = np.maximum(e0 + e_tau - 2 * acf_w, 0.0)

    # CMNDF: d'(0) = 1, d'(tau) = d(tau) * tau / cumsum(d)[tau]
    cum = np.cumsum(d[:, 1:], axis=-1)
    cmndf = np.ones_like(d)
    cmndf[:, 1:] = d[:, 1:] * np.arange(1, tau_max + 1) / np.maximum(cum, 1e-12)

    band = cmndf[:, tau_min:tau_max]
    # first local minimum below threshold (YIN step 4); fall back to the
    # global minimum for unvoiced-ish frames
    nxt = np.concatenate(
        [band[:, 1:], np.full((len(band), 1), np.inf)], axis=-1)
    trough = (band < threshold) & (band <= nxt)
    has_trough = trough.any(axis=-1)
    idx = np.where(has_trough, trough.argmax(axis=-1), band.argmin(axis=-1))
    tau = idx + tau_min

    # parabolic interpolation around the trough
    t0 = np.clip(tau - 1, 0, tau_max)
    t2 = np.clip(tau + 1, 0, tau_max)
    ar = np.arange(len(frames))
    y0, y1, y2 = cmndf[ar, t0], cmndf[ar, tau], cmndf[ar, t2]
    denom = y0 - 2 * y1 + y2
    delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / np.where(
        np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    period = tau + delta

    f0 = sample_rate / np.maximum(period, 1e-6)
    voiced = has_trough | (band[ar, idx] < voicing_threshold)
    return np.where(voiced, f0, 0.0).astype(np.float32)


def spectral_centroid(
    waveforms,
    sample_rate,
    n_fft=400,
    win_length=None,
    hop_length=None,
    pad=0,
    window="hann",
):
    """Frequency center of mass per frame: ``sum(f * |S|) / sum(|S|)``.

    Returns ``(..., time)``. Parity: reference features.py:22 (msaudio
    SpectralCentroid semantics: magnitude spectrogram, hop = win // 2).
    """
    win_length = win_length if win_length else n_fft
    hop_length = hop_length if hop_length else win_length // 2
    spec = spectrogram(
        waveforms,
        n_fft=n_fft,
        win_length=win_length,
        hop_length=hop_length,
        pad=pad,
        window=window,
        power=1.0,
    )
    freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    shape = [1] * spec.ndim
    shape[-2] = len(freqs)
    freqs = freqs.reshape(shape)
    return (freqs * spec).sum(axis=-2) / spec.sum(axis=-2)


def context_window(waveforms, left_frames=0, right_frames=0):
    """Gather past/future frames into each feature vector.

    For input ``(..., freq, time)`` produces ``(..., freq * ctx, time)`` where
    ``ctx = left_frames + right_frames + 1`` and
    ``out[..., f * ctx + j, t] = x[..., f, t - left_frames + j]`` with zero
    padding out of range — the same result as the reference's grouped-Conv1d
    identity-kernel trick (features.py:69-155) without a device round trip.
    """
    x = np.asarray(waveforms)
    if x.ndim not in (2, 3, 4):
        raise TypeError(f"Input dimension must be 2, 3 or 4, but got {x.ndim}")

    ctx = left_frames + right_frames + 1
    n_time = x.shape[-1]
    pad = [(0, 0)] * x.ndim
    pad[-1] = (left_frames, right_frames)
    xp = np.pad(x, pad)

    # (..., freq, ctx, time): window j at offset t reads xp[..., t + j].
    cols = np.stack([xp[..., j : j + n_time] for j in range(ctx)], axis=-2)
    out_shape = x.shape[:-2] + (x.shape[-2] * ctx, n_time)
    return cols.reshape(out_shape).astype(x.dtype, copy=False)


def compute_deltas(specgram, win_length=5, pad_mode="edge"):
    """Delta (derivative) coefficients along the time axis.

    ``d_t = sum_{i=-n..n} i * x_{t+i} / (2 * sum i^2)`` with ``n = (win-1)//2``,
    edge padding by default — the torchaudio/msaudio ComputeDeltas formula
    (parity: reference features.py:158).
    """
    x = np.asarray(specgram, dtype=np.float64)
    n = (win_length - 1) // 2
    denom = n * (n + 1) * (2 * n + 1) / 3.0

    pad = [(0, 0)] * x.ndim
    pad[-1] = (n, n)
    xp = np.pad(x, pad, mode=pad_mode)

    out = np.zeros_like(x)
    for i in range(-n, n + 1):
        if i == 0:
            continue
        out += i * xp[..., n + i : n + i + x.shape[-1]]
    return (out / denom).astype(np.float32)


def fbank(
    waveforms,
    deltas=False,
    context=False,
    n_mels=40,
    n_fft=400,
    sample_rate=16000,
    f_min=0.0,
    f_max=None,
    left_frames=5,
    right_frames=5,
    win_length=None,
    hop_length=None,
    window="hann",
):
    """Log-mel filterbank features: mel power spectrogram -> dB (+deltas, +context).

    Returns ``(..., freq, time)``. Parity: reference features.py:196. The fused
    on-device path is ``mindaudio_tpu.ops.fbank``.
    """
    melspec = melspectrogram(
        waveforms,
        n_fft=n_fft,
        win_length=win_length,
        hop_length=hop_length,
        window=window,
        n_mels=n_mels,
        sample_rate=sample_rate,
        f_min=f_min,
        f_max=f_max,
    )
    fbanks = amplitude_to_dB(melspec, stype="power", ref=1.0, top_db=80.0)
    if deltas:
        d1 = compute_deltas(fbanks)
        d2 = compute_deltas(d1)
        fbanks = np.concatenate((fbanks, d1, d2), axis=-2)
    if context:
        fbanks = context_window(fbanks, left_frames, right_frames)
    return fbanks


def mfcc(
    waveforms,
    deltas=True,
    context=True,
    n_mels=23,
    n_mfcc=20,
    n_fft=400,
    sample_rate=16000,
    f_min=0.0,
    f_max=None,
    left_frames=5,
    right_frames=5,
    win_length=None,
    hop_length=None,
    norm="ortho",
    log_mels=False,
):
    """Mel-frequency cepstral coefficients (+deltas, +context).

    Parity: reference features.py:273 (DCT over dB mel spectrogram).
    """
    if n_mfcc > n_mels:
        raise ValueError("The number of MFCC coefficients must be no more than # mel bins.")
    dct = create_dct(n_mfcc=n_mfcc, n_mels=n_mels, norm=norm)

    melspec = melspectrogram(
        waveforms,
        sample_rate=sample_rate,
        n_fft=n_fft,
        n_mels=n_mels,
        f_min=f_min,
        f_max=f_max,
        win_length=win_length,
        hop_length=hop_length,
    )
    if log_mels:
        melspec = np.log(melspec + 1e-6)
    else:
        melspec = amplitude_to_dB(melspec, stype="power", ref=1.0, top_db=80.0)

    # (..., n_mels, time) -> (..., n_mfcc, time)
    mfccs = np.swapaxes(np.swapaxes(melspec, -1, -2) @ dct, -1, -2)

    if deltas:
        d1 = compute_deltas(mfccs)
        d2 = compute_deltas(d1)
        mfccs = np.concatenate((mfccs, d1, d2), axis=-2)
    if context:
        mfccs = context_window(mfccs, left_frames, right_frames)
    return mfccs


def complex_norm(waveforms, power=1.0):
    """Norm of a real/imag-stacked complex array ``(..., 2)``.

    Parity: reference features.py:376 (msaudio.ComplexNorm).
    """
    x = np.asarray(waveforms)
    return (np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2) ** power).astype(np.float32)


def angle(x):
    """Angle of a real/imag-stacked complex array ``(..., 2)``.

    Parity: reference features.py:413 (msaudio.Angle).
    """
    x = np.asarray(x)
    return np.arctan2(x[..., 1], x[..., 0]).astype(np.float32)


def soft_mask(x_input, x_ref, *, power=1, split_zeros=False):
    """Ratio mask ``(x/z)^p / ((x/z)^p + (ref/z)^p)`` with zero handling.

    Parity: reference features.py:438.
    """
    if np.any(x_input < 0) or np.any(x_ref < 0):
        raise TypeError("x_input and x_ref must be non-negative")
    if x_input.shape != x_ref.shape:
        raise TypeError("x_input and x_ref shape mismatch.")
    if power <= 0:
        raise TypeError("power must be strictly positive.")

    dtype = x_input.dtype
    if not np.issubdtype(dtype, np.floating):
        dtype = np.float32

    z = np.maximum(x_input, x_ref).astype(dtype)
    bad = z < np.finfo(dtype).tiny
    z[bad] = 1

    if not np.isfinite(power):
        return x_input > x_ref

    mask = (x_input / z) ** power
    ref_mask = (x_ref / z) ** power
    good = ~bad
    mask[good] /= mask[good] + ref_mask[good]
    mask[bad] = 0.5 if split_zeros else 0.0
    return mask


def hpss(spectrogram_in, *, kernel_size=31, power=2.0, mask=False, margin=1.0):
    """Harmonic/percussive source separation via median filtering.

    Median-filter the magnitude along time (harmonic) and frequency
    (percussive), build soft masks, and return the two components (or the masks
    themselves). Parity: reference features.py:472.
    """
    spec = np.asarray(spectrogram_in)
    if np.iscomplexobj(spec):
        spec, phase = magphase(spec, power=1)
    else:
        phase = 1

    margin_h, margin_p = (margin, margin) if np.isscalar(margin) else (margin[0], margin[1])
    win_h, win_p = (
        (kernel_size, kernel_size) if np.isscalar(kernel_size) else (kernel_size[0], kernel_size[1])
    )
    if margin_h < 1 or margin_p < 1:
        raise TypeError("Margins must be >= 1.0. A typical range is between 1 and 10.")

    harm_shape = [1] * spec.ndim
    harm_shape[-1] = win_h  # filter along time
    perc_shape = [1] * spec.ndim
    perc_shape[-2] = win_p  # filter along frequency

    harm = median_filter(spec, size=harm_shape, mode="reflect")
    perc = median_filter(spec, size=perc_shape, mode="reflect")

    split_zeros = margin_h == 1 and margin_p == 1
    mask_harm = soft_mask(harm, perc * margin_h, power=power, split_zeros=split_zeros)
    mask_perc = soft_mask(perc, harm * margin_p, power=power, split_zeros=split_zeros)

    if mask:
        return mask_harm, mask_perc
    return (spec * mask_harm) * phase, (spec * mask_perc) * phase


def harmonic(y_input, **kwargs):
    """Extract the harmonic component of a waveform (STFT -> hpss -> ISTFT).

    Parity: reference features.py:532.
    """
    y_stft = stft(y_input, n_fft=2048, pad_mode="constant")
    stft_harm = hpss(y_stft, **kwargs)[0]
    return istft(stft_harm, length=y_input.shape[-1])


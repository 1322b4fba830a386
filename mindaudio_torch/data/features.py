"""Host-side feature extraction: the port's copy of ``yin`` from
``mindaudio_tpu.data.features`` (pinned to it by
``tests/test_torch_fastspeech2_recipe.py``), the FastSpeech2 recipe's pitch.
"""

from __future__ import annotations

import numpy as np

__all__ = ["yin"]


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

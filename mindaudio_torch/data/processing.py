"""Host-side waveform processing (the port's copy of
``mindaudio_tpu.data.processing``). ``resample``, ``unitarize`` and
``rescale`` are pinned to the originals by ``tests/test_torch_recipe_infra.py``
and ``tests/test_torch_ecapa_recipe.py`` (the recipes' collates call
``resample`` for speed perturbation and for sources that are not at 16 kHz;
``augment.reverberate`` calls ``rescale``), the rest by
``tests/test_torch_data_copies.py``. ``resample``'s kaiser filter shape
defaults to torchaudio's, as the JAX package's does."""

from __future__ import annotations

from math import gcd

import numpy as np
import scipy.signal

from .spectrum import (
    _overlap_add_time_major,
    amplitude_to_dB,
    compute_amplitude,
    dB_to_amplitude,
    frame,
)

__all__ = [
    "normalize",
    "unitarize",
    "resample",
    "rescale",
    "stereo_to_mono",
    "trim",
    "split",
    "sliding_window_cmn",
    "invert_channels",
    "loop",
    "clip",
    "insert_in_background",
    "overlap_and_add",
]


# torchaudio's Kaiser window shape parameter, ``beta=None``'s value
_BETA = 14.769656459379492


def resample(waveform, orig_freq=16000, new_freq=16000, res_type="fft",
             lowpass_filter_width=6, rolloff=0.99, beta=None):
    """Resample along the last axis.

    ``"fft"``/``"scipy"``: FFT resampling (``scipy.signal.resample``) to
    ``ceil(n * new / orig)`` samples. ``"kaiser"``: a polyphase
    Kaiser-windowed sinc (torchaudio's ``sinc_interp_kaiser``) with
    ``lowpass_filter_width`` zero crossings a side, its cutoff at ``rolloff``
    of the lower Nyquist rate and the window's ``beta`` (``None``: torchaudio's
    default).
    """
    waveform = np.asarray(waveform)
    if orig_freq == new_freq:
        return waveform

    if res_type in ("scipy", "fft"):
        n_out = int(np.ceil(waveform.shape[-1] * (float(new_freq) / orig_freq)))
        res = scipy.signal.resample(waveform, n_out, axis=-1)
        return np.asarray(res, dtype=waveform.dtype)
    if res_type != "kaiser":
        raise ValueError(f"resample: unknown res_type {res_type!r}")

    g = gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    if beta is None:
        beta = _BETA
    base_freq = min(orig, new) * rolloff / 2.0  # cycles per input sample pair
    width = int(np.ceil(lowpass_filter_width * orig / (min(orig, new) * rolloff)))
    idx = np.arange(-width, width + orig, dtype=np.float64)

    kernels = []
    for p in range(new):
        # normalized lowpass time, clamped to the filter's support
        tt = (-p / new + idx / orig) * base_freq * 2
        tt = np.clip(tt, -lowpass_filter_width, lowpass_filter_width)
        window = (np.i0(beta * np.sqrt(np.clip(1 - (tt / lowpass_filter_width) ** 2, 0, 1)))
                  / np.i0(beta))
        tt_pi = tt * np.pi
        kernel = np.where(tt_pi == 0, 1.0, np.sin(tt_pi) / np.where(tt_pi == 0, 1.0, tt_pi))
        kernels.append(kernel * window * 2 * base_freq / orig)
    kernels = np.stack(kernels)  # (new, kernel_len)

    shape = waveform.shape
    x = waveform.reshape(-1, shape[-1]).astype(np.float64)
    n_in = x.shape[-1]
    xp = np.pad(x, [(0, 0), (width, width + orig)])
    n_blocks = int(np.ceil(n_in / orig))
    out = np.zeros((x.shape[0], n_blocks * new))
    klen = kernels.shape[-1]
    for b in range(n_blocks):
        seg = xp[:, b * orig: b * orig + klen]
        out[:, b * new: (b + 1) * new] = seg @ kernels.T[: seg.shape[-1]]
    target = int(np.ceil(new_freq * n_in / orig_freq))
    out = out[:, :target]
    return out.reshape(shape[:-1] + (out.shape[-1],)).astype(waveform.dtype)


def unitarize(waveforms, lengths=None, amp_type="avg", eps=1e-14):
    """Scale to unit average or peak amplitude (``spectrum.compute_amplitude``)."""
    assert amp_type in ("avg", "peak")
    waveforms = np.asarray(waveforms)
    squeeze_back = waveforms.ndim == 1
    if squeeze_back:
        waveforms = waveforms[None]
    level = compute_amplitude(waveforms, lengths, amp_type)
    scaled = waveforms / (level + eps)  # level is (B, 1): divide pre-squeeze
    return scaled[0] if squeeze_back else scaled


def rescale(waveforms, target_lvl, lengths=None, amp_type="avg", dB=False):
    """Scale to the level ``target_lvl`` (linear, or in dB with ``dB=True``);
    ``amp_type`` "max" is "peak"."""
    assert amp_type in ("max", "avg", "peak")
    kind = "peak" if amp_type == "max" else amp_type
    waveforms = np.asarray(waveforms)
    squeeze_back = waveforms.ndim == 1
    if squeeze_back:
        waveforms = waveforms[None]

    gain = (dB_to_amplitude(np.array(target_lvl), ref=1.0, power=0.5)
            if dB else target_lvl)
    leveled = gain * unitarize(waveforms, lengths=lengths, amp_type=kind)
    return leveled[0] if squeeze_back else leveled


# reducers for the scale-type norms (the mean/mean_std types are handled
# separately — they shift rather than scale)
_SCALE_NORMS = {
    "max": lambda a, ax: a.max(axis=ax, keepdims=True),
    "min": lambda a, ax: a.min(axis=ax, keepdims=True),
    "l0": lambda a, ax: (a > 0).sum(axis=ax, keepdims=True, dtype=a.dtype),
    "l1": lambda a, ax: a.sum(axis=ax, keepdims=True),
    "l2": lambda a, ax: np.sqrt((a * a).sum(axis=ax, keepdims=True)),
}


def normalize(waveforms, norm="max", axis=0):
    """Normalize an array along ``axis``.

    ``norm``: 'max' (l-inf), 'min', 'mean' (subtract mean of magnitudes),
    'mean_std', 'l0', 'l1', 'l2'. Scales below the dtype's tiny threshold are
    left untouched. Parity: reference processing.py:28.
    """
    waveforms = np.asarray(waveforms)
    inexact = (np.issubdtype(waveforms.dtype, np.floating)
               or np.issubdtype(waveforms.dtype, np.complexfloating))
    tiny = np.finfo(waveforms.dtype if inexact else np.float32).tiny
    absval = np.abs(waveforms).astype(float)

    if norm == "mean":
        return waveforms - absval.mean(axis=axis, keepdims=True)
    if norm == "mean_std":
        shift = absval.mean(axis=axis, keepdims=True)
        spread = absval.std(axis=axis, keepdims=True)
        return (waveforms - shift) / (spread + 1e-5)

    try:
        denom = _SCALE_NORMS[norm](absval, axis)
    except KeyError:
        raise TypeError(f"Unsupported norm type {norm!r}") from None
    return waveforms / np.where(denom < tiny, 1.0, denom)


def stereo_to_mono(waveforms):
    """Average channels (last axis) into mono (reference processing.py:235)."""
    waveforms = np.asarray(waveforms)
    return waveforms.mean(axis=-1) if waveforms.ndim > 1 else waveforms


def _frame_energy_db(waveforms, reference, frame_length, hop_length):
    mono = np.pad(stereo_to_mono(waveforms), frame_length // 2)
    blocks = frame(mono, frame_length=frame_length, hop_length=hop_length)
    power = (np.abs(blocks) ** 2).mean(axis=0)
    return amplitude_to_dB(power, ref=reference, top_db=None)


def _activity(waveforms, top_db, reference, frame_length, hop_length):
    """Per-frame boolean voice-activity mask + its transition indices."""
    energy = _frame_energy_db(waveforms, reference, frame_length, hop_length)
    active = energy > -top_db
    flips = np.flatnonzero(np.diff(active.astype(int))) + 1
    return active, flips


def trim(waveforms, top_db=60, reference=np.max, frame_length=2048, hop_length=512):
    """Trim leading/trailing silence.

    Returns ``(trimmed, index)`` with ``index`` the (start, end) sample bounds
    of the non-silent region. Parity: reference processing.py:263.
    """
    waveforms = np.asarray(waveforms)
    active, flips = _activity(waveforms, top_db, reference,
                              frame_length, hop_length)
    if not active.any():
        # entirely silent (librosa returns an empty trim; indexing flips[0]
        # on the empty transition list would IndexError)
        return waveforms[:0], np.array([0, 0])

    first = 0 if active[0] else flips[0]
    last = len(active) if active[-1] else flips[-1]
    bounds = hop_length * np.array([first, last])
    return waveforms[bounds[0]: bounds[1]], bounds


def split(waveforms, top_db=60, reference=np.max, frame_length=2048, hop_length=512):
    """Find non-silent intervals; returns ``(m, 2)`` start/end sample indices.

    Parity: reference processing.py:322.
    """
    waveforms = np.asarray(waveforms)
    active, flips = _activity(waveforms, top_db, reference,
                              frame_length, hop_length)
    pieces = [flips]
    if active[0]:
        pieces.insert(0, [0])
    if active[-1]:
        pieces.append([len(active)])
    bounds = hop_length * np.concatenate(pieces)
    return np.minimum(bounds, waveforms.shape[-1]).reshape((-1, 2))


def sliding_window_cmn(x, cmn_window=600, min_cmn_window=100, center=False, norm_vars=False):
    """Kaldi-style sliding-window cepstral mean (and variance) normalization.

    Operates over the second-to-last axis (time) of ``(..., time, freq)``
    input, replacing the reference's ``msaudio.SlidingWindowCmn`` kernel
    (processing.py:380-407).
    """
    x = np.asarray(x, dtype=np.float64)
    orig_shape = x.shape
    if x.ndim == 2:
        x = x[None]
    flat = x.reshape((-1,) + x.shape[-2:])
    num_frames = flat.shape[-2]

    # per-frame window bounds are data-independent: compute them vectorized,
    # then window sums via prefix sums — O(T·F) instead of the naive
    # per-frame O(T·W·F) rescan (same kaldi edge-clamping logic)
    t = np.arange(num_frames)
    if center:
        ws = t - cmn_window // 2
        we = ws + cmn_window
    else:
        ws = t - cmn_window
        we = t + 1
    we = np.where(ws < 0, we - ws, we)
    ws = np.maximum(ws, 0)
    if not center:
        we = np.where(we > t, np.maximum(t + 1, min_cmn_window), we)
    over = np.maximum(we - num_frames, 0)
    ws = np.maximum(ws - over, 0)
    we = np.minimum(we, num_frames)
    counts = (we - ws).astype(np.float64)[None, :, None]

    zeros = np.zeros_like(flat[:, :1, :])
    csum = np.concatenate([zeros, np.cumsum(flat, axis=1)], axis=1)
    mean = (csum[:, we, :] - csum[:, ws, :]) / counts
    out = flat - mean
    if norm_vars:
        csq = np.concatenate([zeros, np.cumsum(flat**2, axis=1)], axis=1)
        var = (csq[:, we, :] - csq[:, ws, :]) / counts - mean**2
        out /= np.sqrt(np.maximum(var, 1e-10))

    return out.reshape(orig_shape).astype(np.float32)


def invert_channels(waveform):
    """Swap the first and last channel (columns) of ``(n, n_channel)`` audio.

    Parity: reference processing.py:410 (in-place column swap).
    """
    waveform = np.asarray(waveform)
    if waveform.ndim > 1:
        ends = [0, waveform.shape[1] - 1]
        waveform[:, ends] = waveform[:, ends[::-1]]
    return waveform


def loop(waveform, times):
    """Concatenate the signal with itself ``times`` times along axis 0."""
    waveform = np.asarray(waveform)
    if times <= 1:
        return waveform
    return np.concatenate([waveform] * times, axis=0)


def clip(waveform, offset_factor, duration_factor):
    """Crop ``[offset, offset + duration]`` (as fractions of total length).

    Parity: reference processing.py:462.
    """
    waveform = np.asarray(waveform)
    stop_factor = offset_factor + duration_factor
    if not 0.0 <= stop_factor <= 1.0:
        print("Combination of offset and duration factors exceed audio length.")
        return waveform
    n = waveform.shape[0]
    return waveform[int(offset_factor * n): int(stop_factor * n), ...]


def insert_in_background(waveform, offset_factor, background_audio):
    """Wrap the signal with a slice of background audio on both sides.

    Parity: reference processing.py:494 (including the channel up/down-mixing
    of mismatched backgrounds).
    """
    waveform = np.asarray(waveform)
    if not 0.0 <= offset_factor <= 1.0:
        print("Offset factor number exceed range [0, 1].")
        return waveform

    channels = 1 if waveform.ndim == 1 else waveform.shape[1]
    if background_audio is None:
        bg = np.random.standard_normal(waveform.shape)
    else:
        bg = np.asarray(background_audio)
        bg_channels = 1 if bg.ndim == 1 else bg.shape[1]
        if bg_channels != channels:
            bg = stereo_to_mono(bg)
            if channels > 1:
                bg = np.tile(bg[:, None], (1, channels))

    head = bg[:int(offset_factor * bg.shape[0])] if channels > 1 else \
        bg[..., :int(offset_factor * bg.shape[0])]
    join = np.vstack if channels > 1 else np.hstack
    return join([head, waveform, head])


def overlap_and_add(signal, frame_step):
    """Overlap-add frames ``(..., frames, frame_length)`` into
    ``(..., (frames - 1) * frame_step + frame_length)``.

    Pure NumPy replacement for the reference's MindSpore ``index_add`` GCD
    trick (processing.py:547-593), sharing the hop-strided residue-class
    scatter with ``spectrum.overlap_add``; the jittable device version is
    ``mindaudio_tpu.ops.overlap_and_add``.
    """
    signal = np.asarray(signal)
    frames, frame_length = signal.shape[-2:]
    total = frame_step * (frames - 1) + frame_length
    buf = np.zeros(signal.shape[:-2] + (total,), dtype=np.float32)
    _overlap_add_time_major(buf, signal, frame_step)
    return buf


"""Spectral front-ends on the device (port of ``mindaudio_tpu.ops.spectral``):
the Kaldi log-mel fbank, the STFT and its inverse, the magnitude/power
spectrogram, the mel spectrogram, the dB log-mel ``fbank`` (ECAPA-TDNN's
front end) with its deltas and context window, MFCCs, global and
sliding-window CMN; and ``overlap_and_add``, the inverse of framing, on
which the separation models and ``istft`` rebuild their waveforms.

The DFT is a matmul against a cached cos/sin basis, as in the JAX package:
at n_fft = 512 two ``(frames, 512) @ (512, 257)`` products are cheaper to
reason about than an FFT and keep the whole front-end in a few large
operations. Float32 throughout, except that a float64 input is computed in
float64 (the CPU's reference for the card's results; the constant matrices
are the float32 ones, upcast).

Precision: the DFT of ×32768-scaled samples is sensitive to TF32. Every op
with matrix products here takes ``precision=`` ("highest": float32, TF32
off; "high" or "default": TF32 on the card), defaulting to the module's
level (:func:`set_precision`, "highest" as in the JAX package). The level
holds for the op's own products only: the TF32 switches are set for the
call and restored after it, so no process-wide flag changes behind it.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from .. import check_generator, resolve_device
from ..parallel.mesh import data_max
from .filterbanks import create_dct, get_window, kaldi_mel_banks, melscale_fbanks

__all__ = ["set_precision", "precision_scope", "frame_signal", "stft", "istft", "spectrogram",
           "melscale", "melspectrogram", "amplitude_to_db", "fbank", "mfcc", "compute_deltas",
           "kaldi_fbank", "overlap_and_add", "global_cmvn", "sliding_window_cmn"]

_PRECISION_LEVELS = ("default", "high", "highest")
_PRECISION = "highest"


def set_precision(level):
    """Set the module's default precision of the DFT and mel products:
    "default" | "high" | "highest". Takes effect on the next call of any op
    here; each op also takes ``precision=`` for one call."""
    global _PRECISION
    _PRECISION = _resolve_precision(level)


def _resolve_precision(precision):
    if precision is None:
        return _PRECISION
    if precision not in _PRECISION_LEVELS:
        raise ValueError(f"unknown precision {precision!r}; one of {_PRECISION_LEVELS}")
    return precision


@contextlib.contextmanager
def precision_scope(precision):
    """The TF32 switches of the float32 matrix products and cuDNN's
    convolutions set for ``precision`` ("highest": off; otherwise on) inside,
    and restored to what they were after."""
    tf32 = _resolve_precision(precision) != "highest"
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _precision_aware(fn):
    """Resolve ``precision`` at call time, pass the level on (to the ops the
    function calls) and run the call in its :func:`precision_scope`."""

    @functools.wraps(fn)
    def wrapper(*args, precision=None, **kwargs):
        level = _resolve_precision(precision)
        with precision_scope(level):
            return fn(*args, precision=level, **kwargs)

    return wrapper


LOG_FLOOR = 1.1920928955078125e-07  # float32 machine epsilon, as kaldi


def _compute_dtype(t):
    """float64 for a float64 tensor, float32 for any other."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


@functools.lru_cache(maxsize=16)
def _raw_dft(n_fft):
    """Unwindowed rDFT cos/sin basis ``(n_fft, n_fft//2+1)``, float32 numpy."""
    n = np.arange(n_fft)[:, None]
    freqs = np.arange(n_fft // 2 + 1)[None, :]
    angle = -2.0 * np.pi * n * freqs / n_fft
    return np.cos(angle).astype(np.float32), np.sin(angle).astype(np.float32)


@functools.lru_cache(maxsize=64)
def dft_matrices(n_fft, win_length, window, hop_length):
    """The (window ⊙ rDFT) cos/sin matrices ``(K * hop, n_fft//2+1)``, float32
    numpy, ``K = ceil(n_fft / hop)``: the window of ``win_length`` centred in
    ``n_fft`` (periodic, ``get_window(..., fftbins=True)``), and zero rows in
    ``[n_fft, K*hop)`` so that :func:`frame_signal`'s frames need no mask."""
    n_freq = n_fft // 2 + 1
    width = math.ceil(n_fft / hop_length) * hop_length
    win = np.zeros(n_fft)
    lpad = (n_fft - win_length) // 2
    win[lpad: lpad + win_length] = get_window(window, win_length, fftbins=True)
    angle = -2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_freq)[None, :] / n_fft
    wr, wi = np.zeros((width, n_freq)), np.zeros((width, n_freq))
    wr[:n_fft] = np.cos(angle) * win[:, None]
    wi[:n_fft] = np.sin(angle) * win[:, None]
    return wr.astype(np.float32), wi.astype(np.float32)


def _num_frames(n_samples, n_fft, hop_length, center):
    if center:
        return 1 + n_samples // hop_length
    return 1 + (n_samples - n_fft) // hop_length


def _pad_signal(x, n_fft, center, pad_mode):
    """Centre padding by ``n_fft // 2`` on both sides (``pad_mode``
    "constant" is zeros, "reflect" mirrors without the edge sample)."""
    if not center:
        return x
    half = n_fft // 2
    if pad_mode == "constant":
        return torch.nn.functional.pad(x, (half, half))
    shape = x.shape
    x = torch.nn.functional.pad(x.reshape(-1, 1, shape[-1]), (half, half), mode=pad_mode)
    return x.reshape(shape[:-1] + (x.shape[-1],))


def _windowed_dft(waveforms, n_fft, win_length, hop_length, window, center, pad_mode):
    """``(real, imag)`` of the framed, windowed DFT, each ``(..., n_frames, n_freq)``."""
    x = waveforms.to(_compute_dtype(waveforms))
    n_frames = _num_frames(x.shape[-1], n_fft, hop_length, center)
    frames = frame_signal(_pad_signal(x, n_fft, center, pad_mode), n_fft, hop_length, n_frames)
    wr, wi = (torch.as_tensor(m, device=x.device, dtype=x.dtype)
              for m in dft_matrices(n_fft, win_length, window, hop_length))
    return frames @ wr, frames @ wi


@_precision_aware
def stft(waveforms, n_fft=512, win_length=None, hop_length=None, window="hann", center=True,
         pad_mode="constant", device="cuda", precision=None):
    """STFT of ``(..., T)`` as ``(..., n_freq, n_frames, 2)`` (real, imag),
    librosa conventions (``mindaudio_tpu.ops.spectral.stft``). A tensor
    input is moved to ``device``."""
    win_length = win_length or n_fft
    hop_length = hop_length or win_length // 4
    x = torch.as_tensor(waveforms, device=resolve_device(device))
    real, imag = _windowed_dft(x, n_fft, win_length, hop_length, window, center, pad_mode)
    return torch.stack((real.transpose(-1, -2), imag.transpose(-1, -2)), dim=-1)


def _power_frames(waveforms, n_fft, win_length, hop_length, window, center, pad_mode, power):
    """``|STFT| ** power`` time-major, ``(..., n_frames, n_freq)``, float32,
    on the waveforms' device; the power spectrum is floored at 1e-30 before
    a fractional power, as in the JAX package."""
    real, imag = _windowed_dft(waveforms, n_fft, win_length, hop_length, window, center,
                               pad_mode)
    p = real * real + imag * imag
    if power == 2.0:
        return p
    if power == 1.0:
        return torch.sqrt(torch.clamp_min(p, 1e-30))
    return torch.pow(torch.clamp_min(p, 1e-30), power / 2.0)


@_precision_aware
def spectrogram(waveforms, n_fft=400, win_length=None, hop_length=None, pad=0, window="hann",
                power=2.0, normalized=False, center=True, pad_mode="reflect", device="cuda",
                precision=None):
    """torchaudio-convention spectrogram ``(..., n_freq, n_frames)``
    (``mindaudio_tpu.ops.spectral.spectrogram``). A tensor input is moved to
    ``device``."""
    win_length = win_length or n_fft
    hop_length = hop_length or win_length // 2
    x = torch.as_tensor(waveforms, device=resolve_device(device))
    if pad > 0:
        x = torch.nn.functional.pad(x, (pad, pad))
    p = _power_frames(x, n_fft, win_length, hop_length, window, center, pad_mode, power)
    if normalized:
        w = get_window(window, win_length, fftbins=True)
        p = p / float(np.sqrt(np.sum(w**2)) ** power)
    return p.transpose(-1, -2)


def _mel_matrix(n_freqs, n_mels, sample_rate, f_min, f_max, norm, mel_scale, like):
    f_max = f_max if f_max is not None else sample_rate // 2
    fb = melscale_fbanks(n_freqs, f_min, f_max, n_mels, sample_rate, norm=norm,
                         mel_scale=mel_scale)
    return torch.as_tensor(fb, device=like.device, dtype=like.dtype)


@_precision_aware
def melscale(spec, n_mels=128, sample_rate=16000, f_min=0.0, f_max=None, n_stft=201, norm=None,
             mel_type="htk", device="cuda", precision=None):
    """Project ``(..., n_freq, time)`` onto ``(..., n_mels, time)``
    (``mindaudio_tpu.ops.spectral.melscale``). A tensor input is moved to
    ``device``."""
    x = torch.as_tensor(spec, device=resolve_device(device))
    x = x.to(_compute_dtype(x))
    fb = _mel_matrix(n_stft, n_mels, sample_rate, f_min, f_max, norm, mel_type, x)
    return (x.transpose(-1, -2) @ fb).transpose(-1, -2)


@_precision_aware
def melspectrogram(waveforms, n_fft=400, win_length=None, hop_length=None, window="hann",
                   power=2.0, center=True, pad_mode="reflect", n_mels=128, sample_rate=16000,
                   f_min=0.0, f_max=None, norm=None, mel_type="htk", device="cuda",
                   precision=None):
    """Mel spectrogram ``(..., n_mels, n_frames)``: framing, the windowed DFT
    and the mel projection as float32 matrix products
    (``mindaudio_tpu.ops.spectral.melspectrogram``). A tensor input is moved
    to ``device``."""
    win_length = win_length or n_fft
    hop_length = hop_length or win_length // 2
    x = torch.as_tensor(waveforms, device=resolve_device(device))
    p = _power_frames(x, n_fft, win_length, hop_length, window, center, pad_mode, power)
    fb = _mel_matrix(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max, norm, mel_type, p)
    return (p @ fb).transpose(-1, -2)


def amplitude_to_db(spec, stype="power", ref=1.0, amin=1e-10, top_db=80.0):
    """``10 log10`` (power) or ``20 log10`` (amplitude) of ``spec`` clipped at
    ``amin``, floored at ``top_db`` below the maximum
    (``mindaudio_tpu.ops.spectral.amplitude_to_db``).

    The maximum is taken over the last three axes (the last two of a 2-D
    input), as in the JAX package: on a ``(B, n_mels, T)`` batch that is one
    maximum over the whole batch, so the floor of each row depends on the
    loudest row beside it (ROADMAP queue 3). Under data parallelism that
    batch is the global one: the maximum of a 3-D input is taken over the
    active mesh's ``data`` group too (``parallel.mesh.data_max``).
    """
    multiplier = 10.0 if stype == "power" else 20.0
    db = multiplier * torch.log10(torch.clamp_min(spec, amin))
    db = db - multiplier * math.log10(max(amin, ref))
    if top_db is not None:
        dims = tuple(range(max(spec.dim() - 3, 0), spec.dim()))
        peak = torch.amax(db, dim=dims, keepdim=True)
        if spec.dim() == 3:
            peak = data_max(peak)
        db = torch.maximum(db, peak - top_db)
    return db


def compute_deltas(specgram, win_length=5):
    """Delta coefficients along time with the edge frames repeated
    (``mindaudio_tpu.ops.spectral.compute_deltas``)."""
    n = (win_length - 1) // 2
    denom = n * (n + 1) * (2 * n + 1) / 3.0
    t = specgram.shape[-1]
    x = torch.cat([specgram[..., :1].expand(*specgram.shape[:-1], n), specgram,
                   specgram[..., -1:].expand(*specgram.shape[:-1], n)], dim=-1)
    out = torch.zeros_like(specgram)
    for i in range(-n, n + 1):
        if i:
            out = out + i * x[..., n + i: n + i + t]
    return out / denom


def _context_window(x, left_frames, right_frames):
    """Stack each frame with its ``left_frames`` and ``right_frames``
    neighbours (zeros past the edges): ``(..., F, T) -> (..., F * ctx, T)``,
    row ``f * ctx + j`` holding feature ``f`` at offset ``j - left_frames``."""
    t = x.shape[-1]
    xp = torch.nn.functional.pad(x, (left_frames, right_frames))
    cols = torch.stack([xp[..., j: j + t] for j in range(left_frames + right_frames + 1)],
                       dim=-2)
    return cols.reshape(x.shape[:-2] + (-1, t))


@_precision_aware
def fbank(waveforms, deltas=False, context=False, n_mels=40, n_fft=400, sample_rate=16000,
          f_min=0.0, f_max=None, left_frames=5, right_frames=5, win_length=None,
          hop_length=None, window="hann", device="cuda", precision=None):
    """dB log-mel filterbank features ``(..., n_mels, n_frames)``
    (``mindaudio_tpu.ops.spectral.fbank``): :func:`melspectrogram` (power 2,
    centred, reflect padding, HTK mels) then :func:`amplitude_to_db` with its
    80 dB floor; ``deltas`` appends the first and second deltas along the mel
    axis, ``context`` stacks ``left_frames + right_frames + 1`` frames. Plain
    float32 PyTorch: the JAX package computes this outside any Pallas
    kernel. A tensor input is moved to ``device``."""
    mel = melspectrogram(waveforms, n_fft=n_fft, win_length=win_length, hop_length=hop_length,
                         window=window, n_mels=n_mels, sample_rate=sample_rate, f_min=f_min,
                         f_max=f_max, device=device, precision=precision)
    out = amplitude_to_db(mel)
    if deltas:
        d1 = compute_deltas(out)
        out = torch.cat((out, d1, compute_deltas(d1)), dim=-2)
    if context:
        out = _context_window(out, left_frames, right_frames)
    return out


def frame_signal(x, n_fft, hop_length, n_frames):
    """``(..., T) -> (..., n_frames, K * hop)`` with ``K = ceil(n_fft / hop)``.

    Column block j of frame i holds ``x[(i + j) * hop : (i + j + 1) * hop]``;
    a signal shorter than ``(n_frames + K - 1) * hop`` is zero-padded.
    """
    k = math.ceil(n_fft / hop_length)
    need = (n_frames + k - 1) * hop_length
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    return x[..., :need].unfold(-1, k * hop_length, hop_length)


def overlap_and_add(signal, frame_step):
    """``(..., frames, frame_length) -> (..., frame_step * (frames - 1) +
    frame_length)``: each frame added in at ``frame * frame_step``.

    The frames are cut into subframes of ``gcd(frame_length, frame_step)``
    samples; subframe ``s`` of every frame lands on output subframe ``frame *
    step_sub + s``, so the sum is ``frame_length / gcd`` strided adds, one
    per ``s``. They run from the last ``s`` to the first, so each output
    sample sums its frames in increasing order, as the JAX package's
    ``segment_sum`` does. No atomics: the result is deterministic.
    """
    frames, frame_length = signal.shape[-2:]
    sub = math.gcd(frame_length, frame_step)
    step_sub, frame_sub = frame_step // sub, frame_length // sub
    output_size = frame_step * (frames - 1) + frame_length
    lead = signal.shape[:-2]
    subframes = signal.reshape(lead + (frames, frame_sub, sub))
    out = signal.new_zeros(lead + (output_size // sub, sub))
    for s in reversed(range(frame_sub)):
        out[..., s:s + (frames - 1) * step_sub + 1:step_sub, :] += subframes[..., s, :]
    return out.reshape(lead + (output_size,))


@_precision_aware
def kaldi_fbank(
    waveforms,
    num_mel_bins=80,
    frame_length_ms=25.0,
    frame_shift_ms=10.0,
    sample_rate=16000,
    dither=0.0,
    preemphasis=0.97,
    remove_dc=True,
    window="povey",
    generator=None,
    device="cuda",
    precision=None,
):
    """Kaldi-convention log-mel fbank: snip-edges framing, povey window,
    pre-emphasis, natural-log mel (``mindaudio_tpu.ops.spectral.kaldi_fbank``).

    Args:
        waveforms: ``(..., T)`` tensor or array. Float input in [-1, 1] is
            scaled to the int16 range like kaldi; integer input (raw PCM) is
            already in that range and is only cast.
        dither: Gaussian dither amplitude; applied only when ``> 0`` and an
            explicit ``generator`` is given (inference passes neither). The
            generator must live on ``device``: noise drawn elsewhere would
            be copied through the host inside every step.
        device: where to compute; a tensor input is moved there.
        precision: the products' precision (see the module docstring).

    Returns:
        ``(..., n_frames, num_mel_bins)`` float32, time-major.
    """
    device = resolve_device(device)
    frame_length = int(sample_rate * frame_length_ms / 1000)
    frame_shift = int(sample_rate * frame_shift_ms / 1000)
    n_fft = 1 << (frame_length - 1).bit_length()  # next pow2, kaldi-style

    w = torch.as_tensor(waveforms, device=device)
    x = w.to(torch.float32)
    if w.is_floating_point():
        x = x * 32768.0
    n_frames = 1 + (x.shape[-1] - frame_length) // frame_shift

    frames = frame_signal(x, frame_length, frame_shift, n_frames)[..., :frame_length]
    if generator is not None and dither > 0:
        check_generator(generator, device, "kaldi_fbank dither")
        noise = torch.randn(frames.shape, generator=generator, device=frames.device)
        frames = frames + dither * noise
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        frames = frames - preemphasis * torch.cat(
            [frames[..., :1], frames[..., :-1]], dim=-1)

    win = torch.as_tensor(get_window(window, frame_length), dtype=torch.float32,
                          device=device)
    frames = torch.nn.functional.pad(frames * win, (0, n_fft - frame_length))

    wr_np, wi_np = _raw_dft(n_fft)
    real = frames @ torch.as_tensor(wr_np, device=device)
    imag = frames @ torch.as_tensor(wi_np, device=device)
    power = real * real + imag * imag

    fb = torch.as_tensor(kaldi_mel_banks(num_mel_bins, n_fft, sample_rate),
                         device=device)
    mel = power @ fb
    return torch.log(torch.clamp_min(mel, LOG_FLOOR))


@_precision_aware
def mfcc(waveforms, deltas=True, context=True, n_mels=23, n_mfcc=20, n_fft=400,
         sample_rate=16000, f_min=0.0, f_max=None, left_frames=5, right_frames=5,
         win_length=None, hop_length=None, norm="ortho", log_mels=False, device="cuda",
         precision=None):
    """MFCCs ``(..., n_mfcc [* 3] [* ctx], n_frames)``
    (``mindaudio_tpu.ops.spectral.mfcc``): :func:`melspectrogram` (hann,
    power 2), its dB (:func:`amplitude_to_db`) or ``log(mel + 1e-6)`` with
    ``log_mels``, the DCT-II product (``filterbanks.create_dct``), then the
    deltas and the context window. A tensor input is moved to ``device``."""
    mel = melspectrogram(waveforms, n_fft=n_fft, win_length=win_length, hop_length=hop_length,
                         n_mels=n_mels, sample_rate=sample_rate, f_min=f_min, f_max=f_max,
                         device=device, precision=precision)
    mel = torch.log(mel + 1e-6) if log_mels else amplitude_to_db(mel)
    dct = torch.as_tensor(create_dct(n_mfcc=n_mfcc, n_mels=n_mels, norm=norm),
                          device=mel.device, dtype=mel.dtype)
    out = (mel.transpose(-1, -2) @ dct).transpose(-1, -2)
    if deltas:
        d1 = compute_deltas(out)
        out = torch.cat((out, d1, compute_deltas(d1)), dim=-2)
    if context:
        out = _context_window(out, left_frames, right_frames)
    return out


def global_cmvn(x, mean, istd):
    """Global cepstral mean and variance normalization, ``(x - mean) * istd``
    (``mindaudio_tpu.ops.spectral.global_cmvn``)."""
    return (x - mean) * istd


def sliding_window_cmn(x, cmn_window=600, min_cmn_window=100, center=False,
                       norm_vars=False):
    """Kaldi's sliding-window CMN over the time axis of ``(..., T, F)``, in
    O(T) through prefix sums (``mindaudio_tpu.ops.spectral
    .sliding_window_cmn``, the same window edges): frame ``t`` loses the
    mean of its window (and with ``norm_vars`` is divided by the window's
    standard deviation), computed in float32 (float64 for a float64 ``x``);
    the result takes ``x``'s dtype."""
    xf = x.to(_compute_dtype(x))
    t_len = xf.shape[-2]
    t_idx = torch.arange(t_len, device=x.device)
    if center:
        ws = t_idx - cmn_window // 2
        we = ws + cmn_window
        ws_c = torch.clamp_min(ws, 0)
        we_c = torch.where(ws < 0, we - ws, we)
    else:
        ws = t_idx - cmn_window
        ws_c = torch.clamp_min(ws, 0)
        we_c = torch.clamp_min(t_idx + 1, min(min_cmn_window, t_len))
    over = torch.clamp_min(we_c - t_len, 0)
    we_c = we_c - over
    ws_c = torch.clamp_min(ws_c - over, 0)

    def window_sums(v):
        cs = torch.cumsum(v, dim=-2)
        cs = torch.cat([torch.zeros_like(cs[..., :1, :]), cs], dim=-2)
        return cs.index_select(-2, we_c) - cs.index_select(-2, ws_c)

    count = (we_c - ws_c).to(xf.dtype)[:, None]
    mean = window_sums(xf) / count
    out = xf - mean
    if norm_vars:
        var = window_sums(xf**2) / count - mean**2
        out = out / torch.sqrt(torch.clamp_min(var, 1e-10))
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _inverse_dft(n_fft, n_freq):
    """The inverse rDFT as two ``(n_freq, n_fft)`` float32 numpy matrices,
    interior bins weighted twice (the Hermitian half left out)."""
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_freq)[None, :] / n_fft
    w = np.full(n_freq, 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    cr = (np.cos(ang) * w / n_fft).astype(np.float32)
    ci = (-np.sin(ang) * w / n_fft).astype(np.float32)
    return np.ascontiguousarray(cr.T), np.ascontiguousarray(ci.T)


@_precision_aware
def istft(stft_ri, n_fft=None, win_length=None, hop_length=None, window="hann", center=True,
          length=None, device="cuda", precision=None):
    """Inverse STFT of the ``(..., n_freq, n_frames, 2)`` real/imag stack that
    :func:`stft` gives (``mindaudio_tpu.ops.spectral.istft``): the inverse
    DFT as two float32 products, the window, :func:`overlap_and_add`, the
    window-sum-square normalization, and the centre trim (both ends when
    ``length`` is None). A tensor input is moved to ``device``."""
    x = torch.as_tensor(stft_ri, device=resolve_device(device))
    x = x.to(_compute_dtype(x))
    n_freq = x.shape[-3]
    if n_fft is None:
        n_fft = 2 * (n_freq - 1)
    win_length = win_length or n_fft
    hop_length = hop_length or win_length // 4
    cr, ci = (torch.as_tensor(m, device=x.device, dtype=x.dtype)
              for m in _inverse_dft(n_fft, n_freq))
    frames = x[..., 0].transpose(-1, -2) @ cr + x[..., 1].transpose(-1, -2) @ ci

    win = np.zeros(n_fft, np.float32)
    lpad = (n_fft - win_length) // 2
    win[lpad: lpad + win_length] = get_window(window, win_length, fftbins=True)
    frames = frames * torch.as_tensor(win, device=x.device, dtype=x.dtype)
    y = overlap_and_add(frames, hop_length)
    n_frames = frames.shape[-2]
    wss = overlap_and_add(torch.as_tensor(win**2, device=x.device, dtype=x.dtype)
                          .expand(n_frames, n_fft), hop_length)
    y = y / torch.clamp_min(wss, 1e-10)

    if center:
        y = y[..., n_fft // 2:]
        if length is None:
            y = y[..., : y.shape[-1] - n_fft // 2]
    if length is not None:
        y = y[..., :length]
        if length > y.shape[-1]:
            y = torch.nn.functional.pad(y, (0, length - y.shape[-1]))
    return y

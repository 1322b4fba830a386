"""Spectral front-ends on the device (port of ``mindaudio_tpu.ops.spectral``):
the Kaldi log-mel fbank, the STFT, the magnitude/power spectrogram, the mel
spectrogram and the dB log-mel ``fbank`` (ECAPA-TDNN's front end) with its
deltas and context window; and ``overlap_and_add``, the inverse of
framing, on which the separation models rebuild their waveforms.

The DFT is a matmul against a cached cos/sin basis, as in the JAX package:
at n_fft = 512 two ``(frames, 512) @ (512, 257)`` products are cheaper to
reason about than an FFT and keep the whole front-end in a few large
operations. Float32 throughout; on the card the caller must keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default) —
the DFT of ×32768-scaled samples is sensitive to it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import check_generator, resolve_device
from .filterbanks import get_window, kaldi_mel_banks, melscale_fbanks

__all__ = ["frame_signal", "stft", "spectrogram", "melscale", "melspectrogram",
           "amplitude_to_db", "fbank", "compute_deltas", "kaldi_fbank", "overlap_and_add"]

LOG_FLOOR = 1.1920928955078125e-07  # float32 machine epsilon, as kaldi


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
    x = waveforms.to(torch.float32)
    n_frames = _num_frames(x.shape[-1], n_fft, hop_length, center)
    frames = frame_signal(_pad_signal(x, n_fft, center, pad_mode), n_fft, hop_length, n_frames)
    wr, wi = (torch.as_tensor(m, device=x.device)
              for m in dft_matrices(n_fft, win_length, window, hop_length))
    return frames @ wr, frames @ wi


def stft(waveforms, n_fft=512, win_length=None, hop_length=None, window="hann", center=True,
         pad_mode="constant", device="cuda"):
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


def spectrogram(waveforms, n_fft=400, win_length=None, hop_length=None, pad=0, window="hann",
                power=2.0, normalized=False, center=True, pad_mode="reflect", device="cuda"):
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


def _mel_matrix(n_freqs, n_mels, sample_rate, f_min, f_max, norm, mel_scale, device):
    f_max = f_max if f_max is not None else sample_rate // 2
    fb = melscale_fbanks(n_freqs, f_min, f_max, n_mels, sample_rate, norm=norm,
                         mel_scale=mel_scale)
    return torch.as_tensor(fb, device=device)


def melscale(spec, n_mels=128, sample_rate=16000, f_min=0.0, f_max=None, n_stft=201, norm=None,
             mel_type="htk", device="cuda"):
    """Project ``(..., n_freq, time)`` onto ``(..., n_mels, time)``
    (``mindaudio_tpu.ops.spectral.melscale``). A tensor input is moved to
    ``device``."""
    x = torch.as_tensor(spec, device=resolve_device(device)).to(torch.float32)
    fb = _mel_matrix(n_stft, n_mels, sample_rate, f_min, f_max, norm, mel_type, x.device)
    return (x.transpose(-1, -2) @ fb).transpose(-1, -2)


def melspectrogram(waveforms, n_fft=400, win_length=None, hop_length=None, window="hann",
                   power=2.0, center=True, pad_mode="reflect", n_mels=128, sample_rate=16000,
                   f_min=0.0, f_max=None, norm=None, mel_type="htk", device="cuda"):
    """Mel spectrogram ``(..., n_mels, n_frames)``: framing, the windowed DFT
    and the mel projection as float32 matrix products
    (``mindaudio_tpu.ops.spectral.melspectrogram``). A tensor input is moved
    to ``device``."""
    win_length = win_length or n_fft
    hop_length = hop_length or win_length // 2
    x = torch.as_tensor(waveforms, device=resolve_device(device))
    p = _power_frames(x, n_fft, win_length, hop_length, window, center, pad_mode, power)
    fb = _mel_matrix(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max, norm, mel_type,
                     x.device)
    return (p @ fb).transpose(-1, -2)


def amplitude_to_db(spec, stype="power", ref=1.0, amin=1e-10, top_db=80.0):
    """``10 log10`` (power) or ``20 log10`` (amplitude) of ``spec`` clipped at
    ``amin``, floored at ``top_db`` below the maximum
    (``mindaudio_tpu.ops.spectral.amplitude_to_db``).

    The maximum is taken over the last three axes (the last two of a 2-D
    input), as in the JAX package: on a ``(B, n_mels, T)`` batch that is one
    maximum over the whole batch, so the floor of each row depends on the
    loudest row beside it (ROADMAP queue 3).
    """
    multiplier = 10.0 if stype == "power" else 20.0
    db = multiplier * torch.log10(torch.clamp_min(spec, amin))
    db = db - multiplier * math.log10(max(amin, ref))
    if top_db is not None:
        dims = tuple(range(max(spec.dim() - 3, 0), spec.dim()))
        db = torch.maximum(db, torch.amax(db, dim=dims, keepdim=True) - top_db)
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


def fbank(waveforms, deltas=False, context=False, n_mels=40, n_fft=400, sample_rate=16000,
          f_min=0.0, f_max=None, left_frames=5, right_frames=5, win_length=None,
          hop_length=None, window="hann", device="cuda"):
    """dB log-mel filterbank features ``(..., n_mels, n_frames)``
    (``mindaudio_tpu.ops.spectral.fbank``): :func:`melspectrogram` (power 2,
    centred, reflect padding, HTK mels) then :func:`amplitude_to_db` with its
    80 dB floor; ``deltas`` appends the first and second deltas along the mel
    axis, ``context`` stacks ``left_frames + right_frames + 1`` frames. Plain
    float32 PyTorch: the JAX package computes this outside any Pallas
    kernel. A tensor input is moved to ``device``."""
    mel = melspectrogram(waveforms, n_fft=n_fft, win_length=win_length, hop_length=hop_length,
                         window=window, n_mels=n_mels, sample_rate=sample_rate, f_min=f_min,
                         f_max=f_max, device=device)
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

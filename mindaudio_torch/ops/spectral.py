"""Kaldi log-mel front-end on the device (port of ``mindaudio_tpu.ops.spectral``).

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

from .. import resolve_device
from .filterbanks import get_window, kaldi_mel_banks

__all__ = ["frame_signal", "kaldi_fbank"]

LOG_FLOOR = 1.1920928955078125e-07  # float32 machine epsilon, as kaldi


@functools.lru_cache(maxsize=16)
def _raw_dft(n_fft):
    """Unwindowed rDFT cos/sin basis ``(n_fft, n_fft//2+1)``, float32 numpy."""
    n = np.arange(n_fft)[:, None]
    freqs = np.arange(n_fft // 2 + 1)[None, :]
    angle = -2.0 * np.pi * n * freqs / n_fft
    return np.cos(angle).astype(np.float32), np.sin(angle).astype(np.float32)


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
            explicit ``generator`` is given (inference passes neither).
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
        noise = torch.randn(frames.shape, generator=generator,
                            device=generator.device).to(device)
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

"""Polyphase resampling on the device, a Kaiser-windowed sinc (port of
``mindaudio_tpu.ops.resample``).

For a rational rate L/M the L polyphase filters are the output channels of
one convolution of stride M, so the whole resample is one ``F.conv1d``
(torchaudio's formulation). The filter bank is computed on the host in
float64, exactly as the JAX package's ``_kernel``, and rounded to float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F

from .spectral import _resolve_precision, precision_scope

__all__ = ["resample"]


@functools.lru_cache(maxsize=32)
def _kernel(orig_freq, new_freq, lowpass_filter_width, rolloff, beta):
    """``(L, taps)`` float32 polyphase bank, the padding ``width``, L and M."""
    gcd = math.gcd(orig_freq, new_freq)
    up = new_freq // gcd      # L (polyphase count)
    down = orig_freq // gcd   # M (conv stride)

    base_freq = min(down, up) * rolloff  # cutoff in reduced-Hz
    width = math.ceil(lowpass_filter_width * down / base_freq)

    # t[j, k]: normalized time of tap k for output phase j
    idx = np.arange(-width, width + down)[None] / down
    t = (-np.arange(up)[:, None] / up + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / np.i0(beta)
    t *= np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * base_freq / down
    return kernel.astype(np.float32), width, up, down


def resample(waveforms, orig_freq, new_freq, lowpass_filter_width=6, rolloff=0.99,
             beta=14.769656459379492, precision=None):
    """Resample ``(..., T)`` from ``orig_freq`` to ``new_freq`` Hz on the
    tensor's device: ``ceil(T * new_freq / orig_freq)`` samples, in the
    input's dtype (computed in float32, or float64 for a float64 input).
    Kaiser-best defaults, as torchaudio. ``precision`` is ``ops.spectral``'s (the module default "highest" keeps
    cuDNN's TF32 off for the convolution, whatever the caller's switch)."""
    if orig_freq == new_freq:
        return waveforms
    bank, width, up, down = _kernel(int(orig_freq), int(new_freq), lowpass_filter_width,
                                    float(rolloff), float(beta))
    shape = waveforms.shape
    x = waveforms.reshape(-1, shape[-1])
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    target_len = int(math.ceil(shape[-1] * up / down))
    x = F.pad(x, (width, width + down))
    weight = torch.as_tensor(bank, device=x.device, dtype=x.dtype)[:, None, :]
    with precision_scope(_resolve_precision(precision)):
        # out[b, phase, frame] = sum_k x[b, frame * down + k] * bank[phase, k]
        y = F.conv1d(x[:, None, :], weight, stride=down)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)[:, :target_len]
    return y.reshape(shape[:-1] + (target_len,)).to(waveforms.dtype)

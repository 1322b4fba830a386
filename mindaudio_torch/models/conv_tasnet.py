"""Conv-TasNet speech separation (port of ``mindaudio_tpu.models.conv_tasnet``).

A learned encoder (a bias-free basis of ``L``-sample frames at hop ``L/2``,
then ReLU), a temporal conv net that estimates one mask per speaker over
the encoder's output, and a bias-free decoder whose frames are overlap-added
back into waveforms (``ops.spectral.overlap_and_add``).

The layout is channels-first, ``(B, C, K)`` with ``K`` frames, so that the
1x1 and depthwise convolutions are ``Conv1d``s; the JAX model computes
``(B, K, C)``. Module and parameter names follow the flax ones
(``encoder``, ``layer_norm``, ``bottleneck_conv1x1``, ``tcn_r<r>_x<x>``
with ``conv1x1``, ``norm`` and ``dsconv`` holding ``depthwise``, ``norm``
and ``pointwise``, ``mask_conv1x1``, ``decoder``; flax's ``PReLU_0`` is
``prelu``), so ``convert.convert_params`` carries a JAX checkpoint across.
As in the JAX model:

- both layer norms put ``eps = 1e-8`` inside the square root, and the
  global one (gLN) averages over all frames and channels of an utterance,
  the padded frames included (only the loss masks by length);
- PReLU has one slope for all channels, initialised to flax's 0.01 (not
  PyTorch's 0.25);
- a depthwise conv of dilation ``d`` pads ``(P-1)d`` frames, split
  ``(pad//2, pad - pad//2)``, or all on the left when causal;
- the waveform is cut into ``ceil((T - L) / hop) + 1`` frames, the tail
  zero-padded, so that every sample is covered, and the output is cut back
  to ``T`` samples.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..ops.spectral import overlap_and_add
from .layers import lecun_normal_

__all__ = ["ChannelwiseLayerNorm", "GlobalLayerNorm", "DepthwiseSeparableConv",
           "TemporalBlock", "ConvTasNet", "num_frames"]

NORM_EPS = 1e-8


def num_frames(t, win_len):
    """Frames of ``win_len`` at hop ``win_len // 2`` that cover ``t``
    samples: ``ceil((t - win_len) / hop) + 1``, at least 1."""
    hop = win_len // 2
    return -(-(t - win_len) // hop) + 1 if t > win_len else 1


class GlobalLayerNorm(nn.Module):
    """Normalize ``(B, C, K)`` over all channels and frames of each
    utterance (gLN)."""

    dims = (1, 2)

    def __init__(self, channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=self.dims, correction=0, keepdim=True)
        scale = self.gamma[:, None] * torch.rsqrt(var + NORM_EPS)  # (B, C, 1) or (B, C, K)
        return torch.addcmul(self.beta[:, None], x - mean, scale)


class ChannelwiseLayerNorm(GlobalLayerNorm):
    """Normalize ``(B, C, K)`` over the channels of each frame (cLN)."""

    dims = (1,)


def _norm(norm_type, channels):
    if norm_type == "gLN":
        return GlobalLayerNorm(channels)
    if norm_type == "cLN":
        return ChannelwiseLayerNorm(channels)
    raise ValueError(f"Unsupported norm type {norm_type}")


class PReLU(nn.Module):
    """PReLU with one slope for all channels, flax's: initialised to 0.01."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.01))

    def forward(self, x):
        return F.prelu(x, self.weight)


class DepthwiseSeparableConv(nn.Module):
    """Dilated depthwise conv → PReLU → norm → 1x1 conv, ``(B, H, K) -> (B,
    out_channels, K)``."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation, norm_type="gLN",
                 causal=False):
        super().__init__()
        pad = (kernel_size - 1) * dilation
        left, right = (pad, 0) if causal else (pad // 2, pad - pad // 2)
        # a symmetric pad is the conv's own, without a copy of its input
        self.pad = None if left == right else (left, right)
        self.depthwise = nn.Conv1d(in_channels, in_channels, kernel_size, dilation=dilation,
                                   groups=in_channels, bias=False,
                                   padding=left if self.pad is None else 0)
        self.prelu = PReLU()
        self.norm = _norm(norm_type, in_channels)
        self.pointwise = nn.Conv1d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        if self.pad is not None:
            x = F.pad(x, self.pad)
        return self.pointwise(self.norm(self.prelu(self.depthwise(x))))


class TemporalBlock(nn.Module):
    """1x1 conv → PReLU → norm → :class:`DepthwiseSeparableConv`, plus the
    input: ``(B, bottleneck, K)`` in and out."""

    def __init__(self, bottleneck_channels, hidden_channels, kernel_size, dilation,
                 norm_type="gLN", causal=False):
        super().__init__()
        self.conv1x1 = nn.Conv1d(bottleneck_channels, hidden_channels, 1, bias=False)
        self.prelu = PReLU()
        self.norm = _norm(norm_type, hidden_channels)
        self.dsconv = DepthwiseSeparableConv(hidden_channels, bottleneck_channels, kernel_size,
                                             dilation, norm_type, causal)

    def forward(self, x):
        return x + self.dsconv(self.norm(self.prelu(self.conv1x1(x))))


class ConvTasNet(nn.Module):
    """Conv-TasNet: ``forward(mixture (B, T)) -> (B, num_spk, T)`` separated
    sources, float32.

    The defaults are the reference's: N = 512 basis signals, L = 16
    samples a frame, bottleneck 128, hidden 512, P = 3, X = 8 blocks of
    dilations 1 ... 128, R = 3 repeats, C = 2 speakers, gLN, ReLU masks.
    """

    def __init__(self, enc_dim=512, win_len=16, bottleneck=128, hidden=512, kernel_size=3,
                 num_blocks=8, num_repeats=3, num_spk=2, norm_type="gLN", causal=False,
                 mask_nonlinear="relu", device="cuda"):
        super().__init__()
        if mask_nonlinear not in ("relu", "softmax"):
            raise ValueError(f"Unsupported mask nonlinearity {mask_nonlinear}")
        self.enc_dim, self.win_len, self.num_spk = enc_dim, win_len, num_spk
        self.num_blocks, self.num_repeats = num_blocks, num_repeats
        self.mask_nonlinear = mask_nonlinear
        # flax's Dense over a frame; applied as a conv of stride hop
        self.encoder = nn.Linear(win_len, enc_dim, bias=False)
        self.layer_norm = ChannelwiseLayerNorm(enc_dim)
        self.bottleneck_conv1x1 = nn.Conv1d(enc_dim, bottleneck, 1, bias=False)
        for r in range(num_repeats):
            for x in range(num_blocks):
                self.add_module(f"tcn_r{r}_x{x}", TemporalBlock(
                    bottleneck, hidden, kernel_size, dilation=2 ** x, norm_type=norm_type,
                    causal=causal))
        self.mask_conv1x1 = nn.Conv1d(bottleneck, num_spk * enc_dim, 1, bias=False)
        self.decoder = nn.Linear(enc_dim, win_len, bias=False)
        self.to(resolve_device(device))

    def blocks(self):
        return [getattr(self, f"tcn_r{r}_x{x}") for r in range(self.num_repeats)
                for x in range(self.num_blocks)]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Random weights from ``generator`` (on the model's device), drawn
        from flax's init distributions: lecun-normal (truncated) kernels,
        fan-in ``Cin / groups x kernel``; unit norm scales, zero shifts;
        PReLU slopes 0.01."""
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
            elif isinstance(module, (ChannelwiseLayerNorm, GlobalLayerNorm)):
                module.gamma.fill_(1.0)
                module.beta.zero_()
            elif isinstance(module, PReLU):
                module.weight.fill_(0.01)
        return self

    def forward(self, mixture):
        b, t = mixture.shape
        L, hop = self.win_len, self.win_len // 2
        k = num_frames(t, L)
        need = (k - 1) * hop + L
        x = F.pad(mixture, (0, need - t)) if t < need else mixture[:, :need]

        # encoder: the basis over each frame, (B, N, K)
        w = F.relu(F.conv1d(x[:, None, :], self.encoder.weight[:, None, :], stride=hop))

        # the TCN's masks, (B, C, N, K)
        y = self.bottleneck_conv1x1(self.layer_norm(w))
        for block in self.blocks():
            y = block(y)
        score = self.mask_conv1x1(y).view(b, self.num_spk, self.enc_dim, k)
        masks = torch.softmax(score, dim=1) if self.mask_nonlinear == "softmax" else F.relu(score)

        # decode each speaker's frames, (B, C, K, L), and overlap-add them
        est = torch.matmul(self.decoder.weight, w[:, None] * masks).transpose(-1, -2)
        out = overlap_and_add(est, hop)
        if out.shape[-1] < t:
            out = F.pad(out, (0, t - out.shape[-1]))
        return out[..., :t]

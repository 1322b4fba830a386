"""ECAPA-TDNN speaker embeddings (port of ``mindaudio_tpu.models.ecapa_tdnn``).

``TDNNBlock``, ``Res2NetBlock``, ``SEBlock``, ``SERes2NetBlock``,
``AttentiveStatisticsPooling``, ``EcapaTDNN`` and the cosine ``Classifier``,
with the flax modules' names (``block_<i>``, ``tdnn1``, ``res2net.tdnn_<i>``,
``se.fc1``, ``mfa``, ``asp``, ``asp_bn``, ``fc``, ...), so that
``convert.convert_params`` carries a JAX checkpoint across.

The features enter as ``(B, T, n_mels)``, as in JAX, and the convolutions
run channels-first ``(B, C, T)``, as ``Conv1d`` wants them; every batch norm
normalizes each channel over ``(B, T)``, as flax's does over its ``(B, T,
C)`` layout. A convolution pads as flax's ``"SAME"`` does (``d (k - 1) / 2``
on each side for an odd kernel) and runs over the whole padded batch: past
the first layer the padded frames are not zero (the batch norms' bias) and
the next dilated convolution reads them near each utterance's end, as in
JAX. Only the squeeze-excitation means and the statistics pooling mask by
``lengths``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.mask import make_non_pad_mask
from .layers import MASK_VALUE, BatchNorm, lecun_normal_

__all__ = ["TDNNBlock", "Res2NetBlock", "SEBlock", "SERes2NetBlock",
           "AttentiveStatisticsPooling", "EcapaTDNN", "Classifier"]

_EPS = 1e-12  # the pooling's floor under the square roots


@torch.no_grad()
def _reset(module, generator):
    """flax's init distributions on ``module``'s convs, dense layers and
    batch norms: lecun-normal (truncated) kernels, zero biases, unit
    batch-norm scales, running statistics 0 and 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module


class TDNNBlock(nn.Module):
    """Conv1d ("SAME" padding) → ReLU → BatchNorm, ``(B, C, T)``."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                              padding="same")
        self.bn = BatchNorm(out_channels, axis=1)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """The channels in ``scale`` chunks: chunk 0 passes through, chunk ``i``
    plus the previous chunk's output goes through ``tdnn_<i>``."""

    def __init__(self, channels, scale=8, kernel_size=3, dilation=1):
        super().__init__()
        self.scale = scale
        hidden = channels // scale
        for i in range(1, scale):
            self.add_module(f"tdnn_{i}", TDNNBlock(hidden, hidden, kernel_size, dilation))

    def forward(self, x):
        chunks = x.chunk(self.scale, dim=1)
        outs, y = [chunks[0]], None
        for i in range(1, self.scale):
            y = getattr(self, f"tdnn_{i}")(chunks[i] if y is None else chunks[i] + y)
            outs.append(y)
        return torch.cat(outs, dim=1)


def _length_mask(lengths, t, dtype):
    """``(B, 1, T)`` of ones at valid frames and zeros past ``lengths``."""
    return make_non_pad_mask(lengths, t)[:, None, :].to(dtype)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over time: the (masked) mean over ``T``,
    ``fc1`` → ReLU → ``fc2`` → sigmoid, scaling each channel."""

    def __init__(self, in_channels, se_channels, out_channels):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, se_channels)
        self.fc2 = nn.Linear(se_channels, out_channels)

    def forward(self, x, lengths=None):
        if lengths is None:
            s = x.mean(dim=2)
        else:
            mask = _length_mask(lengths, x.shape[2], x.dtype)
            s = (x * mask).sum(dim=2) / torch.clamp_min(mask.sum(dim=2), 1.0)
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s[:, :, None]


class SERes2NetBlock(nn.Module):
    """``tdnn1`` (1×1) → :class:`Res2NetBlock` → ``tdnn2`` (1×1) →
    :class:`SEBlock`, plus the input (through a 1×1 ``shortcut`` when the
    widths differ)."""

    def __init__(self, in_channels, out_channels, res2net_scale=8, se_channels=128,
                 kernel_size=3, dilation=1):
        super().__init__()
        self.shortcut = (nn.Conv1d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)
        self.tdnn1 = TDNNBlock(in_channels, out_channels, 1, 1)
        self.res2net = Res2NetBlock(out_channels, res2net_scale, kernel_size, dilation)
        self.tdnn2 = TDNNBlock(out_channels, out_channels, 1, 1)
        self.se = SEBlock(out_channels, se_channels, out_channels)

    def forward(self, x, lengths=None):
        residual = x if self.shortcut is None else self.shortcut(x)
        y = self.tdnn2(self.res2net(self.tdnn1(x)))
        return self.se(y, lengths=lengths) + residual


class AttentiveStatisticsPooling(nn.Module):
    """Attention-weighted mean and standard deviation over time, ``(B, C,
    T) -> (B, 2C, 1)`` (``[mean, std]``). With ``global_context`` each
    frame's attention input is ``[x, mean, std]`` of the (masked) frames;
    frames past ``lengths`` get ``-1e9`` logits."""

    def __init__(self, channels, attention_channels=128, global_context=True):
        super().__init__()
        self.global_context = global_context
        self.tdnn = TDNNBlock(3 * channels if global_context else channels,
                              attention_channels, 1, 1)
        self.conv = nn.Conv1d(attention_channels, channels, 1)

    def forward(self, x, lengths=None):
        b, c, t = x.shape
        if lengths is None:
            mask = x.new_ones((b, 1, t))
        else:
            mask = _length_mask(lengths, t, x.dtype)
        total = torch.clamp_min(mask.sum(dim=2, keepdim=True), 1.0)
        if self.global_context:
            mean = (x * mask).sum(dim=2, keepdim=True) / total
            var = ((x - mean).square() * mask).sum(dim=2, keepdim=True) / total
            std = torch.sqrt(torch.clamp_min(var, _EPS))
            attn_in = torch.cat([x, mean.expand(b, c, t), std.expand(b, c, t)], dim=1)
        else:
            attn_in = x
        a = self.conv(torch.tanh(self.tdnn(attn_in)))
        a = torch.softmax(torch.where(mask > 0, a, MASK_VALUE), dim=2)
        mean = (x * a).sum(dim=2)
        var = ((x - mean[:, :, None]).square() * a).sum(dim=2)
        std = torch.sqrt(torch.clamp_min(var, _EPS))
        return torch.cat([mean, std], dim=1)[:, :, None]


class EcapaTDNN(nn.Module):
    """ECAPA-TDNN: ``forward(x (B, T, input_size), lengths=None)`` →
    embeddings ``(B, 1, lin_neurons)``.

    ``block_0`` (a TDNN block), ``block_1 .. block_{n-2}`` (SE-Res2Net
    blocks), the multi-layer aggregation ``mfa`` over the outputs of blocks
    1 to n-2 (not block 0), attentive statistics pooling ``asp``, its batch
    norm ``asp_bn`` over ``(B, 1)`` and the 1×1 ``fc``. ``train()`` uses and
    updates the batch statistics, ``eval()`` the running ones.
    """

    def __init__(self, input_size=80, channels=(512, 512, 512, 512, 1536),
                 kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                 attention_channels=128, res2net_scale=8, se_channels=128, lin_neurons=192,
                 global_context=True):
        super().__init__()
        n = len(channels)
        self.n_blocks = n - 1
        self.block_0 = TDNNBlock(input_size, channels[0], kernel_sizes[0], dilations[0])
        for i in range(1, n - 1):
            self.add_module(f"block_{i}", SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale=res2net_scale,
                se_channels=se_channels, kernel_size=kernel_sizes[i], dilation=dilations[i]))
        self.mfa = TDNNBlock(sum(channels[1:-1]), channels[-1], kernel_sizes[-1], dilations[-1])
        self.asp = AttentiveStatisticsPooling(channels[-1], attention_channels, global_context)
        self.asp_bn = BatchNorm(2 * channels[-1], axis=1)
        self.fc = nn.Conv1d(2 * channels[-1], lin_neurons, 1)

    def reset_parameters(self, generator):
        """Random weights from ``generator`` (on the model's device), drawn
        from flax's init distributions (see :func:`_reset`)."""
        return _reset(self, generator)

    def forward(self, x, lengths=None):
        x = self.block_0(x.transpose(1, 2))
        feats = []
        for i in range(1, self.n_blocks):
            x = getattr(self, f"block_{i}")(x, lengths=lengths)
            feats.append(x)
        x = self.mfa(torch.cat(feats, dim=1))
        x = self.asp_bn(self.asp(x, lengths=lengths))
        return self.fc(x).transpose(1, 2)


class Classifier(nn.Module):
    """Cosine classifier for AAM-softmax: the L2-normalized embedding
    (``lin_neurons`` wide) against the L2-normalized columns of ``weight
    (lin_neurons, out_neurons)`` (the flax layout, kept), after
    ``lin_blocks`` Linear + BatchNorm blocks."""

    def __init__(self, out_neurons, lin_blocks=0, lin_neurons=192):
        super().__init__()
        self.lin_blocks = lin_blocks
        for i in range(lin_blocks):
            self.add_module(f"linear_{i}", nn.Linear(lin_neurons, lin_neurons))
            self.add_module(f"bn_{i}", BatchNorm(lin_neurons))
        self.weight = nn.Parameter(torch.zeros(lin_neurons, out_neurons))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's init from ``generator``: the linear blocks as
        :func:`_reset` draws them, ``weight`` Xavier-uniform over its ``(lin,
        out)`` shape."""
        _reset(self, generator)
        limit = math.sqrt(6.0 / sum(self.weight.shape))
        self.weight.uniform_(-limit, limit, generator=generator)
        return self

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.lin_blocks):
            x = getattr(self, f"bn_{i}")(getattr(self, f"linear_{i}")(x))
        x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
        w = self.weight / torch.clamp_min(
            torch.linalg.vector_norm(self.weight, dim=0, keepdim=True), 1e-12)
        return x @ w

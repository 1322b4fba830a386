"""Shared building blocks (port of ``mindaudio_tpu.models.layers``).

Conventions, as in the JAX package:
- ``(B, T, D)`` batch-time-feature layout everywhere;
- boolean masks, True = attend; masked scores are filled with ``-1e9`` in
  the scores' dtype;
- the compute dtype is the parameters' dtype (cast them to bf16 for bf16
  serving); softmax runs in float32 and position tables stay float32
  buffers that are cast at use;
- LayerNorm epsilon is flax's 1e-6, not PyTorch's 1e-5.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

__all__ = [
    "MASK_VALUE",
    "LN_EPS",
    "apply_mask",
    "FastDropout",
    "Swish",
    "GLU",
    "GlobalCMVN",
    "PositionwiseFeedForward",
    "MultiHeadedAttention",
    "RelPositionMultiHeadedAttention",
    "sinusoid_table",
    "PositionalEncoding",
    "RelPositionalEncoding",
    "ConvolutionModule",
    "Conv2dSubsampling4",
]

MASK_VALUE = -1.0e9
LN_EPS = 1e-6  # flax nn.LayerNorm default


def apply_mask(scores, mask):
    """Fill attention scores where ``mask`` is False (True = keep)."""
    return scores.masked_fill(~mask, MASK_VALUE)


class FastDropout(nn.Module):
    """Dropout whose keep probability is quantized to 1/256.

    Mirrors the JAX ``FastDropout``: a position is kept when a uniform byte
    is ``>= round(256 * rate)``, so ``P(keep) = (256 - round(256 r)) / 256``
    and kept values are rescaled by exactly that. The identity at eval. In
    training the bytes come from ``generator``, which must be given (the
    TPU's random bits cannot be reproduced, only their distribution).
    """

    def __init__(self, rate, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x):
        thresh = int(round(self.rate * 256.0))
        if not self.training or thresh <= 0:
            return x
        if thresh >= 256:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("FastDropout in training needs an explicit generator")
        bits = torch.randint(0, 256, x.shape, generator=self.generator,
                             device=self.generator.device, dtype=torch.uint8)
        keep = bits.to(x.device) >= thresh
        keep_prob = 1.0 - thresh / 256.0
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Swish(nn.Module):
    """x * sigmoid(x)."""

    def forward(self, x):
        return x * torch.sigmoid(x)


class GLU(nn.Module):
    """Gated linear unit along ``dim``."""

    def __init__(self, dim=-1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        a, b = x.chunk(2, dim=self.dim)
        return a * torch.sigmoid(b)


class GlobalCMVN(nn.Module):
    """``(x - mean) * istd`` with fixed float32 statistics."""

    def __init__(self, mean, istd):
        super().__init__()
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer("istd", torch.as_tensor(istd, dtype=torch.float32))

    def forward(self, x):
        return (x - self.mean.to(x.dtype)) * self.istd.to(x.dtype)


class PositionwiseFeedForward(nn.Module):
    """Two-layer FFN applied per position (flax ``Dense_0``/``Dense_1`` are
    ``w_1``/``w_2`` here)."""

    def __init__(self, d_model, hidden_units, dropout_rate=0.1, activation=F.relu):
        super().__init__()
        self.w_1 = nn.Linear(d_model, hidden_units)
        self.w_2 = nn.Linear(hidden_units, d_model)
        self.activation = activation
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x):
        return self.w_2(self.dropout(self.activation(self.w_1(x))))


def _score_scale(d_k, dtype):
    # sqrt(d_k) taken in float32, then rounded to the compute dtype (as JAX)
    return float(torch.tensor(math.sqrt(d_k), dtype=torch.float32).to(dtype))


def _split_heads(x, head_num):
    b, t, d = x.shape
    return x.view(b, t, head_num, d // head_num).transpose(1, 2)


def _attend(scores, value, mask, dropout, linear_out):
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None]
        scores = apply_mask(scores, mask)
    attn = torch.softmax(scores.float(), dim=-1).to(value.dtype)
    out = dropout(attn) @ value
    b, h, t, d_k = out.shape
    return linear_out(out.transpose(1, 2).reshape(b, t, h * d_k))


class MultiHeadedAttention(nn.Module):
    """Masked multi-head attention. ``mask`` broadcasts to ``(B, 1, Tq, Tk)``
    (a 3-D ``(B, Tq|1, Tk)`` mask gets the head axis), True = attend."""

    def __init__(self, d_model, head_num, dropout_rate=0.0):
        super().__init__()
        self.head_num = head_num
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.dropout = FastDropout(dropout_rate)

    def forward(self, query, key, value, mask=None):
        q = _split_heads(self.linear_q(query), self.head_num)
        k = _split_heads(self.linear_k(key), self.head_num)
        v = _split_heads(self.linear_v(value), self.head_num)
        scores = (q @ k.transpose(-2, -1)) / _score_scale(q.shape[-1], q.dtype)
        return _attend(scores, v, mask, self.dropout, self.linear_out)


class RelPositionMultiHeadedAttention(nn.Module):
    """Transformer-XL relative-position attention with u/v biases.

    ``score = (q+u)·k + (q+v)·p`` computed as ONE contraction over an
    augmented head dim, ``[q+u; q+v] · [k; p]``, with no bd shift (the
    WeNet/reference convention). ``p`` projects the position table and has
    batch 1. With ``kv_cache=(k, v)`` the cached keys/values are prepended
    and ``(out, (k, v))`` is returned; ``pos_emb`` must then span the
    concatenated key length.
    """

    def __init__(self, d_model, head_num, dropout_rate=0.0):
        super().__init__()
        self.head_num = head_num
        d_k = d_model // head_num
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model)
        self.pos_bias_u = nn.Parameter(torch.zeros(head_num, d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(head_num, d_k))
        self.dropout = FastDropout(dropout_rate)

    def forward(self, query, key, value, mask=None, pos_emb=None, kv_cache=None):
        q = _split_heads(self.linear_q(query), self.head_num)
        k = _split_heads(self.linear_k(key), self.head_num)
        v = _split_heads(self.linear_v(value), self.head_num)
        if kv_cache is not None:
            k = torch.cat([kv_cache[0].to(k.dtype), k], dim=2)
            v = torch.cat([kv_cache[1].to(v.dtype), v], dim=2)
        p = _split_heads(self.linear_pos(pos_emb.to(q.dtype)), self.head_num)

        q_aug = torch.cat([q + self.pos_bias_u[None, :, None, :],
                           q + self.pos_bias_v[None, :, None, :]], dim=-1)
        k_aug = torch.cat([k, p.expand_as(k)], dim=-1)
        scores = (q_aug @ k_aug.transpose(-2, -1)) / _score_scale(q.shape[-1], q.dtype)
        out = _attend(scores, v, mask, self.dropout, self.linear_out)
        if kv_cache is not None:
            return out, (k, v)
        return out


def sinusoid_table(max_len, d_model, dtype=np.float32):
    """Standard sinusoidal position table ``(max_len, d_model)``."""
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, d_model, 2) * -(np.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term)
    return table.astype(dtype)


class PositionalEncoding(nn.Module):
    """Absolute sinusoidal encoding: ``x * sqrt(d) + PE``; returns
    ``(x, pos (1, T, d))``."""

    def __init__(self, d_model, dropout_rate=0.1, max_len=5000):
        super().__init__()
        self.d_model = d_model
        self.register_buffer("pe", torch.from_numpy(sinusoid_table(max_len, d_model)),
                             persistent=False)
        self.dropout = FastDropout(dropout_rate)

    def _scaled(self, x, offset):
        x = x * torch.tensor(self.d_model, dtype=x.dtype).sqrt()
        return x, self.pe[offset: offset + x.shape[1]].to(x.dtype)[None]

    def forward(self, x, offset=0):
        x, pos = self._scaled(x, offset)
        return self.dropout(x + pos), pos


class RelPositionalEncoding(PositionalEncoding):
    """Relative encoding: scales x by sqrt(d) and returns the position table
    separately, without adding it."""

    def forward(self, x, offset=0):
        x, pos = self._scaled(x, offset)
        return self.dropout(x), pos


class ConvolutionModule(nn.Module):
    """Conformer convolution module: pointwise(2C) → GLU → depthwise(k) →
    LayerNorm → swish → pointwise(C).

    The input is length-masked before ``pointwise_conv1`` and the output
    after ``pointwise_conv2``, so padding never leaks across frames. The
    depthwise conv pads ``(k-1)//2`` on both sides, or ``k-1`` on the left
    when ``causal``.
    """

    def __init__(self, channels, kernel_size=15, causal=False):
        super().__init__()
        self.pointwise_conv1 = nn.Linear(channels, 2 * channels)
        self.glu = GLU(dim=-1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size,
                                        groups=channels)
        self.norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.pointwise_conv2 = nn.Linear(channels, channels)
        half = (kernel_size - 1) // 2
        self.pad = (kernel_size - 1, 0) if causal else (half, half)

    def forward(self, x, mask_pad=None):
        # x: (B, T, C); mask_pad: (B, T) True = valid
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad[..., None], 0.0)
        x = self.glu(self.pointwise_conv1(x))
        x = self.depthwise_conv(F.pad(x.transpose(1, 2), self.pad)).transpose(1, 2)
        x = self.norm(x)
        x = self.pointwise_conv2(x * torch.sigmoid(x))
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad[..., None], 0.0)
        return x


class Conv2dSubsampling4(nn.Module):
    """Two stride-2 3x3 Conv2d blocks (4x time subsampling) and a linear
    projection: ``(B, T, F) -> (B, T', d_model)`` plus the position table.

    The conv output ``(B, C, T', F')`` is permuted to ``(B, T', F', C)``
    before flattening, so ``out`` sees the ``F'·C`` order of the channels-
    last JAX layout.
    """

    def __init__(self, idim, d_model, dropout_rate=0.1, pos_enc="rel_pos"):
        super().__init__()
        self.conv1 = nn.Conv2d(1, d_model, 3, stride=2)
        self.conv2 = nn.Conv2d(d_model, d_model, 3, stride=2)
        f2 = ((idim - 1) // 2 - 1) // 2
        self.out = nn.Linear(d_model * f2, d_model)
        if pos_enc == "rel_pos":
            self.pos_enc = RelPositionalEncoding(d_model, dropout_rate)
        elif pos_enc == "abs_pos":
            self.pos_enc = PositionalEncoding(d_model, dropout_rate)
        else:
            raise ValueError(f"unknown pos_enc {pos_enc!r}")

    def forward(self, x, offset=0):
        x = F.relu(self.conv1(x[:, None]))
        x = F.relu(self.conv2(x))
        b, c, t2, f2 = x.shape
        x = self.out(x.permute(0, 2, 3, 1).reshape(b, t2, f2 * c))
        return self.pos_enc(x, offset=offset)

    @staticmethod
    def output_len(t):
        """Subsampled length for input length t (two valid stride-2 3x3 convs)."""
        return ((t - 1) // 2 - 1) // 2

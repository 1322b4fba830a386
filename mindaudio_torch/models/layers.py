"""Shared building blocks (port of ``mindaudio_tpu.models.layers``).

Conventions, as in the JAX package:
- ``(B, T, D)`` batch-time-feature layout everywhere;
- boolean masks, True = attend; masked scores are filled with ``-1e9`` in
  the scores' dtype;
- the compute dtype is the parameters' dtype (cast them to bf16 for bf16
  serving); softmax runs in float32 and position tables stay float32
  buffers that are cast at use;
- LayerNorm epsilon is flax's 1e-6, not PyTorch's 1e-5;
- :class:`BatchNorm` computes as flax's ``nn.BatchNorm`` does (biased
  variance, ``momentum`` weighting the old statistics), not as PyTorch's.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .. import check_generator
from ..ops.quant import int8_training_matmul
from ..parallel.collectives import (
    all_gather,
    all_reduce_sum,
    copy_to,
    group_rank,
    group_size,
    reduce_from,
    scatter,
)
from ..parallel.mesh import batch_stat_group

__all__ = [
    "MASK_VALUE",
    "LN_EPS",
    "apply_mask",
    "FastDropout",
    "Swish",
    "GLU",
    "GlobalCMVN",
    "BatchNorm",
    "running_stats",
    "lecun_normal_",
    "remat_call",
    "Int8Dense",
    "row_parallel",
    "column_head",
    "PositionwiseFeedForward",
    "MultiHeadedAttention",
    "RelPositionMultiHeadedAttention",
    "sinusoid_table",
    "PositionalEncoding",
    "RelPositionalEncoding",
    "NoPositionalEncoding",
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
    training the bytes come from ``generator``, which must be given and must
    live on the input's device (the TPU's random bits cannot be reproduced,
    only their distribution).
    """

    def __init__(self, rate, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def bits(self, shape, device):
        """The uniform bytes of one draw of ``shape``, or ``None`` when the
        dropout is inactive; :meth:`forward` takes them as ``bits``."""
        thresh = int(round(self.rate * 256.0))
        if not self.training or thresh <= 0 or thresh >= 256:
            return None
        if self.generator is None:
            raise RuntimeError("FastDropout in training needs an explicit generator")
        check_generator(self.generator, device, "FastDropout")
        return torch.randint(0, 256, tuple(shape), generator=self.generator, device=device,
                             dtype=torch.uint8)

    def forward(self, x, bits=None):
        """``bits``: bytes drawn by :meth:`bits` for ``x``'s shape (a caller
        whose ranks must draw alike draws once, whatever each rank keeps)."""
        thresh = int(round(self.rate * 256.0))
        if not self.training or thresh <= 0:
            return x
        if thresh >= 256:
            return torch.zeros_like(x)
        if bits is None:
            bits = self.bits(x.shape, x.device)
        keep = bits >= thresh
        keep_prob = 1.0 - thresh / 256.0
        return torch.where(keep, x / keep_prob, 0.0)


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


class BatchNorm(nn.Module):
    """Batch normalization of the features along ``axis`` (the last by
    default) over every other axis, as flax's ``nn.BatchNorm(momentum=...)``
    computes it on a channels-last input.

    In training the batch statistics are float32, ``mean = E[x]`` and the
    *biased* ``var = max(E[x^2] - E[x]^2, 0)`` over every position given
    (padding included: there is no mask), and the running statistics become
    ``momentum * old + (1 - momentum) * batch`` with that same variance
    (``torch.nn.BatchNorm*`` takes the unbiased one and names the momentum
    the other way round). In eval the running statistics are used. The
    output is ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32.
    ``running_mean``/``running_var`` are flax's ``batch_stats`` ``mean`` and
    ``var``; there is no ``num_batches_tracked``. ``axis=1`` normalizes a
    channels-first ``(B, C, T)`` tensor as flax does its ``(B, T, C)``
    transpose.

    Under data parallelism (an active mesh whose ``data`` axis has several
    ranks, ``parallel.mesh``) the batch mean and ``E[x^2]`` are averaged over
    the group before the variance is formed, as GSPMD takes them over the
    global batch: every rank then holds flax's statistics and running update
    (each rank's batch has the same size). The gradient flows back through
    the all-reduce.
    """

    def __init__(self, features, momentum=0.9, eps=1e-5, axis=-1):
        super().__init__()
        self.momentum, self.eps, self.axis = momentum, eps, axis
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        x = x.float()
        axis = self.axis % x.dim()
        shape = [-1 if d == axis else 1 for d in range(x.dim())]
        if self.training:
            axes = tuple(d for d in range(x.dim()) if d != axis)
            mean, mean2 = x.mean(axes), x.square().mean(axes)
            group = batch_stat_group()
            if group is not None:  # the global batch's statistics, as GSPMD's
                both = all_reduce_sum(torch.stack([mean, mean2]), group) / group_size(group)
                mean, mean2 = both[0], both[1]
            var = torch.clamp_min(mean2 - mean.square(), 0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


# flax's lecun_normal draws a normal truncated at two standard deviations,
# scaled so that the variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t, fan_in, generator):
    """Fill ``t`` from flax's ``lecun_normal()`` with ``generator``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def running_stats(module):
    """The running-statistic buffers of every :class:`BatchNorm` in
    ``module`` (a training step updates them in place)."""
    return [b for m in module.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


def _restoring_context(module):
    """``context_fn`` for :func:`torch.utils.checkpoint.checkpoint` that makes
    the recomputed forward of ``module`` the forward it stands for: the
    recomputation starts from the generator states the forward started from
    (so it draws the same dropout masks) and leaves behind the generators'
    and the batch norms' states as it found them (so the stream goes on where
    the forward left it and the running statistics move once a step).
    ``preserve_rng_state`` restores only the default generators, not the
    explicit ones the port's dropouts hold."""
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, FastDropout) and m.generator is not None}.values())
    stats = running_stats(module)
    at_forward = []

    @contextlib.contextmanager
    def forward():
        at_forward[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        kept = [t.clone() for t in stats]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)
            with torch.no_grad():
                for t, k in zip(stats, kept):
                    t.copy_(k)

    return forward(), recompute()


def remat_call(module, *args, **kwargs):
    """``module(*args, **kwargs)`` with its activations rematerialized in the
    backward (non-reentrant ``torch.utils.checkpoint``), exact as JAX's
    ``nn.remat``: the same dropout masks and one update of the running
    statistics (:func:`_restoring_context`). Outside training, or with
    gradients off, a plain call."""
    if not (module.training and torch.is_grad_enabled()):
        return module(*args, **kwargs)
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: _restoring_context(module), **kwargs)


class Int8Dense(nn.Linear):
    """``nn.Linear`` whose forward runs W8A8 on the int8 tensor cores
    (``mindaudio_tpu.models.layers.Int8Dense``).

    The parameters are ``nn.Linear``'s, by name and ``(out, in)`` layout, so
    a checkpoint moves between this layer and a float one unchanged, and
    ``convert_params`` and ``ops.quant.swap_quantized`` need no rule of their
    own. The forward quantizes both operands per call
    (``ops.quant.int8_training_matmul``); the backward is bf16 from the
    unquantized operands. Under autocast the input is first cast to the
    autocast dtype, as autocast casts a Linear's; the product and its
    epilogue run with autocast off and return the input's dtype, the bias
    added in it.
    """

    def product(self, x):
        """``x @ weight.T`` W8A8, without the bias."""
        if torch.is_autocast_enabled(x.device.type):
            x = x.to(torch.get_autocast_dtype(x.device.type))
        return int8_training_matmul(x, self.weight)

    def forward(self, x):
        y = self.product(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _product(linear, x):
    """``linear``'s product without its bias (a row-parallel layer adds the
    bias once, after the sum over the group)."""
    return linear.product(x) if isinstance(linear, Int8Dense) else F.linear(x, linear.weight)


def row_parallel(linear, x, group):
    """Megatron's row-parallel layer: this rank's input slice times its
    weight slice, summed over ``group`` (``reduce_from``), plus the bias."""
    y = reduce_from(_product(linear, x), group)
    return y + linear.bias.to(y.dtype) if linear.bias is not None else y


def column_head(linear, x):
    """A projection whose output may be split over ``linear.tp_group``
    (column-parallel, ``parallel.shardings``): the slices are gathered, so
    the caller sees the whole output (the CTC kernels take whole rows)."""
    group = getattr(linear, "tp_group", None)
    if group is None:
        return linear(x)
    return all_gather(linear(copy_to(x, group)), group, dim=-1, grad="slice")


class PositionwiseFeedForward(nn.Module):
    """Two-layer FFN applied per position (flax ``Dense_0``/``Dense_1`` are
    ``w_1``/``w_2`` here). ``int8=True`` runs both projections' forward W8A8
    (:class:`Int8Dense`)."""

    def __init__(self, d_model, hidden_units, dropout_rate=0.1, activation=F.relu,
                 int8=False):
        super().__init__()
        dense = Int8Dense if int8 else nn.Linear
        self.w_1 = dense(d_model, hidden_units)
        self.w_2 = dense(hidden_units, d_model)
        self.activation = activation
        self.dropout = FastDropout(dropout_rate)
        self.tp_group = None  # Megatron over the hidden units (parallel/shardings.py)

    def forward(self, x):
        if self.tp_group is not None:
            h = self.dropout(self.activation(self.w_1(copy_to(x, self.tp_group))))
            return row_parallel(self.w_2, h, self.tp_group)
        return self.w_2(self.dropout(self.activation(self.w_1(x))))


def _score_scale(d_k, dtype):
    # sqrt(d_k) taken in float32, then rounded to the compute dtype (as JAX)
    return float(torch.tensor(math.sqrt(d_k), dtype=torch.float32).to(dtype))


def _split_heads(x, head_num):
    b, t, d = x.shape
    return x.view(b, t, head_num, d // head_num).transpose(1, 2)


def _merge_heads(out, linear_out, group):
    b, h, t, d_k = out.shape
    out = out.transpose(1, 2).reshape(b, t, h * d_k)
    return linear_out(out) if group is None else row_parallel(linear_out, out, group)


def _attend(scores, value, mask, dropout, linear_out, group=None):
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None]
        scores = apply_mask(scores, mask)
    attn = torch.softmax(scores.float(), dim=-1).to(value.dtype)
    return _merge_heads(dropout(attn) @ value, linear_out, group)


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
        self.tp_group = None  # Megatron over the heads (parallel/shardings.py)

    def forward(self, query, key, value, mask=None):
        g, heads = self.tp_group, self.head_num // group_size(self.tp_group)
        q = _split_heads(self.linear_q(copy_to(query, g)), heads)
        k = _split_heads(self.linear_k(copy_to(key, g)), heads)
        v = _split_heads(self.linear_v(copy_to(value, g)), heads)
        scores = (q @ k.transpose(-2, -1)) / _score_scale(q.shape[-1], q.dtype)
        return _attend(scores, v, mask, self.dropout, self.linear_out, g)


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
        self.tp_group = None  # Megatron over the heads (parallel/shardings.py)
        self.sp = None  # (group, variant): sequence-parallel attention

    def forward(self, query, key, value, mask=None, pos_emb=None, kv_cache=None):
        g = self.tp_group
        heads, first = self.head_num // group_size(g), group_rank(g) * (
            self.head_num // group_size(g))
        q = _split_heads(self.linear_q(copy_to(query, g)), heads)
        k = _split_heads(self.linear_k(copy_to(key, g)), heads)
        v = _split_heads(self.linear_v(copy_to(value, g)), heads)
        if kv_cache is not None:
            k = torch.cat([kv_cache[0].to(k.dtype), k], dim=2)
            v = torch.cat([kv_cache[1].to(v.dtype), v], dim=2)
        if g is None:
            p = self.linear_pos(pos_emb.to(q.dtype))
        else:  # the JAX table keeps this bias whole: this rank's heads' slice of it
            d_k = q.shape[-1]
            p = F.linear(pos_emb.to(q.dtype), self.linear_pos.weight,
                         self.linear_pos.bias[first * d_k:(first + heads) * d_k])
        p = _split_heads(p, heads)

        u = self.pos_bias_u[first:first + heads]
        vb = self.pos_bias_v[first:first + heads]
        q_aug = torch.cat([q + u[None, :, None, :], q + vb[None, :, None, :]], dim=-1)
        k_aug = torch.cat([k, p.expand_as(k)], dim=-1)
        if self.sp is not None and kv_cache is None:
            return _merge_heads(self._sequence_parallel(q_aug, k_aug, v, mask),
                                self.linear_out, g)
        scores = (q_aug @ k_aug.transpose(-2, -1)) / _score_scale(q.shape[-1], q.dtype)
        out = _attend(scores, v, mask, self.dropout, self.linear_out, g)
        if kv_cache is not None:
            return out, (k, v)
        return out

    def _sequence_parallel(self, q_aug, k_aug, v, mask):
        """The augmented head through ring or Ulysses attention over the
        ``seq`` group (this rank's frames; padding masks only, no attention
        dropout), with the score scale ``d_k ** -0.5``."""
        from ..parallel.ring_attention import ring_attention, ulysses_attention

        if mask is not None and mask.shape[-2] != 1:
            raise ValueError("sequence-parallel attention supports padding masks only "
                             f"(got mask shape {tuple(mask.shape)}); disable dynamic/static "
                             "chunking")
        kv_valid = None if mask is None else mask.reshape(mask.shape[0], mask.shape[-1])
        group, variant = self.sp
        fn = {"ring": ring_attention, "ulysses": ulysses_attention}[variant]
        return fn(q_aug, k_aug, v, group, kv_valid=kv_valid,
                  scale=float(v.shape[-1]) ** -0.5)


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


class NoPositionalEncoding(nn.Module):
    """No position information: ``x`` as it is (after dropout), and a zero
    table ``(1, T, d)``."""

    def __init__(self, d_model, dropout_rate=0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x, offset=0):
        return self.dropout(x), x.new_zeros(1, x.shape[1], self.d_model)


class ConvolutionModule(nn.Module):
    """Conformer convolution module: pointwise(2C) → GLU → depthwise(k) →
    norm → swish → pointwise(C). The norm is a LayerNorm, or with
    ``norm_type="batch_norm"`` flax's :class:`BatchNorm` (momentum 0.9) over
    every frame given, padding included, as in the JAX package.

    The input is length-masked before ``pointwise_conv1`` and the output
    after ``pointwise_conv2``, so padding never leaks across frames. The
    depthwise conv pads ``(k-1)//2`` on both sides, or ``k-1`` on the left
    when ``causal``.

    Streaming (``causal`` only): ``cache`` is the ``(B, k-1, C)`` depthwise
    input of the frames before this chunk; it is prepended in place of the
    left padding, and ``(x, new_cache)`` is returned, ``new_cache`` being the
    last ``k-1`` frames of the depthwise input.
    """

    def __init__(self, channels, kernel_size=15, causal=False, norm_type="layer_norm"):
        super().__init__()
        self.pointwise_conv1 = nn.Linear(channels, 2 * channels)
        self.glu = GLU(dim=-1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size,
                                        groups=channels)
        if norm_type == "batch_norm":
            self.norm = BatchNorm(channels, momentum=0.9)
        elif norm_type == "layer_norm":
            self.norm = nn.LayerNorm(channels, eps=LN_EPS)
        else:
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.pointwise_conv2 = nn.Linear(channels, channels)
        self.kernel_size, self.causal = kernel_size, causal
        half = (kernel_size - 1) // 2
        self.pad = (kernel_size - 1, 0) if causal else (half, half)
        # Megatron over the channels (parallel/shardings.py): this rank's
        # GLU-paired slice of pointwise_conv1, its channels of the depthwise
        # conv and the norm, its rows of pointwise_conv2
        self.tp_group = None
        self.sp_group = None  # sequence parallel: this rank's frames

    def forward(self, x, mask_pad=None, cache=None):
        # x: (B, T, C); mask_pad: (B, T) True = valid
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad[..., None], 0.0)
        g = self.tp_group
        x = self.glu(self.pointwise_conv1(copy_to(x, g)))
        pad, new_cache = self.pad, None
        if cache is not None:
            if not self.causal:
                raise ValueError("a conv cache needs a causal conv module")
            x = torch.cat([cache.to(x.dtype), x], dim=1)
            new_cache = x[:, x.shape[1] - (self.kernel_size - 1):]
            pad = (0, 0)
        x = self._depthwise(x, pad)
        x = self._norm(x)
        x = x * torch.sigmoid(x)
        x = self.pointwise_conv2(x) if g is None else row_parallel(self.pointwise_conv2, x, g)
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad[..., None], 0.0)
        if new_cache is not None:
            return x, new_cache
        return x

    def _channels(self):
        n = group_size(self.tp_group)
        c = self.depthwise_conv.weight.shape[0] // n
        return group_rank(self.tp_group) * c, c

    def _depthwise(self, x, pad):
        conv, sp = self.depthwise_conv, self.sp_group
        if sp is not None:  # the frames of the other ranks are the halo
            # (every rank convolves the whole sequence and keeps its frames)
            x = all_gather(x, sp, dim=1, grad="slice")
        if self.tp_group is None:
            y = conv(F.pad(x.transpose(1, 2), pad)).transpose(1, 2)
        else:
            c0, c = self._channels()
            y = F.conv1d(F.pad(x.transpose(1, 2), pad), conv.weight[c0:c0 + c],
                         conv.bias[c0:c0 + c], groups=c).transpose(1, 2)
        return y if sp is None else scatter(y, sp, dim=1)

    def _norm(self, x):
        g = self.tp_group
        if g is None:
            return self.norm(x)
        c0, c = self._channels()
        if isinstance(self.norm, BatchNorm):  # per channel, on every rank: keep this rank's
            return scatter(self.norm(all_gather(x, g, dim=-1, grad="slice")), g, dim=-1)
        # LayerNorm over every channel: the mean and E[x^2] summed over the group
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = c * group_size(g)
        both = all_reduce_sum(torch.stack([xf.sum(-1), xf.square().sum(-1)]), g) / n
        mean, var = both[0][..., None], torch.clamp_min(both[1] - both[0].square(), 0.0)[..., None]
        y = (xf - mean) * torch.rsqrt(var + self.norm.eps)
        # float32 out, as an autocast LayerNorm gives
        return y * self.norm.weight[c0:c0 + c] + self.norm.bias[c0:c0 + c]


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
        elif pos_enc == "no_pos":
            self.pos_enc = NoPositionalEncoding(d_model, dropout_rate)
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

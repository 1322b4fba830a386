"""Mixture-of-Experts FFN with expert parallelism (port of
``mindaudio_tpu.parallel.moe``).

The arithmetic is the JAX module's:

- a float32 router, ``softmax(x @ gate)``;
- top-k by repeated argmax (the first index on ties) over the valid tokens
  only (padding takes no capacity and gets a zero output);
- the gates renormalised over the top-k;
- GShard's capacity priority, k-level major and token minor, with the
  capacity ``moe_capacity`` (a multiple of 8, at least 8) of the global
  batch: under data parallelism a token's place counts the assignments of
  the ranks before it (their counts are all-gathered over ``data``), as the
  cumulative sum over the data-sharded batch does under GSPMD;
- a token past its expert's capacity gets zero from it;
- the Switch load-balance loss ``E * sum_e f_e * p_e`` over the valid tokens
  of the global batch.

Where the JAX module multiplies a dense ``(S, E, C)`` one-hot dispatch
tensor into ``(E, C, D)`` expert blocks, this one gathers each expert's
kept tokens by index, runs the expert on them and scatters the results
back: a slot's position never changes its output, only whether it is kept,
so the result is the same without the ``S * E * C`` tensor (about 0.6 GB in
float32 at the flagship's 32 x 10 s batch).

With ``capacity_factor=None`` the layer is dropless (U2++ MoE, arXiv:
2404.16407, WeNet's ``MoEFFNLayer``): every routed assignment is computed
and none is dropped. The router is the same float32 ``x @ gate`` (run with
autocast off), the top-k taken by a stable descending sort (the first index
on ties), the gates the softmax over the k chosen logits; padding is routed
nowhere and gets zero. The (token, slot) assignments are sorted by expert
on the device, each expert's rows found by a search of the sorted ids, and
``ops.grouped_gemm.expert_ffn`` runs every expert's FFN in one grouped-GEMM
launch a product (two forward, four backward; CUDA C++), its bias, Swish and
dropout in the products' epilogues; the gates
combine the results. Nothing is read back to the host and no loop runs over
the experts, so the launches of an application do not depend on ``E``. The
dropout bytes are drawn once an application at ``(B, T, k, H)``, the
batch's rows first and in token, slot order, and read in expert order
through the sort's permutation. The spans ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` (``train.profiler.annotate``) cover its
phases; :data:`counters` counts applications, assignments per expert and
dropped assignments (``train.profiler.moe_counts``).

Experts are split over ``expert_axis`` (``model``): a rank holds ``E / n``
of them (``w1``, ``b1``, ``w2``, ``b2`` cut along the expert dimension).
The tokens are replicated over that axis, as in the JAX layout where the
batch is sharded over ``data`` only, so no token needs to move: each rank
runs its experts on the tokens routed to them, and one sum over the group
(``collectives.reduce_from``) assembles every assignment's output before
the gates combine them. flax's ``sow`` has no counterpart: the layer keeps
the aux loss of its last forward in ``aux_loss`` and the model returns the
blocks' losses explicitly.
"""

from __future__ import annotations

import collections
import time

import torch
from torch import nn
from torch.nn import functional as F

from .collectives import all_gather_tensor, all_reduce, copy_to, reduce_from
from .mesh import active_mesh, data_denominator
from .shardings import set_shard

__all__ = ["MoEFeedForward", "moe_capacity", "moe_aux_losses", "counters", "records"]

# every application since the last reset (train.profiler.moe_counts): their
# number, the assignments per expert and the dropped ones, summed on the
# device; and each application's assignments per expert with its wall-clock
# time, kept while a profiler session records (train.profiler.moe_timeline)
counters = {"applications": 0, "assigned": None, "dropped": None}
records = collections.deque(maxlen=1 << 16)
_autograd_profiler = torch.autograd.profiler


def _count(assigned, dropped=None):
    """Add one application's assignments per expert (int64, on the device)
    and, where assignments were dropped, their number."""
    counters["applications"] += 1
    total = counters["assigned"]
    if total is None or total.shape != assigned.shape or total.device != assigned.device:
        counters["assigned"] = assigned.clone()  # a model's MoE layers share E
    else:
        total.add_(assigned)
    if dropped is not None:
        if counters["dropped"] is None or counters["dropped"].device != dropped.device:
            counters["dropped"] = torch.zeros((), dtype=torch.int64, device=dropped.device)
        counters["dropped"].add_(dropped)
    if _autograd_profiler._is_profiler_enabled:
        records.append((time.time_ns(), assigned))


class _Rows(torch.autograd.Function):
    """``t.to(dtype)[index]``, whose gradient takes the rows back by
    ``back`` (``index``'s inverse, one row of the result to each place) and
    sums every ``fold`` of them in float32: a token sent to ``fold``
    experts gathers their gradients."""

    @staticmethod
    def forward(ctx, t, index, back, fold, dtype):
        ctx.save_for_backward(back)
        ctx.fold, ctx.dtype = fold, t.dtype
        return t.to(dtype).index_select(0, index)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        g = g.index_select(0, back)
        if ctx.fold > 1:
            g = g.view(-1, ctx.fold, g.shape[-1]).sum(1, dtype=torch.float32)
        return g.to(ctx.dtype), None, None, None, None


def moe_capacity(n_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Static per-expert capacity: ``factor * k * S / E``, rounded up to a
    multiple of 8 and at least 8."""
    cap = int(capacity_factor * top_k * n_tokens / num_experts + 0.999)
    return max(8, (cap + 7) // 8 * 8)


class MoEFeedForward(nn.Module):
    """Drop-in MoE replacement for ``PositionwiseFeedForward``.

    Parameters keep flax's names and layouts (``gate (D, E)``, ``w1 (E, D,
    H)``, ``b1 (E, H)``, ``w2 (E, H, D)``, ``b2 (E, D)``) so
    ``convert.convert_params`` carries them across. With a ``mesh`` whose
    ``expert_axis`` has ``n > 1`` ranks, this rank stores only its ``E / n``
    experts (``E`` must be a multiple of ``n``). ``capacity_factor=None``
    makes it dropless (its activation is then Swish, as U2++ MoE's).
    ``aux_loss`` is the Switch load-balance loss of the last forward,
    computed when first read (``None`` before a forward): a trainer that
    weighs it by 0 never reads it and launches nothing for it.
    """

    def __init__(self, d_model, num_experts, hidden_units, dropout_rate=0.1, top_k=2,
                 capacity_factor=1.25, activation=F.relu, mesh=None, expert_axis="model"):
        super().__init__()
        from ..models.layers import FastDropout, Swish

        if capacity_factor is None and not isinstance(activation, Swish):
            raise ValueError("the dropless MoE runs Swish experts (its kernel's epilogue)")
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} exceeds num_experts={num_experts}: each token "
                             "can select an expert at most once")
        self.num_experts, self.top_k, self.capacity_factor = num_experts, top_k, capacity_factor
        self.activation = activation
        self.group, self.local, self.first = None, num_experts, 0
        e = num_experts
        self.gate = nn.Parameter(torch.zeros(d_model, num_experts))
        self.w1 = nn.Parameter(torch.zeros(e, d_model, hidden_units))
        self.b1 = nn.Parameter(torch.zeros(e, hidden_units))
        self.w2 = nn.Parameter(torch.zeros(e, hidden_units, d_model))
        self.b2 = nn.Parameter(torch.zeros(e, d_model))
        self.dropout = FastDropout(dropout_rate)
        # the last forward's routing, kept for aux_loss: (dropless, arguments)
        self._routing, self._aux = None, None
        if mesh is not None:
            self.shard(mesh, expert_axis)

    @torch.no_grad()
    def shard(self, mesh, expert_axis="model"):
        """Keep only this rank's experts of the ``expert_axis`` group (the
        stacks cut along the expert dimension, ``parallel.shardings``)."""
        n = mesh.size(expert_axis)
        if n == 1 or self.group is not None:
            return self
        if self.num_experts % n:
            raise ValueError(f"{self.num_experts} experts do not split over {n} ranks")
        self.group = mesh.group(expert_axis)
        self.local = self.num_experts // n
        self.first = mesh.index(expert_axis) * self.local
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.data = p.data[self.first:self.first + self.local].clone()
            set_shard(p, (expert_axis,), 0)
        return self

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's initialisers: lecun-normal (truncated) ``gate``, ``w1``,
        ``w2`` with the fan-in of one expert's matrix, zero biases."""
        from ..models.layers import lecun_normal_

        lecun_normal_(self.gate, self.gate.shape[0], generator)
        lecun_normal_(self.w1, self.w1.shape[1], generator)
        lecun_normal_(self.w2, self.w2.shape[1], generator)
        self.b1.zero_()
        self.b2.zero_()
        return self

    @property
    def aux_loss(self):
        """The Switch loss of the last forward (``None`` before one),
        computed at the first read after it."""
        if self._aux is None and self._routing is not None:
            dropless, args = self._routing
            self._aux = (self._dropless_switch_loss(*args) if dropless
                         else self._switch_loss(*args))
        return self._aux

    @property
    def dropless(self):
        """Whether every routed assignment is computed (no capacity)."""
        return self.capacity_factor is None

    def forward(self, x, mask_pad=None):
        """``x (B, T, D)``; ``mask_pad (B, T)`` True at valid positions."""
        if self.dropless:
            return self._dropless(x, mask_pad)
        b, t, d = x.shape
        e_all, k = self.num_experts, self.top_k
        mesh = active_mesh()
        data = None if mesh is None else mesh.group("data")
        n_data = 1 if data is None else mesh.size("data")
        s = b * t
        cap = moe_capacity(s * n_data, e_all, k, self.capacity_factor)

        xs = x.reshape(s, d)
        probs = torch.softmax(xs.float() @ self.gate.float(), dim=-1)  # (S, E)
        valid = (torch.ones((s, 1), dtype=torch.float32, device=x.device) if mask_pad is None
                 else mask_pad.reshape(s, 1).float())

        remaining, sel = probs.detach(), []
        for _ in range(k):
            one = F.one_hot(remaining.argmax(-1), e_all).float() * valid
            sel.append(one)
            remaining = remaining * (1.0 - one)
        gk = probs * sum(sel)
        gk = gk / torch.clamp_min(gk.sum(-1, keepdim=True), 1e-9)

        # GShard positions over the global batch: k-level major, token minor;
        # the ranks before this one in ``data`` come first in token order
        level = torch.stack([one.sum(0) for one in sel])  # (K, E) this rank
        ranks = all_gather_tensor(level[None], data)  # (n_data, K, E)
        before = ranks[:mesh.index("data")].sum(0) if data is not None else torch.zeros_like(level)
        total = ranks.sum(0)
        counts = torch.zeros(e_all, dtype=torch.float32, device=x.device)
        keeps = []
        for j, one in enumerate(sel):
            pos = torch.cumsum(one, 0) - one + counts + before[j]
            keeps.append(one * (pos < cap))
            # the kept ones of this level over the whole batch
            counts = counts + torch.clamp(cap - counts, min=0.0).minimum(total[j])

        # every kept (token, level) assignment, run by the rank holding its
        # expert; the dropout bytes are drawn for every assignment on every
        # rank, so the ranks' generators stay in step
        xe = copy_to(xs, self.group)
        out = xs.new_zeros((k, s, d))
        bits = self.dropout.bits((k, s, self.w1.shape[-1]), x.device)
        for j, keep in enumerate(keeps):
            expert = keep.argmax(-1)
            kept = keep.sum(-1) > 0
            for le in range(self.local):
                idx = torch.nonzero(kept & (expert == self.first + le)).squeeze(-1)
                h = self.activation(xe[idx] @ self.w1[le] + self.b1[le])
                h = self.dropout(h, None if bits is None else bits[j, idx])
                y = h @ self.w2[le] + self.b2[le]
                out = out.index_put((torch.full_like(idx, j), idx), y.to(out.dtype))
        out = reduce_from(out, self.group)
        weights = torch.stack([(keep * gk).sum(-1) for keep in keeps])  # (K, S)
        y = (weights[..., None].to(out.dtype) * out).sum(0)
        assigned = level.sum(0)
        _count(assigned.long(), (assigned.sum() - sum(keep.sum() for keep in keeps)).long())
        self._routing, self._aux = (False, (probs, sel[0], valid, data)), None
        return y.reshape(b, t, d).to(x.dtype)

    def _switch_loss(self, probs, top1, valid, data):
        """The Switch load-balance loss over the global batch's valid tokens
        (``top1``: each token's first choice, one-hot, zero at padding); this
        rank's share, so that the data group's mean is the global value."""
        n_valid = torch.clamp_min(all_reduce(valid.sum(), data), 1.0)
        f_e = all_reduce(top1.sum(0), data) / n_valid
        p_e = (probs * valid).sum(0) / data_denominator(valid.sum(), 1.0)
        return self.num_experts * torch.sum(f_e * p_e)

    def _dropless_switch_loss(self, logits, first, mask_pad, data):
        """:meth:`_switch_loss` from the dropless path's float32 router
        logits (S, E), each token's first choice (S, 1) (E at padding) and the
        padding mask (or ``None``)."""
        s, e = logits.shape
        valid = (torch.ones((s, 1), dtype=torch.float32, device=logits.device)
                 if mask_pad is None else mask_pad.reshape(s, 1).float())
        top1 = (first == torch.arange(e, device=logits.device)).float()
        return self._switch_loss(torch.softmax(logits, -1), top1, valid, data)

    def _dropless(self, x, mask_pad):
        from ..ops import fused_dropout
        from ..ops.grouped_gemm import expert_ffn
        from ..train.profiler import annotate

        b, t, d = x.shape
        e, k, s = self.num_experts, self.top_k, b * t
        dev = x.device
        dtype = (torch.get_autocast_dtype(dev.type) if torch.is_autocast_enabled(dev.type)
                 else x.dtype)
        xs = x.reshape(s, d)
        with annotate("moe.route"):
            with torch.autocast(dev.type, enabled=False):
                logits = xs.float() @ self.gate.float()  # (S, E)
            top, idx = torch.sort(logits, stable=True, dim=-1, descending=True)
            gates = torch.softmax(top[:, :k], -1)  # (S, k)
            idx = idx[:, :k]
            if mask_pad is not None:  # padding goes to group E, which no expert runs
                idx = torch.where(mask_pad.reshape(s, 1), idx, e)
        with annotate("moe.dispatch"):
            # the (token, slot) rows sorted by expert; group g is rows
            # offsets[g]:offsets[g + 1]; back[r] is where slot r went
            keys, order = torch.sort(idx.reshape(-1), stable=True)
            offsets = torch.searchsorted(keys, torch.arange(e + 2, device=dev))
            back = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=dev))
            xe = _Rows.apply(copy_to(xs, self.group), order // k, back, k, dtype)
            bits = self.dropout.bits((b, t, k, self.w1.shape[-1]), dev)
            if bits is not None:
                fused_dropout.applications["fused" if x.is_cuda else "plain"] += 1
                bits = bits.view(s * k, -1)
        with annotate("moe.experts"):
            thresh = self.dropout._thresh()
            ye = expert_ffn(xe, self.w1, self.b1, self.w2, self.b2,
                            offsets[self.first:self.first + self.local + 1],
                            None if bits is None else order, bits, thresh,
                            fused_dropout.scale_of(thresh) if bits is not None else 1.0)
            ye = reduce_from(ye, self.group)
        with annotate("moe.combine"):
            y = _Rows.apply(ye, back, order, 1, ye.dtype).view(s, k, d)
            y = (y * gates[..., None]).sum(1)
        _count(offsets[1:e + 1] - offsets[:e])
        mesh = active_mesh()
        data = None if mesh is None else mesh.group("data")
        self._routing, self._aux = (True, (logits, idx[:, :1], mask_pad, data)), None
        return y.reshape(b, t, d).to(x.dtype)


def moe_aux_losses(module):
    """The aux losses of the last forward of every :class:`MoEFeedForward`
    in ``module``, stacked (an empty tensor when there is none)."""
    losses = [m.aux_loss for m in module.modules()
              if isinstance(m, MoEFeedForward) and m.aux_loss is not None]
    return torch.stack(losses) if losses else torch.zeros(0)


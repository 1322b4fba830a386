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

import torch
from torch import nn
from torch.nn import functional as F

from .collectives import all_gather_tensor, all_reduce, copy_to, reduce_from
from .mesh import active_mesh, data_denominator
from .shardings import set_shard

__all__ = ["MoEFeedForward", "moe_capacity", "moe_aux_losses"]


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
    experts (``E`` must be a multiple of ``n``).
    """

    def __init__(self, d_model, num_experts, hidden_units, dropout_rate=0.1, top_k=2,
                 capacity_factor=1.25, activation=F.relu, mesh=None, expert_axis="model"):
        super().__init__()
        from ..models.layers import FastDropout

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
        self.aux_loss = None
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

    def forward(self, x, mask_pad=None):
        """``x (B, T, D)``; ``mask_pad (B, T)`` True at valid positions."""
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

        # Switch load-balance loss over the global batch's valid tokens; this
        # rank's share, so that the data group's mean is the global value
        n_valid = torch.clamp_min(all_reduce(valid.sum(), data), 1.0)
        f_e = all_reduce(sel[0].sum(0), data) / n_valid
        p_e = (probs * valid).sum(0) / data_denominator(valid.sum(), 1.0)
        self.aux_loss = e_all * torch.sum(f_e * p_e)
        return y.reshape(b, t, d).to(x.dtype)


def moe_aux_losses(module):
    """The aux losses of the last forward of every :class:`MoEFeedForward`
    in ``module``, stacked (an empty tensor when there is none)."""
    losses = [m.aux_loss for m in module.modules()
              if isinstance(m, MoEFeedForward) and m.aux_loss is not None]
    return torch.stack(losses) if losses else torch.zeros(0)


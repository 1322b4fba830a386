"""Sequence-parallel attention over the ``seq`` group (port of
``mindaudio_tpu.parallel.ring_attention``).

Each rank holds the local shards ``(B, H, T_loc, D)`` of q, k and v (the
time axis split over the group, rank ``i`` holding frames ``[i * T_loc,
(i + 1) * T_loc)``).

- :func:`ring_attention` streams the softmax (flash-attention form, running
  maximum ``m``, sum ``l`` and accumulator, ``NEG_INF = -1e30`` at masked
  keys, zero output for a fully masked row) while k, v and their validity
  travel one hop around the ring per step (``collectives.permute``, JAX's
  ``ppermute``), ``n`` steps in all. Autograd runs back through the hops
  (each hop's backward is the opposite hop), as ``jax.grad`` does through
  ``ppermute``.
- :func:`ulysses_attention` trades heads for time with one ``all_to_all``
  each way (``H`` must be a multiple of the group size) and runs dense
  attention over the whole sequence for its heads.
- :func:`sequence_parallel_attention` takes whole ``(B, H, T, D)`` tensors,
  cuts this rank's frames, runs one of the two and gathers the frames back:
  the counterpart of the JAX ``shard_map`` wrapper.
"""

from __future__ import annotations

import torch

from .collectives import all_gather, all_gather_tensor, all_to_all, group_size, permute, scatter

__all__ = ["NEG_INF", "ring_attention", "ulysses_attention", "sequence_parallel_attention"]

NEG_INF = -1.0e30


def ring_attention(q, k, v, group, kv_valid=None, scale=None):
    """Streaming-softmax attention with k/v rotating around ``group``.

    Args:
        q/k/v: local shards ``(B, H, T_loc, D)`` (v's last dimension may
            differ from q's, e.g. under the rel-pos augmented head).
        kv_valid: optional ``(B, T_loc)`` bool, True at valid keys (rotates
            with k/v).
        scale: score scale, default ``D ** -0.5`` of q.

    Returns ``(B, H, T_loc, Dv)`` for the local queries, in q's dtype.
    """
    n = group_size(group)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    q = q * torch.tensor(scale, dtype=q.dtype)
    b, h, t, _ = q.shape
    acc = q.new_zeros((b, h, t, v.shape[-1]), dtype=torch.float32)
    m = q.new_full((b, h, t), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, t), dtype=torch.float32)
    if kv_valid is None:
        kv_valid = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool, device=k.device)
    for i in range(n):
        s = (q @ k.transpose(-2, -1)).float()
        s = torch.where(kv_valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        # a fully masked row gives exp(NEG_INF - NEG_INF) = 1: zero it
        p = torch.where(kv_valid[:, None, None, :], p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + (p.to(v.dtype) @ v).float()
        m = m_new
        if i < n - 1:  # the last hop would bring every shard home unused
            k, v = permute(k, group), permute(v, group)
            kv_valid = permute(kv_valid.to(torch.uint8), group).bool()
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q, k, v, group, kv_valid=None, scale=None):
    """All-to-all sequence parallelism: ``(B, H, T_loc, D)`` shards become
    ``(B, H / n, T, D)`` head shards, dense attention runs over the whole
    sequence, and a second all-to-all restores the time split. Raises when
    ``H`` is not a multiple of the group size. Args/returns as
    :func:`ring_attention`."""
    n = group_size(group)
    if q.shape[1] % n:
        raise ValueError(f"head count {q.shape[1]} not divisible by mesh axis size {n}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qg, kg, vg = (all_to_all(x, group, split_dim=1, concat_dim=2) for x in (q, k, v))
    s = ((qg * torch.tensor(scale, dtype=q.dtype)) @ kg.transpose(-2, -1)).float()
    if kv_valid is not None:
        valid = all_gather_tensor(kv_valid, group, dim=1)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if kv_valid is not None:
        # a fully masked row: the ring gives 0 there, keep the two alike
        p = torch.where(valid[:, None, None, :], p, 0.0)
    out = p.to(vg.dtype) @ vg
    return all_to_all(out, group, split_dim=2, concat_dim=1).to(q.dtype)


def sequence_parallel_attention(q, k, v, group, kv_valid=None, variant="ring", scale=None):
    """Whole ``(B, H, T, D)`` tensors (replicated over ``group``) in, whole
    attention out: this rank's frames go through ``variant`` (``"ring"`` or
    ``"ulysses"``) and the outputs are gathered. ``T`` must be a multiple of
    the group size."""
    n = group_size(group)
    if q.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]} not divisible by {n}")
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[variant]
    local = [scatter(x, group, dim=2) for x in (q, k, v)]
    valid = None if kv_valid is None else scatter(kv_valid, group, dim=1)
    out = fn(*local, group, kv_valid=valid, scale=scale)
    return all_gather(out, group, dim=2, grad="slice")

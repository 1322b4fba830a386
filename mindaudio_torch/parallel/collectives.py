"""The collectives GSPMD inserts for the JAX package, written out over the
process groups of ``parallel/mesh.py``, with their backward passes.

Every function takes a group (``None`` = this rank alone, where it is the
identity) and runs on the tensors' own device: nothing goes through the
host. The differentiable ones follow one convention: the loss is one value,
every rank that holds a replicated tensor holds its whole gradient, and a
rank that holds a shard holds the gradient of its shard.

- :func:`all_reduce_sum`: the sum over the group; backward the sum of the
  gradients (each rank's gradient of the sum is a part of the whole one, as
  for the partial statistics of a norm over a split axis).
- :func:`reduce_from`: Megatron's ``g``, the sum forward and the identity
  backward (the output is replicated, and so is its gradient).
- :func:`copy_to`: Megatron's ``f``, the identity forward and the sum
  backward (a replicated input feeding a split computation).
- :func:`all_gather`: the shards concatenated along ``dim``; backward this
  rank's slice of the gradient (``grad="slice"``, the gathered tensor is
  used alike on every rank) or the slice of its sum over the group
  (``grad="sum"``, each rank uses it for a part of the work).
- :func:`scatter`: this rank's slice of a replicated tensor; backward the
  gathered gradient.
- :func:`all_to_all`: JAX's tiled ``all_to_all``; backward the inverse one.
- :func:`permute`: JAX's ``ppermute`` by a shift (ring or open chain);
  backward the opposite shift. It is an ``all_to_all_single`` with one
  non-empty split each way, as gloo has no point-to-point transfer of CUDA
  tensors.
- :func:`broadcast`: the source's tensor on every rank; backward the
  gradient at the source (the output is replicated) and zero elsewhere.
- :func:`broadcast_grad`: the identity; backward the source's gradient on
  every rank (a replicated tensor that only the source uses).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "group_size",
    "group_rank",
    "all_reduce",
    "all_gather_tensor",
    "all_reduce_sum",
    "reduce_from",
    "copy_to",
    "all_gather",
    "scatter",
    "all_to_all",
    "permute",
    "broadcast",
    "broadcast_grad",
]


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group):
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """A reduced copy of ``x`` over ``group`` (no gradient)."""
    if group is None:
        return x.clone()
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_tensor(x, group, dim=0):
    """The ranks' ``x`` concatenated along ``dim`` in group order (no gradient)."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    x = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def _slice(x, group, dim):
    n, r = group_size(group), group_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        return all_gather_tensor(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = all_reduce(g.contiguous(), ctx.group)
        return _slice(g, ctx.group, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_tensor(g.contiguous(), ctx.group, ctx.dim), None, None


def _all_to_all(x, group, split_dim, concat_dim):
    n = group_size(group)
    if n == 1:
        return x.clone()
    # chunk j of split_dim goes to rank j; chunks received stack along concat_dim
    parts = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(split_dim, 0)
    send = parts.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group, ctx.concat_dim, ctx.split_dim), \
            None, None, None


def _permute(x, group, shift, wrap):
    """``x`` of group rank ``r`` lands on rank ``r + shift`` (modulo the size
    when ``wrap``, else dropped past the ends; a rank that receives nothing
    gets zeros)."""
    n, r = group_size(group), group_rank(group)
    if n == 1:
        return x.clone() if wrap else torch.zeros_like(x)
    dst, src = r + shift, r - shift
    if wrap:
        dst, src = dst % n, src % n
    numel = x.numel()
    send_splits = [numel if j == dst else 0 for j in range(n)]
    recv_splits = [numel if j == src else 0 for j in range(n)]
    out = torch.zeros(numel if 0 <= src < n else 0, dtype=x.dtype, device=x.device)
    send = x.detach().contiguous().reshape(-1) if 0 <= dst < n else x.new_empty(0)
    dist.all_to_all_single(out, send, recv_splits, send_splits, group=group)
    return out.view_as(x) if out.numel() else torch.zeros_like(x)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift, wrap):
        ctx.group, ctx.shift, ctx.wrap = group, shift, wrap
        return _permute(x, group, shift, wrap)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift, ctx.wrap), None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        out = x.detach().clone().contiguous()
        if group is not None:
            dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if group_rank(ctx.group) == ctx.src:
            return g, None, None
        return torch.zeros_like(g), None, None


class _BroadcastGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.broadcast(g, dist.get_global_rank(ctx.group, ctx.src), group=ctx.group)
        return g, None, None


def all_reduce_sum(x, group):
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_from(x, group):
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to(x, group):
    return x if group is None else _CopyTo.apply(x, group)


def all_gather(x, group, dim=0, grad="slice"):
    return x if group is None else _AllGather.apply(x, group, dim % x.dim(), grad)


def scatter(x, group, dim=0):
    return x if group is None else _Scatter.apply(x, group, dim % x.dim())


def all_to_all(x, group, split_dim, concat_dim):
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(), concat_dim % x.dim())


def permute(x, group, shift=1, wrap=True):
    if group is None:
        return x if wrap else torch.zeros_like(x)
    return _Permute.apply(x, group, shift, wrap)


def broadcast(x, group, src):
    """``src`` is the source's rank within ``group``."""
    return x if group is None else _Broadcast.apply(x, group, src)


def broadcast_grad(x, group, src):
    """``src`` is the source's rank within ``group``."""
    return x if group is None else _BroadcastGrad.apply(x, group, src)

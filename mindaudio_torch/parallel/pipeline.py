"""GPipe pipeline parallelism over the ``pipe`` group (port of
``mindaudio_tpu.parallel.pipeline``).

A stack of ``L`` identical layers is cut into ``S`` contiguous stages, one a
rank of the ``pipe`` group (stage ``s`` runs layers ``[s * L / S, (s + 1) *
L / S)``), and the batch into ``M`` microbatches that stream through them.
The schedule is the JAX one, tick by tick over ``M + S - 1`` ticks:

  tick t: every stage applies its layers to its current activation, then
          the activation moves one stage on (``collectives.permute``, an open
          chain: JAX's ``ppermute``). Stage 0 takes microbatch ``t``; the
          last stage banks microbatch ``t - (S - 1)`` from tick ``S - 1`` on.

Every rank runs every tick (at the rims on a clamped microbatch whose
result is never used) and keeps the same outputs, so all ranks build the
same graph and meet in the same collectives, forward and backward (the
other stages' outputs carry a zero gradient back through their hops). Autograd replays the schedule in
reverse: each hop's backward sends the gradient back to the stage that made
the activation. The JAX version replicates the result to every stage with a
``psum``; here the last stage broadcasts it, and the input's gradient,
which only stage 0 computes, is broadcast from stage 0 in the backward
(``collectives.broadcast_grad``), so every rank holds the whole gradient of
the replicated tensors around the pipeline. A layer's parameters get a
gradient only on the stage that runs it: the caller marks them partial over
``pipe`` (``parallel.shardings.set_partial``) so the train step sums them.
"""

from __future__ import annotations

import torch

from .collectives import broadcast, broadcast_grad, group_rank, group_size, permute

__all__ = ["stack_layer_params", "pipeline_spmd", "pipeline_apply"]


def stack_layer_params(per_layer_params):
    """Stack ``L`` per-layer ``{name: tensor}`` dicts into one dict whose
    tensors lead with the layer dimension ``L``."""
    return {k: torch.stack([p[k] for p in per_layer_params]) for k in per_layer_params[0]}


def pipeline_spmd(layer_fn, layers, microbatches, group, extras=(), batched=()):
    """This rank's schedule. ``layers`` are the indices of its stage's
    layers; ``microbatches`` is the whole ``(M, mb, ...)`` stack (the same
    on every stage); ``layer_fn(l, h, *extras, *batched_l)`` applies layer
    ``l``, ``batched`` entries are ``(M, ...)`` stacks of which the stage's
    current microbatch's entry is passed. Returns the ``(M, mb, ...)``
    outputs, the same on every stage."""
    size, idx = group_size(group), group_rank(group)
    n_micro = microbatches.shape[0]
    first = torch.tensor(idx == 0, device=microbatches.device)
    state = torch.zeros_like(microbatches[0])
    outs = []
    for t in range(n_micro + size - 1):
        inp = torch.where(first, microbatches[min(t, n_micro - 1)], state)
        mb_idx = min(max(t - idx, 0), n_micro - 1)
        h = inp
        for l in layers:
            h = layer_fn(l, h, *extras, *(e[mb_idx] for e in batched))
        if t >= size - 1:
            # banked: the last stage's are the outputs; the others' take part
            # only so that the backward reaches every hop on every rank
            outs.append(h)
        if t < n_micro + size - 2:
            state = permute(h, group, 1, wrap=False)
    return broadcast(torch.stack(outs), group, size - 1)


def pipeline_apply(layer_fn, num_layers, x, mesh, *, num_microbatches, extras=(),
                   batched_extras=(), axis_name="pipe"):
    """Run ``x (B, ...)`` through ``num_layers`` layers as a pipeline over
    ``mesh``'s ``axis_name`` group; returns ``(B, ...)``, equal to the
    layers applied in order.

    ``layer_fn(l, h, *extras, *batched)`` applies layer ``l``; ``extras``
    go to every call, ``batched_extras`` have the batch first and are cut
    into the microbatches alongside ``x`` (the attention masks). Raises when
    the layers do not split into the stages or the batch into the
    microbatches.
    """
    group = mesh.group(axis_name)
    size, idx = group_size(group), group_rank(group)
    if num_layers % size:
        raise ValueError(f"{num_layers} layers not divisible into {size} stages")
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by {num_microbatches} microbatches")
    per = num_layers // size
    mb = batch // num_microbatches
    x = broadcast_grad(x, group, 0)
    x_mb = x.reshape((num_microbatches, mb) + x.shape[1:])
    batched = tuple(e.reshape((num_microbatches, mb) + e.shape[1:]) for e in batched_extras)
    out = pipeline_spmd(layer_fn, range(idx * per, (idx + 1) * per), x_mb, group,
                        extras, batched)
    return out.reshape((batch,) + out.shape[2:])

"""Train step factory (port of ``mindaudio_tpu.train.state``).

One step is: features, forward and loss under bf16 autocast (float32
parameters, float32 losses), gradients, global-norm clipping, and an AdamW
update that a non-finite loss or gradient turns into a no-op, for the
parameters, the moments and the batch norms' running statistics that the
forward updated. The decision stays on the device: nothing in a step reads a
value back to the host, so steps queue up behind each other and the caller
synchronises when it reads a metric.

Over a mesh (``parallel.mesh``): the gradients are made those of the global
batch before anything reads them (``parallel.shardings.sync_grads``: partial
gradients summed, then one flat all-reduce over ``data``), so every rank
clips, skips and updates alike; the global norm and the finite check add up
over the ranks that hold pieces of a sharded parameter; the metrics are
averaged over ``data`` (each rank's loss is its share of the global batch's,
``parallel.mesh.data_denominator``).

Under a ``torch.profiler`` session a step records the spans ``train.step``
and, inside it, ``train.features``, ``train.forward``, ``train.backward``,
``train.sync_grads`` (over a mesh), ``train.clip`` and ``train.update``
(``train.profiler.annotate``); otherwise each costs one flag read.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..models.layers import running_stats
from ..parallel.collectives import all_reduce
from ..parallel.shardings import any_group, shard_groups, sync_grads
from .profiler import annotate

__all__ = ["clip_by_global_norm", "skip_nonfinite_update", "make_train_step"]


def _global_norm(grads, groups=None):
    norms = torch.stack(torch._foreach_norm(grads))
    if groups is None or all(g is None for g in groups):
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    total = sum(sq[i] for i, g in enumerate(groups) if g is None)
    for group in {id(g): g for g in groups if g is not None}.values():
        part = torch.stack([sq[i] for i, g in enumerate(groups) if g is group]).sum()
        total = total + all_reduce(part, group)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm, groups=None):
    """Scale ``grads`` (a list) so that their global norm is at most ``max_norm``.

    Returns ``(clipped_grads, global_norm)``. The scale is
    ``min(1, max_norm / (norm + 1e-6))`` and a non-finite scale becomes 0
    (``torch.nn.utils.clip_grad_norm_`` does not do that). ``0 * inf`` is
    still NaN on the overflowed leaves, so pair this with
    :func:`skip_nonfinite_update`. ``groups`` (aligned with ``grads``) names
    for a sharded gradient the group holding its other pieces, whose squares
    are summed over it (``parallel.shardings.shard_groups``).
    """
    gnorm = _global_norm(grads, groups)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-6), 1.0)
    scale = torch.where(torch.isfinite(scale), scale, 0.0)
    return torch._foreach_mul(grads, scale), gnorm


def skip_nonfinite_update(optimizer, loss, grads, stats=(), group=None):
    """Apply ``optimizer.step(grads)`` unless the loss or any gradient leaf is
    non-finite; returns the flag ``ok`` as a boolean device scalar.

    On a bad batch the parameters, both moments and the optimizer's count
    keep their old values, as the JAX package keeps its old optax state (so
    the schedule and the bias correction read the count of the updates
    made; a recipe counts the batches consumed in a global step of its
    own). ``stats`` are ``(tensor, old value)`` pairs, the running
    statistics the forward updated in place: on a bad batch each tensor gets
    its old value back (the JAX package reverts ``batch_stats`` with the
    rest of its state). The flag is never read on the host: the optimizer
    selects with it on the device. ``group``: the ranks that hold pieces of
    the sharded gradients, which must all agree (one bad piece skips all).
    """
    # the largest magnitude of a leaf is finite exactly when every element is
    peaks = torch.stack(torch._foreach_norm(grads, float("inf")))
    ok = torch.isfinite(loss) & torch.isfinite(peaks).all()
    if group is not None:
        ok = all_reduce(ok.to(torch.float32), group, dist.ReduceOp.MIN) > 0
    optimizer.step(grads, ok=ok)
    for new, old in stats:
        new.copy_(torch.where(ok, new, old))
    return ok


def make_train_step(model, optimizer, features_fn=None, grad_clip_norm=None,
                    autocast_dtype=None, loss_fn=None, mesh=None, skip_nonfinite=True):
    """Build ``step(batch) -> metrics`` for ``model(batch) -> (loss, metrics)``.

    Args:
        model: the module to train, already in ``train()`` mode if dropout is
            wanted; ``optimizer`` must hold ``model.named_parameters()``.
        features_fn: optional ``batch -> (feats, feat_lens)``, run in float32
            outside autocast (the DFT of the front-end is sensitive to bf16);
            its results join the batch as ``feats`` and ``feat_lens``.
        grad_clip_norm: optional global-norm clip; adds ``grad_norm``.
        autocast_dtype: e.g. ``torch.bfloat16`` for the model's products
            (parameters and gradients stay float32); ``None`` computes in the
            parameters' dtype.
        loss_fn: optional ``(model, batch) -> (loss, metrics)`` called in
            place of ``model(batch)`` (e.g. to pass a dynamic-chunk model the
            generator it samples its chunk masks from).
        mesh: the ``parallel.mesh.Mesh`` the step runs over (``None``: one
            process); each rank passes its own rows of the global batch.
        skip_nonfinite: skip a batch with a non-finite loss or gradient
            (the default); ``False`` applies every update as it comes, NaN
            included, as the JAX package's ``skip_nonfinite=False`` does.

    Returns:
        ``step``; its metrics (``loss``, the model's own, ``grad_norm``) are
        device scalars, detached. With ``skip_nonfinite`` a batch with a
        non-finite loss or gradient is skipped (:func:`skip_nonfinite_update`),
        the model's batch-norm running statistics included.
    """
    params = optimizer.params
    device_type = params[0].device.type
    stats = running_stats(model)
    groups = shard_groups(params, mesh)
    agree = any_group(params, mesh)
    data = None if mesh is None else mesh.group("data")
    if loss_fn is None:
        def loss_fn(model, batch):
            return model(batch)

    def step(batch):
        with annotate("train.step"):
            # the forward updates the running statistics in place
            old_stats = [s.clone() for s in stats] if skip_nonfinite else None
            if features_fn is not None:
                with annotate("train.features"), torch.no_grad():
                    feats, feat_lens = features_fn(batch)
                batch = dict(batch, feats=feats, feat_lens=feat_lens)
            autocast = (torch.autocast(device_type, dtype=autocast_dtype)
                        if autocast_dtype is not None else contextlib.nullcontext())
            with annotate("train.forward"), autocast:
                loss, metrics = loss_fn(model, batch)
            with annotate("train.backward"):
                grads = list(torch.autograd.grad(loss, params, allow_unused=True,
                                                 materialize_grads=True))
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            if mesh is not None:
                with annotate("train.sync_grads"):
                    grads = sync_grads(params, grads, mesh)
                    if data is not None:  # the global batch's metrics
                        keys = sorted(metrics)
                        mean = all_reduce(torch.stack([metrics[k].float() for k in keys]), data)
                        metrics = dict(zip(keys, mean / mesh.size("data")))
            if grad_clip_norm is not None:
                with annotate("train.clip"):
                    grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip_norm,
                                                                      groups)
            with annotate("train.update"):
                if skip_nonfinite:
                    skip_nonfinite_update(optimizer, metrics["loss"], grads,
                                          zip(stats, old_stats), agree)
                else:
                    optimizer.step(grads)
            return metrics

    return step

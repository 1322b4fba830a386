"""Parameter layouts over the mesh: the Megatron rule table, and what the
train step and the checkpoints need to know of a layout (port of
``mindaudio_tpu.parallel.shardings``).

GSPMD derives every collective from the parameters' shardings; the port
records a layout on the parameters themselves and each consumer reads it:

- ``mindaudio_shard = (axes, dim, kind)``: the ranks along ``axes`` hold
  different pieces of the parameter, cut along ``dim`` (``kind`` is
  ``"split"`` for contiguous pieces, ``"glu"`` for the GLU-paired halves of
  ``pointwise_conv1``).
  The global gradient norm and the finite check add up over ``axes``
  (:func:`shard_groups`), and a checkpoint gathers the pieces
  (:func:`full_tensor`).
- ``mindaudio_partial = axes``: the parameter is replicated over ``axes``
  but each rank uses it on a part of the work (a head slice, a channel
  slice, a time slice, a pipeline stage's blocks), so each holds a part of
  its gradient; :func:`sync_grads` sums them.

:func:`sync_grads` then averages every gradient over the ``data`` group,
the all-reduce that GSPMD inserts for a data-sharded batch.

``CONFORMER_TP_RULES`` is the JAX table in the port's parameter names
(``Dense_0``/``Dense_1`` are ``w_1``/``w_2``, a Linear's weight is ``(out,
in)``, so a column-parallel kernel ``P(None, "model")`` cuts dimension 0 of
the weight and a row-parallel one dimension 1). A leaf is cut only where the
model axis divides its dimension, as JAX's ``_spec_for``.
"""

from __future__ import annotations

import re

import torch

from .collectives import all_gather_tensor, all_reduce, group_rank, group_size

__all__ = [
    "CONFORMER_TP_RULES",
    "infer_shardings",
    "state_shardings",
    "set_shard",
    "set_partial",
    "shard_info",
    "partial_axes",
    "sync_grads",
    "shard_groups",
    "any_group",
    "full_tensor",
    "local_slice",
    "apply_tensor_parallel",
    "full_state",
    "local_piece",
    "load_full_state",
]

# (name regex, dimension of the PyTorch tensor cut over "model", kind);
# first match wins, as in the JAX table
CONFORMER_TP_RULES = (
    (r"(linear_q|linear_k|linear_v|linear_pos)\.weight$", 0, "split"),
    (r"(linear_q|linear_k|linear_v)\.bias$", 0, "split"),
    (r"linear_out\.weight$", 1, "split"),
    (r"feed_forward(_macaron)?\.w_1\.weight$", 0, "split"),
    (r"feed_forward(_macaron)?\.w_1\.bias$", 0, "split"),
    (r"feed_forward(_macaron)?\.w_2\.weight$", 1, "split"),
    # the GLU pairs output i with C + i: a rank holds both halves' slice
    (r"pointwise_conv1\.weight$", 0, "glu"),
    (r"pointwise_conv1\.bias$", 0, "glu"),
    (r"pointwise_conv2\.weight$", 1, "split"),
    (r"(output_layer|ctc_proj)\.weight$", 0, "split"),
    (r"(output_layer|ctc_proj)\.bias$", 0, "split"),
    # MoE expert stacks: the expert dimension (EP)
    (r"feed_forward\.(w1|w2|b1|b2)$", 0, "split"),
)


def infer_shardings(named_shapes, model_size, rules=CONFORMER_TP_RULES):
    """``{name: (dim, kind) or None}`` for ``(name, shape)`` pairs: the first
    rule whose pattern the name matches, kept where ``model_size`` divides
    the dimension (for a ``"glu"`` cut, each half of it), else ``None``
    (replicated)."""
    out = {}
    for name, shape in named_shapes:
        out[name] = None
        for pat, dim, kind in rules:
            if re.search(pat, name):
                size = shape[dim] // 2 if kind == "glu" else shape[dim]
                if len(shape) > dim and model_size > 1 and size % model_size == 0:
                    out[name] = (dim, kind)
                break
    return out


def state_shardings(named_shapes, model_size, zero1=False, rules=CONFORMER_TP_RULES):
    """As :func:`infer_shardings`; with ``zero1`` the optimizer moments are
    cut over ``data`` as well, which ``train.optim.AdamW(zero1_group=...)``
    does on its flat buffers (the dictionary then says so under
    ``"opt_state"``)."""
    params = infer_shardings(named_shapes, model_size, rules)
    return {"params": params, "opt_state": "data" if zero1 else None}


def set_shard(p, axes, dim, kind="split"):
    p.mindaudio_shard = (tuple(axes), dim, kind)
    return p


def set_partial(p, *axes):
    p.mindaudio_partial = tuple(dict.fromkeys(getattr(p, "mindaudio_partial", ()) + axes))
    return p


def shard_info(p):
    return getattr(p, "mindaudio_shard", None)


def partial_axes(p):
    return getattr(p, "mindaudio_partial", ())


def _flat_all_reduce(tensors, group):
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def sync_grads(params, grads, mesh):
    """Gradients of the global loss on every rank: the partial gradients
    summed over their axes, then every gradient averaged over ``data``."""
    if mesh is None or mesh.world_size == 1:
        return grads
    grads = list(grads)
    by_axes = {}
    for i, p in enumerate(params):
        axes = partial_axes(p)
        if axes and mesh.group(*axes) is not None:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        for i, g in zip(idx, _flat_all_reduce([grads[i] for i in idx], mesh.group(*axes))):
            grads[i] = g
    group = mesh.group("data")
    if group is not None:
        n = mesh.size("data")
        grads = [g / n for g in _flat_all_reduce(grads, group)]
    return grads


def shard_groups(params, mesh):
    """Per parameter, the group whose ranks hold its other pieces (``None``
    when this rank holds it whole): the gradient norm adds up over it."""
    if mesh is None:
        return [None] * len(params)
    return [None if shard_info(p) is None else mesh.group(*shard_info(p)[0]) for p in params]


def any_group(params, mesh):
    """The group over which a skip decision must agree: the union of the
    parameters' shard axes (``None`` when nothing is sharded)."""
    axes = set()
    for p in params:
        if shard_info(p) is not None:
            axes.update(shard_info(p)[0])
    return None if mesh is None or not axes else mesh.group(*axes)


def _glu_halves(t, dim):
    a, b = t.chunk(2, dim)
    return a, b


def full_tensor(p, t=None):
    """The whole tensor of which ``t`` (default ``p`` itself) is this rank's
    piece under ``p``'s layout (``t`` has ``p``'s local shape: the
    parameter, its gradient or a moment). Every rank of the shard group must
    call it; a replicated ``p`` returns ``t``."""
    t = p.detach() if t is None else t
    info = shard_info(p)
    if info is None:
        return t
    axes, dim, kind = info
    from .mesh import active_mesh

    group = active_mesh().group(*axes)
    if group is None:
        return t
    if kind == "glu":
        a, b = _glu_halves(t, dim)
        return torch.cat([all_gather_tensor(a.contiguous(), group, dim),
                          all_gather_tensor(b.contiguous(), group, dim)], dim)
    return all_gather_tensor(t.contiguous(), group, dim)


def local_slice(full, dim, kind, group):
    """This rank's piece of ``full`` under a ``(dim, kind)`` cut over ``group``."""
    n, r = group_size(group), group_rank(group)
    if n == 1:
        return full
    if kind == "glu":
        a, b = _glu_halves(full, dim)
        return torch.cat([local_slice(a, dim, "split", group),
                          local_slice(b, dim, "split", group)], dim)
    size = full.shape[dim] // n
    return full.narrow(dim, r * size, size)


def apply_tensor_parallel(model, mesh, rules=CONFORMER_TP_RULES):
    """Cut ``model``'s parameters over ``mesh``'s ``model`` group as
    ``rules`` say and switch its layers to their Megatron forms; build the
    optimizer after this. A layer is cut as a whole or not at all: the
    attention layers only where the group divides their heads as well (a
    head is never split; the JAX table would cut through one). The MoE
    stacks split over the experts. Replicated parameters that a rank then
    uses on its slice only (the rel-pos biases, ``linear_pos``'s bias, the
    conv module's depthwise conv and norm) are marked partial over
    ``model``. Returns ``model``."""
    from ..models.layers import (
        ConvolutionModule,
        MultiHeadedAttention,
        PositionwiseFeedForward,
        RelPositionMultiHeadedAttention,
    )
    from .moe import MoEFeedForward

    group, n = mesh.group("model"), mesh.size("model")
    if group is None:
        return model
    named = dict(model.named_parameters())
    plan = infer_shardings([(k, tuple(p.shape)) for k, p in named.items()], n, rules)

    def cut(prefix, *names):
        for name in names:
            key = f"{prefix}.{name}" if prefix else name
            dim, kind = plan[key]
            p = named[key]
            p.data = local_slice(p.data, dim, kind, group).clone()
            set_shard(p, ("model",), dim, kind)

    def planned(prefix, name):
        return plan.get(f"{prefix}.{name}" if prefix else name) is not None

    for prefix, mod in model.named_modules():
        if isinstance(mod, MoEFeedForward):
            mod.shard(mesh, "model")
        elif isinstance(mod, PositionwiseFeedForward) and planned(prefix, "w_1.weight"):
            cut(prefix, "w_1.weight", "w_1.bias", "w_2.weight")
            mod.tp_group = group
        elif (isinstance(mod, (MultiHeadedAttention, RelPositionMultiHeadedAttention))
              and planned(prefix, "linear_q.weight") and mod.head_num % n == 0):
            cut(prefix, *(f"linear_{x}.{w}" for x in "qkv" for w in ("weight", "bias")),
                "linear_out.weight")
            if isinstance(mod, RelPositionMultiHeadedAttention):
                cut(prefix, "linear_pos.weight")
                for p in (mod.pos_bias_u, mod.pos_bias_v, mod.linear_pos.bias):
                    set_partial(p, "model")
            mod.tp_group = group
        elif isinstance(mod, ConvolutionModule) and planned(prefix, "pointwise_conv1.weight"):
            cut(prefix, "pointwise_conv1.weight", "pointwise_conv1.bias",
                "pointwise_conv2.weight")
            # a batch norm runs on every channel on every rank (its running
            # statistics stay whole); a layer norm on this rank's channels
            used = list(mod.depthwise_conv.parameters())
            if isinstance(mod.norm, torch.nn.LayerNorm):
                used += list(mod.norm.parameters())
            for p in used:
                set_partial(p, "model")
            mod.tp_group = group
        elif (isinstance(mod, torch.nn.Linear) and prefix.endswith(("output_layer", "ctc_proj"))
              and planned(prefix, "weight")):
            cut(prefix, "weight", "bias")
            mod.tp_group = group
    return model


def full_state(model):
    """``{name: whole tensor}`` of ``model``'s parameters (the pieces of a
    sharded one gathered; every rank of its group must call this)."""
    return {k: full_tensor(p) for k, p in model.named_parameters()}


def local_piece(p, full):
    """This rank's piece of the whole tensor ``full`` under ``p``'s layout
    (``full`` itself for a replicated ``p``): the inverse of
    :func:`full_tensor`."""
    info = shard_info(p)
    full = torch.as_tensor(full)
    if info is None:
        return full
    from .mesh import active_mesh

    return local_slice(full, info[1], info[2], active_mesh().group(*info[0]))


@torch.no_grad()
def load_full_state(model, params):
    """Copy whole tensors ``{name: tensor}`` into ``model``'s parameters,
    each rank taking its piece of a sharded one."""
    mine = dict(model.named_parameters())
    if set(mine) != set(params):
        raise KeyError(f"params differ from the model's: {sorted(set(mine) ^ set(params))[:8]}")
    for k, p in mine.items():
        p.copy_(local_piece(p, params[k]))

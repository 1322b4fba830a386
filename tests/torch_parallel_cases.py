"""What the ``test_torch_parallel_*`` tests run on each rank of a gloo group
(``torch_dist.run_ranks``): functions of the port only (no JAX), returning
tensors and numbers for the tests to hold against the JAX package."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mindaudio_torch.parallel import collectives as C
from mindaudio_torch.parallel.mesh import make_mesh, shard_batch


def _rank():
    return dist.get_rank()


def collectives_case(seed):
    """Each differentiable collective forward and backward on inputs that
    differ per rank: ``{name: (output, gradient of the input)}`` for
    ``sum(output * weight)`` with a weight that also differs per rank."""
    mesh = make_mesh(data=dist.get_world_size())
    g, r, n = mesh.group("data"), _rank(), dist.get_world_size()
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.standard_normal((n, 4, 6)).astype(np.float64))
    ws = torch.from_numpy(rng.standard_normal((n, 4 * n, 6 * n)).astype(np.float64))
    out = {}

    def run(name, fn, x, w_shape):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        w = ws[r][tuple(slice(0, s) for s in w_shape(y))]
        (gx,) = torch.autograd.grad((y * w).sum(), x)
        out[name] = (y.detach(), gx)

    same = lambda y: y.shape  # noqa: E731
    run("all_reduce_sum", lambda x: C.all_reduce_sum(x, g), xs[r], same)
    run("reduce_from", lambda x: C.reduce_from(x, g), xs[r], same)
    run("copy_to", lambda x: C.copy_to(x, g), xs[r], same)
    run("all_gather_slice", lambda x: C.all_gather(x, g, dim=1, grad="slice"), xs[r], same)
    run("all_gather_sum", lambda x: C.all_gather(x, g, dim=1, grad="sum"), xs[r], same)
    run("scatter", lambda x: C.scatter(x, g, dim=0), xs[0], same)
    run("all_to_all", lambda x: C.all_to_all(x, g, split_dim=0, concat_dim=1), xs[r], same)
    run("permute_ring", lambda x: C.permute(x, g, 1, wrap=True), xs[r], same)
    run("permute_chain", lambda x: C.permute(x, g, 1, wrap=False), xs[r], same)
    run("broadcast", lambda x: C.broadcast(x, g, n - 1), xs[r], same)
    run("broadcast_grad", lambda x: C.broadcast_grad(x, g, 0), xs[r], same)
    out["inputs"], out["weights"] = xs, ws
    out["mesh"] = (mesh.coords, {a: sorted(mesh.ranks(a)) for a in mesh.shape})
    return out


def mesh_case(shape):
    """The coordinates and group members of each rank of a mesh."""
    mesh = make_mesh(**shape)
    groups = {}
    for axes in (("data",), ("model",), ("seq",), ("pipe",), ("model", "pipe"), ("data", "seq")):
        grp = mesh.group(*axes)
        groups[axes] = None if grp is None else sorted(dist.get_process_group_ranks(grp))
    return mesh.coords, groups


def _asr(cfg, state, mesh=None, **kw):
    from mindaudio_torch.models.asr_model import ASRModel

    model = ASRModel(**cfg, **kw, device="cpu")
    model.load_state_dict(state, strict=False)
    return model


def conformer_dp_case(cfg, state, opt_state, batches, zero1_runs=(False, True), mu_dtype=None):
    """Steps of the Conformer at world size n on this rank's rows of each
    global batch, replicated moments and ZeRO-1; returns per run the
    metrics of every step, the final parameters, the AdamW state (whole)
    and the bytes of this rank's moments."""
    from mindaudio_torch.scheduler.schedules import asr_warmup_lr
    from mindaudio_torch.train.optim import AdamW
    from mindaudio_torch.train.state import make_train_step

    mesh = make_mesh()
    out = {}
    for zero1 in zero1_runs:
        model = _asr(cfg, state).eval()
        opt = AdamW(model.named_parameters(), asr_warmup_lr(2e-3, 5), weight_decay=1e-2,
                    mu_dtype=mu_dtype, zero1_group=mesh.group("data") if zero1 else None)
        opt.load_state_dict(opt_state)
        step = make_train_step(model, opt, grad_clip_norm=5.0, mesh=mesh)
        metrics = [{k: float(v) for k, v in step(shard_batch(mesh, b)).items()}
                   for b in batches]
        out[zero1] = {"metrics": metrics,
                      "params": {k: v.detach().clone() for k, v in model.named_parameters()},
                      "opt": opt.state_dict(),
                      "moment_bytes": opt._mu.numel() * opt._mu.element_size()
                      + opt._nu.numel() * opt._nu.element_size()}
    return out


def ds2_dp_case(cfg, state, batches):
    """DeepSpeech2 train steps (features pinned) at world size n: per step
    the metrics, then the parameters and the running statistics."""
    from mindaudio_torch.loss.ctc_loss import ctc_loss
    from mindaudio_torch.models.deepspeech2 import DeepSpeechModel
    from mindaudio_torch.train.optim import AdamW
    from mindaudio_torch.train.state import make_train_step

    mesh = make_mesh()
    model = DeepSpeechModel(**cfg, device="cpu")
    model.load_state_dict(state)
    model.train()
    opt = AdamW(model.named_parameters(), 1e-3, weight_decay=1e-2)

    def objective(m, b):
        logits, lens = m(b["feats"], b["feat_lens"])
        return ctc_loss(logits, lens, b["labels"], b["label_lens"], blank_id=28), {}

    step = make_train_step(model, opt, grad_clip_norm=5.0, loss_fn=objective, mesh=mesh)
    metrics = [{k: float(v) for k, v in step(shard_batch(mesh, b)).items()} for b in batches]
    return {"metrics": metrics, "state": {k: v.detach().clone()
                                          for k, v in model.state_dict().items()}}


def recipe_case(module, argv, patches=()):
    """``module.main(argv)`` on this rank (a recipe's training entry point),
    after setting ``(module, attribute, value)`` in ``patches``; the
    returned dict without its modules."""
    import importlib

    for mod, attr, value in patches:
        setattr(importlib.import_module(mod), attr, value)
    out = importlib.import_module(module).main(list(argv))
    return {k: v for k, v in out.items() if not isinstance(v, torch.nn.Module)}


def moe_case(state, x, mask, kwargs, shape):
    """The MoE layer over a mesh of ``shape``: this rank's rows (its data
    index) forward and backward of ``mean(y^2) + 0.01 * aux``; returns the
    output rows, the aux share and the gradients of the global loss (whole
    tensors)."""
    from mindaudio_torch.parallel.moe import MoEFeedForward
    from mindaudio_torch.parallel.shardings import full_tensor, sync_grads

    mesh = make_mesh(**shape)
    layer = MoEFeedForward(**kwargs)
    layer.load_state_dict(state)
    layer.shard(mesh)
    rows = shard_batch(mesh, {"x": x, "mask": mask})
    xr = rows["x"].clone().requires_grad_(True)
    y = layer(xr, rows["mask"])
    loss = y.square().mean() + 0.01 * layer.aux_loss
    params = list(layer.parameters())
    grads = torch.autograd.grad(loss, params + [xr])
    grads = sync_grads(params, list(grads[:-1]), mesh) + [grads[-1]]
    names = [n for n, _ in layer.named_parameters()]
    return {"y": y.detach(), "aux": layer.aux_loss.detach(),
            "grads": {n: full_tensor(p, g) for n, p, g in zip(names, params, grads)},
            "x_grad": grads[-1], "coords": mesh.coords}


def sp_attention_case(q, k, v, valid, variant, scale, weight):
    """``sequence_parallel_attention`` over the ``seq`` group on whole
    tensors: the output and the gradients of ``sum(out * weight)``."""
    from mindaudio_torch.parallel.ring_attention import sequence_parallel_attention

    mesh = make_mesh(data=1, seq=dist.get_world_size())
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = sequence_parallel_attention(q, k, v, mesh.group("seq"), kv_valid=valid,
                                      variant=variant, scale=scale)
    grads = torch.autograd.grad((out * weight).sum(), (q, k, v))
    return out.detach(), grads


def _encoder(cfg, state, **kw):
    from mindaudio_torch.models.conformer import ConformerEncoder

    enc = ConformerEncoder(**cfg, **kw)
    enc.load_state_dict(state, strict=False)
    return enc


def sp_encoder_case(cfg, state, xs, xs_lens, variant):
    """The encoder with its blocks sequence parallel over all the ranks:
    the float32 output and mask, and in float64 the gradients of
    ``sum(out^2 * valid)`` after the train step's gradient sync beside
    those of the dense encoder."""
    from mindaudio_torch.parallel.shardings import sync_grads

    mesh = make_mesh(data=1, seq=dist.get_world_size())
    out32, mask = _encoder(cfg, state, sp_mesh=mesh, sp_variant=variant)(xs, xs_lens)
    grads = {}
    for sp in (mesh, None):
        enc = _encoder(cfg, state, sp_mesh=sp, sp_variant=variant).double()
        out, m = enc(xs.double(), xs_lens)
        loss = (out.square() * m[:, 0, :, None]).sum()
        names, params = zip(*enc.named_parameters())
        g = torch.autograd.grad(loss, params)
        grads[sp is None] = dict(zip(names, sync_grads(list(params), g, mesh) if sp else g))
    return out32.detach(), mask, grads[False], grads[True]


def sp_raises_case(cfg, state, xs, xs_lens):
    """The two refusals of the sequence-parallel encoder, and Ulysses' of a
    head count the group does not divide: their messages."""
    from mindaudio_torch.parallel.ring_attention import ulysses_attention

    mesh = make_mesh(data=1, seq=dist.get_world_size())
    msgs = []
    for kw, x in ((dict(use_dynamic_chunk=True), xs), (dict(static_chunk_size=4), xs),
                  ({}, xs[:, :-4])):
        try:
            _encoder(cfg, state, sp_mesh=mesh, **kw)(x, torch.clamp_max(xs_lens, x.shape[1]))
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    h = dist.get_world_size() + 1
    try:
        t = torch.zeros(1, h, 4, 2)
        ulysses_attention(t, t, t, mesh.group("seq"))
        msgs.append(None)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def pp_encoder_case(cfg, state, xs, xs_lens, weight, shape, n_micro):
    """The encoder's blocks as a GPipe pipeline over ``shape``'s ``pipe``
    group (this rank's rows of the batch over ``data``): the float32 output
    rows, and in float64 the synced gradients of ``sum(out * weight)`` over
    the rows beside the sequential encoder's on the whole batch (divided by
    the data size: the train step averages the ranks' gradients)."""
    from mindaudio_torch.parallel.shardings import sync_grads

    mesh = make_mesh(**shape)
    rows = shard_batch(mesh, {"xs": xs, "lens": xs_lens, "w": weight})
    kw = dict(pipeline_mesh=mesh, pipeline_microbatches=n_micro)
    out32, _ = _encoder(cfg, state, **kw)(rows["xs"], rows["lens"])
    grads = {}
    for piped in (True, False):
        enc = _encoder(cfg, state, **(kw if piped else {})).double()
        x, lens, w = (rows["xs"], rows["lens"], rows["w"]) if piped else (xs, xs_lens, weight)
        out, m = enc(x.double(), lens)
        loss = (out * w.double() * m[:, 0, :, None]).sum()
        names, params = zip(*enc.named_parameters())
        # a stage's rank leaves the other stages' blocks unused (zero)
        g = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        g = sync_grads(list(params), g, mesh) if piped else [t / mesh.size("data") for t in g]
        grads[piped] = dict(zip(names, g))
    return out32.detach(), grads[True], grads[False], mesh.coords


def tp_step_case(cfg, state, opt_state, batch, shape):
    """One train step of the Conformer with Megatron tensor parallelism over
    ``shape``'s ``model`` axis (and data parallelism over ``data``): the
    metrics, the whole parameters after the step, which parameters were
    cut, and the loss and whole gradients of the first forward."""
    from mindaudio_torch.parallel.shardings import (
        apply_tensor_parallel,
        full_state,
        full_tensor,
        local_piece,
        shard_info,
        sync_grads,
    )
    from mindaudio_torch.scheduler.schedules import asr_warmup_lr
    from mindaudio_torch.train.optim import AdamW
    from mindaudio_torch.train.state import make_train_step

    mesh = make_mesh(**shape)
    model = apply_tensor_parallel(_asr(cfg, state).eval(), mesh)
    cut = {k: shard_info(p)[1:] for k, p in model.named_parameters() if shard_info(p)}
    rows = shard_batch(mesh, batch)
    loss, _ = model(rows)
    params = list(model.parameters())
    grads = sync_grads(params, torch.autograd.grad(loss, params), mesh)
    names = [n for n, _ in model.named_parameters()]
    whole = {n: full_tensor(p, g) for n, p, g in zip(names, params, grads)}
    opt = AdamW(model.named_parameters(), asr_warmup_lr(2e-3, 5), weight_decay=1e-2)
    named = dict(model.named_parameters())
    local = {key: {k: local_piece(named[k], t) for k, t in opt_state[key].items()}
             for key in ("mu", "nu")}
    opt.load_state_dict({"count": opt_state["count"], **local})
    metrics = make_train_step(model, opt, grad_clip_norm=5.0, mesh=mesh)(rows)
    return ({k: float(v) for k, v in metrics.items()}, full_state(model), cut,
            float(loss), whole)


def ds2_recipe_step_case(argv, state, opt_state, batch):
    """One step of the DeepSpeech2 recipe's ``make_step`` over the data
    group (this rank's rows), from ``state`` and ``opt_state``: the metrics,
    the parameters and running statistics, and the AdamW moments (whole)."""
    from mindaudio_torch.recipes.deepspeech2 import train as ttrain

    mesh = make_mesh()
    cfg, _ = ttrain.parse_args(list(argv) + ["--device", "cpu"])
    model = ttrain.build_model(cfg, "cpu")
    model.load_state_dict(state, strict=True)
    model.train()
    opt = ttrain.make_optimizer(cfg, model, mesh)
    opt.load_state_dict(opt_state)
    metrics = ttrain.make_step(cfg, model, opt, mesh)(shard_batch(mesh, batch))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().clone() for k, v in model.state_dict().items()}, opt.state_dict())

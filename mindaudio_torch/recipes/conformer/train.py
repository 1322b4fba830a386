"""Conformer AISHELL-1 training on one NVIDIA GPU (port of
``examples/conformer/train.py``).

A step is the fbank with dither, SpecAugment, CMVN, the encoder and decoder,
the hybrid CTC/attention loss (the CTC through the port's CUDA kernels),
the backward, global-norm clipping and AdamW with a bf16 first moment, under
bf16 autocast (``train/state.make_train_step``). Collate runs in a worker
thread and its batch is copied to the card on a side stream while the
previous step runs. Every ``save_every_steps`` the dev loss is measured and
a checkpoint saved with it; ``--train.resume true`` continues from the latest
checkpoint at its global step.

The parallel settings of the JAX recipe run over ``torch.distributed``
(``parallel/``), one process a GPU: the ranks left over by
``train.mesh_model_axis`` (Megatron tensor parallelism, and the MoE experts
when ``model.moe_experts > 0``) and ``train.pipeline_stages`` (a GPipe
pipeline of the encoder blocks with ``train.pipeline_microbatches``) form the
``data`` axis, over which each rank collates its rows of the global batch;
``train.zero1_optimizer`` shards the AdamW moments over it. Only rank 0
logs and writes checkpoints; a checkpoint holds whole tensors, so it resumes
at any world size.

Usage::

    python -m mindaudio_torch.recipes.conformer.train --config conformer.yaml \\
        [--device cuda] [--optim.epochs 1] [--train.max_steps 100] ...
    torchrun --nproc_per_node 4 -m mindaudio_torch.recipes.conformer.train \\
        --train.mesh_model_axis 2 --train.zero1_optimizer true ...

``--config`` defaults to the ``conformer.yaml`` beside this file and
``--device`` to ``cuda``; the CPU runs only when asked for.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ... import resolve_device
from ...models.asr_model import ASRModel
from ...ops.specaugment import spec_augment
from ...ops.spectral import kaldi_fbank
from ...scheduler.schedules import asr_warmup_lr
from ...parallel.collectives import all_reduce
from ...parallel.mesh import active_mesh, barrier, init_mesh, make_mesh
from ...parallel.moe import moe_aux_losses
from ...parallel.shardings import (
    apply_tensor_parallel,
    full_state,
    full_tensor,
    load_full_state,
    local_piece,
)
from ...train.checkpoint import CheckpointManager, list_steps, restore_checkpoint
from ...train.config import get_config
from ...train.log import get_logger
from ...train.optim import AdamW
from ...train.prefetch import ToDevice, prefetch
from ...train.state import make_train_step
from ...utils.cmvn import load_cmvn
from ...utils.tokenizer import CharTokenizer
from .dataset import FRAME_LEN, FRAME_SHIFT, batch_iterator, read_manifest

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conformer.yaml")
DROPOUT_SEED, FEATURES_SEED, INIT_SEED = 42, 0, 0


def parse_args(argv=None):
    """``(config, device)``: the YAML merged with the ``--section.key``
    overrides of ``argv`` (``sys.argv[1:]`` when None), and ``--device``."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args(argv)
    return get_config(args.config, argv), resolve_device(args.device)


def build_mesh(cfg, device, training=True):
    """Join ``torchrun``'s group and build the mesh the config asks for:
    ``(this rank's device, mesh)``. Decoding (``training=False``) runs on one
    process."""
    if not training:
        return device, make_mesh()
    return init_mesh(device, model=int(cfg.train.get("mesh_model_axis", 1)),
                     pipe=int(cfg.train.get("pipeline_stages", 1)))


def build_tokenizer(cfg):
    """The vocabulary file, or one built from the train transcripts and saved."""
    vocab_file = cfg.data.vocab_file
    if os.path.exists(vocab_file):
        return CharTokenizer.from_file(vocab_file)
    tok = CharTokenizer.from_transcripts(u.text for u in read_manifest(cfg.data.train_csv))
    os.makedirs(os.path.dirname(vocab_file) or ".", exist_ok=True)
    tok.save(vocab_file)
    return tok


def build_model(cfg, vocab_size, device, training=True, mesh=None):
    """The ``ASRModel`` of the config on ``device``, with the CMVN stats of
    ``data.cmvn_file`` when it exists; weights from :data:`INIT_SEED`, drawn
    whole and then cut over ``mesh`` (tensor and expert parallelism over its
    ``model`` axis, the encoder blocks pipelined over ``pipe``), so every
    layout trains the same model. ``training=False`` (decoding) keeps the MoE
    blocks and drops the pipeline, as the JAX recipe's ``build_model``."""
    moe_experts = int(cfg.model.get("moe_experts", 0))
    capacity = cfg.model.get("moe_capacity_factor", 1.25)  # None: dropless
    pipelined = training and mesh is not None and mesh.size("pipe") > 1
    cmvn_mean = cmvn_istd = None
    if os.path.exists(cfg.data.cmvn_file):
        cmvn_mean, cmvn_istd = load_cmvn(cfg.data.cmvn_file)
    model = ASRModel(
        vocab_size=vocab_size,
        input_dim=cfg.model.input_dim,
        d_model=cfg.model.d_model,
        head_num=cfg.model.head_num,
        ffn_dim=cfg.model.ffn_dim,
        num_encoder_layers=cfg.model.num_encoder_layers,
        num_decoder_layers=cfg.model.num_decoder_layers,
        dropout_rate=cfg.model.dropout_rate,
        attention_dropout_rate=float(cfg.model.get("attention_dropout_rate", 0.0)),
        kernel_size=cfg.model.kernel_size,
        ctc_weight=cfg.model.ctc_weight,
        lsm_weight=cfg.model.lsm_weight,
        use_dynamic_chunk=bool(cfg.model.get("use_dynamic_chunk", False)),
        causal_conv=bool(cfg.model.get("causal_conv", False)),
        remat=bool(cfg.model.get("remat", False)),
        int8_ffn=bool(cfg.model.get("int8_ffn", False)),
        moe_experts=moe_experts,
        moe_top_k=int(cfg.model.get("moe_top_k", 2)),
        moe_capacity_factor=None if capacity is None else float(capacity),
        moe_macaron=bool(cfg.model.get("moe_macaron", False)),
        pipeline_mesh=mesh if pipelined else None,
        pipeline_microbatches=int(cfg.train.get("pipeline_microbatches", 4)),
        cmvn_mean=cmvn_mean,
        cmvn_istd=cmvn_istd,
        device=device,
    )
    model.reset_parameters(torch.Generator(device=device).manual_seed(INIT_SEED))
    if mesh is not None:
        apply_tensor_parallel(model, mesh)
    return model


def load_params(model, params):
    """Copy a checkpoint's ``params`` (the model's named parameters, whole;
    the CMVN buffers come from the config) into ``model``, each rank taking
    its piece of a sharded one; the names must match."""
    load_full_state(model, params)


def device_features(cfg, wavs, wav_lens, generator=None, train=True):
    """Fbank on the batch's device; in training with dither and (when the
    config asks) SpecAugment, both drawn from ``generator``."""
    feats = kaldi_fbank(
        wavs,
        num_mel_bins=cfg.features.num_mel_bins,
        frame_length_ms=cfg.features.frame_length_ms,
        frame_shift_ms=cfg.features.frame_shift_ms,
        dither=cfg.features.dither if train else 0.0,
        generator=generator if train else None,
        device=wavs.device,
    )
    if train and cfg.features.spec_aug:
        feats = spec_augment(feats, num_t_mask=cfg.features.num_t_mask,
                             num_f_mask=cfg.features.num_f_mask, max_t=cfg.features.max_t,
                             max_f=cfg.features.max_f, generator=generator)
    return feats, 1 + (wav_lens - FRAME_LEN) // FRAME_SHIFT


def make_optimizer(cfg, model, mesh=None):
    """AdamW with the config's schedule and first-moment dtype; its moments
    sharded over ``mesh``'s ``data`` group with ``train.zero1_optimizer``."""
    mu_dtype = {"bfloat16": torch.bfloat16, "float32": None}[
        str(cfg.optim.get("mu_dtype", "bfloat16"))]
    zero1 = bool(cfg.train.get("zero1_optimizer", False)) and mesh is not None
    return AdamW(model.named_parameters(), asr_warmup_lr(cfg.optim.lr, cfg.optim.warmup_steps),
                 weight_decay=cfg.optim.weight_decay, mu_dtype=mu_dtype,
                 zero1_group=mesh.group("data") if zero1 else None)


def hybrid_loss(cfg, chunks=None):
    """``(model, batch) -> (loss, metrics)``: the model's hybrid loss, plus
    ``moe_aux_weight`` times the mean of the MoE blocks' load-balance losses
    (reported as ``moe_aux``), as the JAX recipe adds the sown ones; at
    weight 0, or without MoE blocks, nothing is computed or looked for."""
    weight = float(cfg.model.get("moe_aux_weight", 0.01))
    weighed = weight > 0 and int(cfg.model.get("moe_experts", 0)) > 0

    def loss_fn(model, batch):
        loss, metrics = model(batch, chunk_generator=chunks)
        aux = moe_aux_losses(model) if weighed else None
        if aux is not None and aux.numel():
            metrics["moe_aux"] = aux.mean()
            loss = loss + weight * metrics["moe_aux"]
        return loss, metrics

    return loss_fn


def make_step(cfg, model, optimizer, generators, mesh=None):
    """The train step (``batch -> metrics``, device scalars; this rank's rows
    of the global batch over ``mesh``) and the eval step (``batch -> (loss,
    metrics)``: no dither, no SpecAugment, the model in ``eval()`` and back
    in ``train()`` after)."""
    dtype = torch.bfloat16 if cfg.optim.bf16 else None
    # a dynamic-chunk model samples its chunk masks from the features' generator
    chunks = generators["features"] if cfg.model.get("use_dynamic_chunk", False) else None
    step = make_train_step(
        model, optimizer,
        lambda b: device_features(cfg, b["wavs"], b["wav_lens"], generators["features"]),
        grad_clip_norm=cfg.optim.grad_clip, autocast_dtype=dtype,
        loss_fn=hybrid_loss(cfg, chunks), mesh=mesh)

    @torch.no_grad()
    def eval_step(batch):
        feats, feat_lens = device_features(cfg, batch["wavs"], batch["wav_lens"], train=False)
        model.eval()
        try:
            with torch.autocast(batch["wavs"].device.type, dtype=dtype, enabled=dtype is not None):
                loss, metrics = hybrid_loss(cfg)(model, dict(batch, feats=feats,
                                                             feat_lens=feat_lens))
        finally:
            model.train()
        return loss, metrics

    return step, eval_step


def checkpoint_state(model, optimizer, generators, step):
    """What a checkpoint holds: params, AdamW state (``count``, ``mu``,
    ``nu``), the global step ``step`` (the batches consumed; AdamW's count
    leaves out skipped ones) and the generators' states. Every tensor is
    whole (the ZeRO-1 slices and the tensor-parallel pieces gathered), so
    every rank calls this; the generators are this rank's (rank 0's are
    saved)."""
    opt = optimizer.state_dict()
    named = dict(model.named_parameters())
    for key in ("mu", "nu"):
        opt[key] = {k: full_tensor(named[k], t) for k, t in opt[key].items()}
    return {"params": full_state(model), "opt_state": opt,
            "step": torch.tensor(step, dtype=torch.int32),
            "rng": {k: g.get_state() for k, g in generators.items()}}


def restore_state(ckpt, model, optimizer, generators):
    """Load a :func:`checkpoint_state` (written at any world size) on the
    active mesh; returns its global step. The generators take the saved
    states on the ranks of data index 0, and states drawn from them and the
    index elsewhere, so that the ranks' dropout and augmentation differ."""
    mesh = active_mesh()
    load_params(model, ckpt["params"])
    named = dict(model.named_parameters())
    opt = dict(ckpt["opt_state"])
    for key in ("mu", "nu"):
        opt[key] = {k: local_piece(named[k], t) for k, t in opt[key].items()}
    optimizer.load_state_dict(opt)
    index = 0 if mesh is None else mesh.index("data")
    for k, g in generators.items():
        g.set_state(ckpt["rng"][k])
        if index:
            seed = torch.randint(0, 2**62, (), generator=g, device=g.device).item()
            g.manual_seed(seed + index)
    return int(ckpt["step"])


def make_generators(device, mesh):
    """The dropout and feature generators: the recipe's seeds plus the data
    index, so that the ranks of one ``data`` index (which hold the same
    rows) draw alike and the others apart."""
    index = mesh.index("data")
    return {"dropout": torch.Generator(device=device).manual_seed(DROPOUT_SEED + index),
            "features": torch.Generator(device=device).manual_seed(FEATURES_SEED + index)}


def main(argv=None):
    """Train as the config says. Returns ``{"start_step", "first_lr", "steps",
    "final_step", "window_ms", "dev_losses", "losses"}``: the global step it
    started from and the learning rate of its first step, the steps it took,
    ms per step of each log window (host clock over the ``log_every_steps``
    steps before a log, which ends in the metrics' read-back, with no eval or
    save inside), ``{global step: dev loss}`` of its evaluations and the
    train loss of each logged step."""
    cfg, device = parse_args(argv)
    device, mesh = build_mesh(cfg, device)
    logger = get_logger("conformer_torch")
    if mesh.rank == 0:  # the vocabulary file is written once
        tokenizer = build_tokenizer(cfg)
    barrier()
    if mesh.rank != 0:
        tokenizer = build_tokenizer(cfg)
    logger.info("vocab: %d, device: %s, mesh: %s", tokenizer.vocab_size, device, mesh.shape)
    model = build_model(cfg, tokenizer.vocab_size, device, mesh=mesh).train()
    generators = make_generators(device, mesh)
    model.set_dropout_generator(generators["dropout"])
    optimizer = make_optimizer(cfg, model, mesh)

    # resume: params, AdamW state, step and generators from the latest
    # checkpoint; the schedule reads AdamW's count, so it continues there.
    # Checkpoints are named (and max_steps counted) by the global step, so a
    # resumed run neither renames nor overwrites the steps before it
    start_step = 0
    if bool(cfg.train.get("resume", False)) and list_steps(cfg.train.ckpt_dir):
        step_dir = list_steps(cfg.train.ckpt_dir)[-1]
        logger.info("restoring from %s (step %d)", cfg.train.ckpt_dir, step_dir)
        start_step = restore_state(restore_checkpoint(cfg.train.ckpt_dir, step_dir), model,
                                   optimizer, generators)
    n_params = sum(full_tensor(p).numel() for p in model.parameters())
    logger.info("params: %.1fM", n_params / 1e6)
    step_fn, eval_fn = make_step(cfg, model, optimizer, generators, mesh)
    to_device = ToDevice(device)
    # every batch splits into the data axis (and into the microbatches of a pipeline)
    multiple = mesh.size("data") * (int(cfg.train.get("pipeline_microbatches", 4))
                                    if mesh.size("pipe") > 1 else 1)
    loader = dict(batch_factor=float(cfg.data.batch_factor),
                  max_label_len=int(cfg.data.max_label_len),
                  frame_bucket_limit=cfg.data.get("frame_bucket_limit"),
                  batch_bucket_limit=cfg.data.get("batch_bucket_limit"),
                  rank=mesh.index("data"), world_size=mesh.size("data"),
                  batch_multiple=multiple)
    data = mesh.group("data")

    def eval_loss(max_batches=20):
        """Mean dev loss of the global batches over at most ``max_batches``
        batches (inf if the dev set fills no batch): the score that picks
        checkpoints to average."""
        losses = []
        for item in batch_iterator(cfg.data.dev_csv, tokenizer, epochs=1,
                                   speed_perturb=False, **loader):
            _, _, staged = to_device(item)
            losses.append(eval_fn(to_device.ready(staged))[0].float())
            if len(losses) >= max_batches:
                break
        if not losses:
            return float("inf")
        return float(all_reduce(torch.stack(losses), data).mean()) / mesh.size("data")

    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep_max=int(cfg.train.keep_checkpoint_max))
    max_steps = int(cfg.train.max_steps)
    log_every, save_every = int(cfg.train.log_every_steps), int(cfg.train.save_every_steps)
    it = batch_iterator(cfg.data.train_csv, tokenizer, epochs=int(cfg.optim.epochs),
                        speed_perturb=bool(cfg.data.speed_perturb), **loader)

    first_lr = float(optimizer.lr(optimizer.count))
    step_count, dev_losses, window_ms, losses = 0, {}, [], []
    metrics = step_fn(to_device.ready(to_device(next(it))[2]))
    step_count += 1
    window = (time.perf_counter(), step_count)
    for epoch, frames, staged in prefetch(it, size=2, transform=to_device):
        metrics = step_fn(to_device.ready(staged))
        step_count += 1
        gstep = start_step + step_count
        if step_count % log_every == 0:  # the only reads of a step's metrics
            m = {k: float(v) for k, v in metrics.items()}
            losses.append(m["loss"])
            if step_count - window[1] == log_every:
                window_ms.append(1e3 * (time.perf_counter() - window[0]) / log_every)
            logger.info("epoch %d step %d bucket %d loss %.4f (att %.4f ctc %.4f acc %.3f) "
                        "lr %.3e %s", epoch, gstep, frames, m["loss"], m["loss_att"],
                        m["loss_ctc"], m["acc_att"], float(optimizer.lr(optimizer.count - 1)),
                        f"{window_ms[-1]:.1f} ms/step" if window_ms else "")
            window = (time.perf_counter(), step_count)
        if step_count % save_every == 0:
            dev_losses[gstep] = eval_loss()
            logger.info("eval @ step %d: dev loss %.4f", gstep, dev_losses[gstep])
            ckpt.save(checkpoint_state(model, optimizer, generators, gstep), gstep,
                      eval_metric=dev_losses[gstep])
            barrier()
            window = (time.perf_counter(), step_count)
        if max_steps and gstep >= max_steps:
            break
    final = start_step + step_count
    ckpt.save(checkpoint_state(model, optimizer, generators, final), final)
    barrier()
    logger.info("done: %d steps (global %d)", step_count, final)
    return {"start_step": start_step, "first_lr": first_lr, "steps": step_count,
            "final_step": final, "window_ms": window_ms, "dev_losses": dev_losses,
            "losses": losses}


if __name__ == "__main__":
    main()

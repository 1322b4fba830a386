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

Usage::

    python -m mindaudio_torch.recipes.conformer.train --config conformer.yaml \\
        [--device cuda] [--optim.epochs 1] [--train.max_steps 100] ...

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


def check_supported(cfg, training=True):
    """Raise ``NotImplementedError`` for a setting the port cannot honour,
    naming where the ROADMAP tracks it: nothing else is run in its place."""
    dist = torch.distributed
    unsupported = {
        "model.moe_experts > 0": (int(cfg.model.get("moe_experts", 0)) > 0, "queue 1 item 8"),
    }
    if training:
        unsupported.update({
            "train.mesh_model_axis > 1": (int(cfg.train.get("mesh_model_axis", 1)) > 1,
                                          "queue 1 item 8"),
            "train.pipeline_stages > 1": (int(cfg.train.get("pipeline_stages", 1)) > 1,
                                          "queue 1 item 8"),
            "train.zero1_optimizer": (bool(cfg.train.get("zero1_optimizer", False)),
                                      "queue 1 item 8"),
            "data parallel over several processes": (
                dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1,
                "queue 1 item 8"),
        })
    for name, (asked, item) in unsupported.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported to PyTorch yet (ROADMAP {item})")


def build_tokenizer(cfg):
    """The vocabulary file, or one built from the train transcripts and saved."""
    vocab_file = cfg.data.vocab_file
    if os.path.exists(vocab_file):
        return CharTokenizer.from_file(vocab_file)
    tok = CharTokenizer.from_transcripts(u.text for u in read_manifest(cfg.data.train_csv))
    os.makedirs(os.path.dirname(vocab_file) or ".", exist_ok=True)
    tok.save(vocab_file)
    return tok


def build_model(cfg, vocab_size, device, training=True):
    """The ``ASRModel`` of the config on ``device``, with the CMVN stats of
    ``data.cmvn_file`` when it exists; weights from :data:`INIT_SEED`."""
    check_supported(cfg, training)
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
        cmvn_mean=cmvn_mean,
        cmvn_istd=cmvn_istd,
        device=device,
    )
    return model.reset_parameters(torch.Generator(device=device).manual_seed(INIT_SEED))


@torch.no_grad()
def load_params(model, params):
    """Copy a checkpoint's ``params`` (the model's named parameters; the CMVN
    buffers come from the config) into ``model``; the names must match."""
    mine = dict(model.named_parameters())
    if set(mine) != set(params):
        raise KeyError(f"checkpoint params differ from the model's: "
                       f"{sorted(set(mine) ^ set(params))[:8]}")
    for name, p in mine.items():
        p.copy_(params[name])


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


def make_optimizer(cfg, model):
    mu_dtype = {"bfloat16": torch.bfloat16, "float32": None}[
        str(cfg.optim.get("mu_dtype", "bfloat16"))]
    return AdamW(model.named_parameters(), asr_warmup_lr(cfg.optim.lr, cfg.optim.warmup_steps),
                 weight_decay=cfg.optim.weight_decay, mu_dtype=mu_dtype)


def make_step(cfg, model, optimizer, generators):
    """The train step (``batch -> metrics``, device scalars) and the eval
    step (``batch -> (loss, metrics)``: no dither, no SpecAugment, the model
    in ``eval()`` and back in ``train()`` after)."""
    dtype = torch.bfloat16 if cfg.optim.bf16 else None
    # a dynamic-chunk model samples its chunk masks from the features' generator
    chunks = generators["features"] if cfg.model.get("use_dynamic_chunk", False) else None
    step = make_train_step(
        model, optimizer,
        lambda b: device_features(cfg, b["wavs"], b["wav_lens"], generators["features"]),
        grad_clip_norm=cfg.optim.grad_clip, autocast_dtype=dtype,
        loss_fn=lambda m, b: m(b, chunk_generator=chunks))

    @torch.no_grad()
    def eval_step(batch):
        feats, feat_lens = device_features(cfg, batch["wavs"], batch["wav_lens"], train=False)
        model.eval()
        try:
            with torch.autocast(batch["wavs"].device.type, dtype=dtype, enabled=dtype is not None):
                loss, metrics = model(dict(batch, feats=feats, feat_lens=feat_lens))
        finally:
            model.train()
        return loss, metrics

    return step, eval_step


def checkpoint_state(model, optimizer, generators, step):
    """What a checkpoint holds: params, AdamW state (``count``, ``mu``,
    ``nu``), the global step ``step`` (the batches consumed; AdamW's count
    leaves out skipped ones) and the generators' states."""
    return {"params": dict(model.named_parameters()), "opt_state": optimizer.state_dict(),
            "step": torch.tensor(step, dtype=torch.int32),
            "rng": {k: g.get_state() for k, g in generators.items()}}


def restore_state(ckpt, model, optimizer, generators):
    """Load a :func:`checkpoint_state`; returns its global step."""
    load_params(model, ckpt["params"])
    optimizer.load_state_dict(ckpt["opt_state"])
    for k, g in generators.items():
        g.set_state(ckpt["rng"][k])
    return int(ckpt["step"])


def main(argv=None):
    """Train as the config says. Returns ``{"start_step", "first_lr", "steps",
    "final_step", "window_ms", "dev_losses", "losses"}``: the global step it
    started from and the learning rate of its first step, the steps it took,
    ms per step of each log window (host clock over the ``log_every_steps``
    steps before a log, which ends in the metrics' read-back, with no eval or
    save inside), ``{global step: dev loss}`` of its evaluations and the
    train loss of each logged step."""
    cfg, device = parse_args(argv)
    logger = get_logger("conformer_torch")
    tokenizer = build_tokenizer(cfg)
    logger.info("vocab: %d, device: %s", tokenizer.vocab_size, device)
    model = build_model(cfg, tokenizer.vocab_size, device).train()
    generators = {"dropout": torch.Generator(device=device).manual_seed(DROPOUT_SEED),
                  "features": torch.Generator(device=device).manual_seed(FEATURES_SEED)}
    model.set_dropout_generator(generators["dropout"])
    optimizer = make_optimizer(cfg, model)

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
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("params: %.1fM", n_params / 1e6)
    step_fn, eval_fn = make_step(cfg, model, optimizer, generators)
    to_device = ToDevice(device)
    loader = dict(batch_factor=float(cfg.data.batch_factor),
                  max_label_len=int(cfg.data.max_label_len),
                  frame_bucket_limit=cfg.data.get("frame_bucket_limit"),
                  batch_bucket_limit=cfg.data.get("batch_bucket_limit"))

    def eval_loss(max_batches=20):
        """Mean dev loss over at most ``max_batches`` batches (inf if the dev
        set fills no batch): the score that picks checkpoints to average."""
        total, n = 0.0, 0
        for item in batch_iterator(cfg.data.dev_csv, tokenizer, epochs=1,
                                   speed_perturb=False, **loader):
            _, _, staged = to_device(item)
            total += float(eval_fn(to_device.ready(staged))[0])
            n += 1
            if n >= max_batches:
                break
        return total / n if n else float("inf")

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
            window = (time.perf_counter(), step_count)
        if max_steps and gstep >= max_steps:
            break
    final = start_step + step_count
    ckpt.save(checkpoint_state(model, optimizer, generators, final), final)
    logger.info("done: %d steps (global %d)", step_count, final)
    return {"start_step": start_step, "first_lr": first_lr, "steps": step_count,
            "final_step": final, "window_ms": window_ms, "dev_losses": dev_losses,
            "losses": losses}


if __name__ == "__main__":
    main()

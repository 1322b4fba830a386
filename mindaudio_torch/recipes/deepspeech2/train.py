"""DeepSpeech2 LibriSpeech training on one NVIDIA GPU (port of
``examples/deepspeech2/train.py``).

A step is the ``log1p(|STFT|)`` spectrogram with per-utterance
normalization over the valid frames, the conv + BiLSTM forward in float32
with the batch norms in training mode, the CTC loss (the port's CUDA kernel
pair), the backward, global-norm clipping, and AdamW; a batch whose loss or
gradient is not finite leaves the parameters, the moments and the running
statistics as they were (``train/state.make_train_step``). Collate runs in a
worker thread and its batch is copied to the card on a side stream while
the previous step runs. A checkpoint holds the parameters, the running
statistics and the step, as the JAX recipe's does (there is no resume, so
the AdamW moments are not kept). Under ``torchrun --nproc_per_node N``
the step is data parallel: each rank collates its rows of the global
``data.batch_size`` batch, the batch norms take the global batch's
statistics, and ``train.zero1_optimizer`` shards the moments (ZeRO-1).

As in the JAX recipe, ``optim.bf16`` is not read: the model is float32.
cuDNN's convolutions and LSTM use TF32 unless
``torch.backends.cudnn.allow_tf32`` is False (PyTorch's default is True).

Usage::

    python -m mindaudio_torch.recipes.deepspeech2.train [--config deepspeech2.yaml] \\
        [--device cuda] [--train.max_steps 100] [--data.train_manifest ...] ...
    torchrun --nproc_per_node 2 -m mindaudio_torch.recipes.deepspeech2.train ...

``--config`` defaults to the ``deepspeech2.yaml`` beside this file and
``--device`` to ``cuda``; the CPU runs only when asked for.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import torch

from ... import resolve_device
from ...loss.ctc_loss import ctc_loss
from ...models.deepspeech2 import DeepSpeechModel
from ...ops.spectral import _power_frames
from ...train.checkpoint import CheckpointManager, model_state
from ...train.config import get_config
from ...train.log import get_logger
from ...train.optim import AdamW
from ...train.prefetch import ToDevice, prefetch
from ...parallel.mesh import init_mesh
from ...train.state import make_train_step
from .dataset import BLANK_ID, HOP, LABELS, N_FFT, batch_iterator

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "deepspeech2.yaml")
INIT_SEED = 0


def parse_args(argv=None):
    """``(config, device)``: the YAML merged with the ``--section.key``
    overrides of ``argv`` (``sys.argv[1:]`` when None), and ``--device``."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args(argv)
    return get_config(args.config, argv), resolve_device(args.device)


def build_model(cfg, device):
    """The float32 ``DeepSpeechModel`` of the config on ``device``, weights
    from :data:`INIT_SEED`."""
    model = DeepSpeechModel(vocab_size=len(LABELS), hidden_size=int(cfg.model.hidden_size),
                            num_rnn_layers=int(cfg.model.num_rnn_layers),
                            n_freq=N_FFT // 2 + 1, device=device)
    return model.reset_parameters(torch.Generator(device=device).manual_seed(INIT_SEED))


def device_features(wavs, wav_lens):
    """``log1p(|STFT|)`` (periodic Hann of ``N_FFT``, hop ``HOP``, zero
    centre padding), normalized per utterance to zero mean and unit
    variance over its valid frames and zero elsewhere: ``(B, T, F)`` and the
    frame lengths ``wav_lens // HOP + 1``."""
    feats = torch.log1p(_power_frames(wavs, N_FFT, N_FFT, HOP, "hann", True, "constant",
                                      power=1.0))
    feat_lens = torch.div(wav_lens, HOP, rounding_mode="floor") + 1
    t = feats.shape[1]
    valid = (torch.arange(t, device=feats.device)[None, :] < feat_lens[:, None])[..., None]
    n = torch.clamp_min(valid.sum((1, 2)) * feats.shape[-1], 1)[:, None, None]
    mean = torch.where(valid, feats, 0.0).sum((1, 2), keepdim=True) / n
    var = torch.where(valid, feats - mean, 0.0).square().sum((1, 2), keepdim=True) / n
    return torch.where(valid, (feats - mean) / torch.sqrt(var + 1e-8), 0.0), feat_lens


def ctc_objective(model, batch):
    """The step's loss: mean CTC over the batch on the model's logits."""
    logits, out_lens = model(batch["feats"], batch["feat_lens"])
    return ctc_loss(logits, out_lens, batch["labels"], batch["label_lens"],
                    blank_id=BLANK_ID), {}


def make_optimizer(cfg, model, mesh=None):
    """``optax.adamw(lr, weight_decay=...)`` with its defaults: float32
    moments, sharded over ``mesh``'s ``data`` group with
    ``train.zero1_optimizer``."""
    zero1 = bool(cfg.train.get("zero1_optimizer", False)) and mesh is not None
    return AdamW(model.named_parameters(), float(cfg.optim.lr),
                 weight_decay=float(cfg.optim.weight_decay),
                 zero1_group=mesh.group("data") if zero1 else None)


def make_step(cfg, model, optimizer, mesh=None):
    """``step(batch) -> {"loss", "grad_norm"}`` (device scalars) for a batch
    of ``wavs``, ``wav_lens``, ``labels`` and ``label_lens`` on the card
    (this rank's rows of the global batch over ``mesh``)."""
    return make_train_step(model, optimizer,
                           lambda b: device_features(b["wavs"], b["wav_lens"]),
                           grad_clip_norm=float(cfg.optim.grad_clip), loss_fn=ctc_objective,
                           mesh=mesh)


def checkpoint_state(model, step):
    """What a checkpoint holds: ``params`` and ``buffers`` (the running
    statistics) and the global step ``step``."""
    return {**model_state(model), "step": torch.tensor(step, dtype=torch.int32)}


def main(argv=None):
    """Train as the config says. Returns ``{"steps", "losses", "buckets",
    "window_ms"}``: the steps taken, ``{step: loss}`` and ``{step: frames of
    the batch's bucket}`` at the first step and each log, and ms per step of
    each log window
    (host clock over the ``log_every_steps`` steps before a log, which ends
    in the loss's read-back, with no save inside)."""
    cfg, device = parse_args(argv)
    device, mesh = init_mesh(device)
    logger = get_logger("deepspeech2_torch")
    model = build_model(cfg, device).train()
    optimizer = make_optimizer(cfg, model, mesh)
    logger.info("params: %.2fM, device: %s, mesh: %s",
                sum(p.numel() for p in model.parameters()) / 1e6, device, mesh.shape)
    step_fn = make_step(cfg, model, optimizer, mesh)
    to_device = ToDevice(device)
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep_max=int(cfg.train.keep_checkpoint_max))
    max_steps = int(cfg.train.max_steps)
    log_every, save_every = int(cfg.train.log_every_steps), int(cfg.train.save_every_steps)
    it = batch_iterator(cfg.data.train_manifest, int(cfg.data.batch_size),
                        epochs=int(cfg.optim.epochs), rank=mesh.index("data"),
                        world_size=mesh.size("data"))

    losses, buckets, window_ms = {}, {}, []
    step_count, window = 0, None
    # the first batch is staged here, the rest by the prefetch thread while
    # the step before runs
    first = next(it)
    for epoch, staged in itertools.chain([to_device(first)],
                                         prefetch(it, size=2, transform=to_device)):
        batch = to_device.ready(staged)
        metrics = step_fn(batch)
        step_count += 1
        # the only reads of a step's metrics: the first step and every log
        if step_count % log_every == 0 or step_count == 1:
            losses[step_count] = float(metrics["loss"])
            buckets[step_count] = batch["wavs"].shape[1] // HOP
            if window and step_count - window[1] == log_every:
                window_ms.append(1e3 * (time.perf_counter() - window[0]) / log_every)
            logger.info("epoch %d step %d bucket %d loss %.4f grad_norm %.3f %s", epoch,
                        step_count, buckets[step_count], losses[step_count],
                        float(metrics["grad_norm"]),
                        f"{window_ms[-1]:.1f} ms/step" if window_ms else "")
            window = (time.perf_counter(), step_count)
        if step_count % save_every == 0:
            ckpt.save(checkpoint_state(model, step_count), step_count)
            window = (time.perf_counter(), step_count)
        if max_steps and step_count >= max_steps:
            break
    ckpt.save(checkpoint_state(model, step_count), step_count)
    logger.info("done: %d steps", step_count)
    return {"steps": step_count, "losses": losses, "buckets": buckets, "window_ms": window_ms}


if __name__ == "__main__":
    main()

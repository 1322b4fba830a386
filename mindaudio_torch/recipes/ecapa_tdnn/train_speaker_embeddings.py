"""ECAPA-TDNN speaker-embedding training on one NVIDIA GPU (port of
``examples/ECAPA-TDNN/train_speaker_embeddings.py``).

A step is the dB log-mel fbank with each utterance's mean over time taken
out (``extract_features``), ``EcapaTDNN`` and the cosine ``Classifier`` in
float32 with the batch norms in training mode, the AAM-softmax loss, the
backward, and the JAX recipe's update rule (its ``step``, lines 136-150
there), which is not ``train/state.make_train_step``'s:

- the clip scale is ``min(1, clip / (norm + 1e-6))``, and 0 when the global
  norm is not finite;
- every gradient element that is not finite becomes 0;
- the AdamW update is always applied: its count advances, the moments decay
  and the weight decay moves the parameters even on a bad batch;
- the running statistics that the forward wrote are always kept, so a batch
  whose forward is not finite leaves NaN statistics behind for good
  (ROADMAP queue 3; the JAX recipe does the same).

The collate and the waveform augmentation run in a worker thread and its
batch is copied to the card on a side stream while the previous step runs.
A checkpoint holds the parameters and the running statistics, as the JAX
recipe's does. AdamW keeps float32 moments and decays every parameter, with
the cyclic triangular learning rate read at the count before the increment,
as ``optax.adamw(schedule, weight_decay=...)``. cuDNN's convolutions use
TF32 unless ``torch.backends.cudnn.allow_tf32`` is False (PyTorch's default
is True).

Usage::

    python -m mindaudio_torch.recipes.ecapa_tdnn.train_speaker_embeddings \\
        [--config ecapatdnn.yaml] [--device cuda] [--train.max_steps 10] ...

``--config`` defaults to the ``ecapatdnn.yaml`` beside this file and
``--device`` to ``cuda``; the CPU runs only when asked for.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch
from torch import nn

from ... import resolve_device
from ...loss.aam_softmax import aam_softmax_loss
from ...models.ecapa_tdnn import Classifier, EcapaTDNN
from ...ops.spectral import fbank
from ...parallel.collectives import all_reduce, group_size
from ...parallel.mesh import barrier, init_mesh
from ...parallel.shardings import sync_grads
from ...scheduler.schedules import cyclic_triangular_lr
from ...train.checkpoint import CheckpointManager, model_state
from ...train.config import get_config
from ...train.log import get_logger
from ...train.optim import AdamW
from ...train.prefetch import ToDevice, prefetch
from ...train.state import clip_by_global_norm
from ...utils.mask import make_non_pad_mask
from ..conv_tasnet.train import check_supported as separation_check
from .dataset import Augmenter, batch_iterator, n_speakers

__all__ = ["SpeakerNet", "FBANK_N_FFT", "FBANK_HOP", "extract_features", "parse_args",
           "check_supported", "build_model", "make_optimizer", "make_step", "main"]

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ecapatdnn.yaml")
INIT_SEED = 0
FBANK_N_FFT = 400
FBANK_HOP = FBANK_N_FFT // 2  # fbank's default: hop = win // 2, centred


class SpeakerNet(nn.Module):
    """:class:`EcapaTDNN` (``embedding_model``) and the cosine
    :class:`Classifier` (``classifier``) in one module, as the JAX recipe's:
    ``forward(feats (B, T, n_mels), lengths=None) -> (emb (B, 1, emb_dim),
    cosine (B, n_classes))``."""

    def __init__(self, n_classes, emb_dim=192, channels=(512, 512, 512, 512, 1536), n_mels=80,
                 device="cuda"):
        super().__init__()
        self.embedding_model = EcapaTDNN(input_size=n_mels, channels=tuple(channels),
                                         lin_neurons=emb_dim)
        self.classifier = Classifier(n_classes, lin_neurons=emb_dim)
        self.to(resolve_device(device))

    def reset_parameters(self, generator):
        """Random weights from ``generator`` (on the model's device), drawn
        from flax's init distributions."""
        self.embedding_model.reset_parameters(generator)
        self.classifier.reset_parameters(generator)
        return self

    def forward(self, feats, lengths=None):
        emb = self.embedding_model(feats, lengths=lengths)
        return emb, self.classifier(emb)


def extract_features(wavs, n_mels=80, wav_lens=None):
    """``(B, L)`` waveforms → ``(B, T, n_mels)`` dB log-mel fbank, on the
    waveforms' device, with each utterance's mean over time subtracted.

    With ``wav_lens`` the mean is over the valid frames ``1 + wav_lens //
    FBANK_HOP`` only, the frames past them are zero, and ``(feats,
    feat_lens)`` is returned: the whole-utterance path of verification.
    Whatever the lengths, the fbank's 80 dB floor is one maximum over the
    whole batch (``ops.spectral.amplitude_to_db``).
    """
    feats = fbank(wavs, n_mels=n_mels, n_fft=FBANK_N_FFT, device=wavs.device).transpose(-1, -2)
    if wav_lens is None:
        return feats - feats.mean(dim=1, keepdim=True)
    feat_lens = 1 + torch.div(wav_lens, FBANK_HOP, rounding_mode="floor")
    mask = make_non_pad_mask(feat_lens, feats.shape[1])[..., None]
    count = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
    mean = (feats * mask).sum(dim=1, keepdim=True) / count
    return torch.where(mask, feats - mean, 0.0), feat_lens


def parse_args(argv=None):
    """``(config, device)``: the YAML merged with the ``--section.key``
    overrides of ``argv`` (``sys.argv[1:]`` when None), and ``--device``."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args(argv)
    return get_config(args.config, argv), resolve_device(args.device)


def check_supported(cfg):
    """Raise ``ValueError`` when the processes of a data-parallel run do not
    split ``data.batch_size`` (``conv_tasnet.train.check_supported``)."""
    separation_check(cfg)


def build_model(cfg, device, n_classes):
    """The float32 ``SpeakerNet`` of the config on ``device``, weights from
    :data:`INIT_SEED`."""
    model = SpeakerNet(n_classes, emb_dim=int(cfg.model.emb_dim),
                       channels=tuple(cfg.model.channels), n_mels=int(cfg.features.n_mels),
                       device=device)
    return model.reset_parameters(torch.Generator(device=device).manual_seed(INIT_SEED))


def make_optimizer(cfg, model):
    """``optax.adamw(cyclic_triangular_lr(...), weight_decay=...)``: float32
    moments, the decay on every parameter."""
    schedule = cyclic_triangular_lr(float(cfg.optim.min_lr), float(cfg.optim.max_lr),
                                    int(cfg.optim.cycle_steps))
    return AdamW(model.named_parameters(), schedule, weight_decay=float(cfg.optim.weight_decay))


def make_step(cfg, model, optimizer, mesh=None):
    """``step(batch) -> {"loss", "acc", "grad_norm"}`` (device scalars) for a
    batch of ``wavs (B, L)`` and ``labels (B,)`` on the model's device, with
    the JAX recipe's update rule (see the module docstring). Nothing in a
    step reads a value back to the host. Over ``mesh`` the batch is this
    rank's rows of the global one: the gradients and the metrics are the
    global batch's (averaged over ``data``), the batch norms' statistics and
    the fbank's 80 dB floor too."""
    params = optimizer.params
    data = None if mesh is None else mesh.group("data")
    n_mels, clip = int(cfg.features.n_mels), float(cfg.optim.grad_clip)
    margin, scale = float(cfg.optim.margin), float(cfg.optim.scale)

    def step(batch):
        with torch.no_grad():
            feats = extract_features(batch["wavs"], n_mels=n_mels)
        _, cosine = model(feats)
        labels = batch["labels"]
        loss = aam_softmax_loss(cosine, labels, margin=margin, scale=scale)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        grads = sync_grads(params, grads, mesh)
        # the clip scale is finite, so a clipped element is finite exactly
        # where the gradient was; the others become 0
        grads, gnorm = clip_by_global_norm(list(grads), clip)
        optimizer.step([torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in grads])
        acc = (cosine.detach().argmax(-1) == labels).float().mean()
        both = all_reduce(torch.stack([loss.detach(), acc]), data) / group_size(data)
        return {"loss": both[0], "acc": both[1], "grad_norm": gnorm}

    return step


def main(argv=None):
    """Train as the config says. Returns ``{"steps", "losses", "window_ms",
    "model"}``: the steps taken, ``{step: loss}`` at the first step and each
    log, ms per step of each log window (host clock over the
    ``log_every_steps`` steps before a log, which ends in the loss's
    read-back, with no save inside; the collate and augmentation overlap the
    steps through the prefetch thread), and the trained ``SpeakerNet``."""
    cfg, device = parse_args(argv)
    check_supported(cfg)
    device, mesh = init_mesh(device)
    logger = get_logger("ecapa_torch")
    n_cls = n_speakers(cfg.data.train_csv)
    model = build_model(cfg, device, n_cls).train()
    optimizer = make_optimizer(cfg, model)
    logger.info("speakers: %d, params: %.2fM, device: %s, processes: %d", n_cls,
                sum(p.numel() for p in model.parameters()) / 1e6, device, mesh.world_size)
    step_fn = make_step(cfg, model, optimizer, mesh)
    to_device = ToDevice(device)
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep_max=int(cfg.train.keep_checkpoint_max))
    max_steps = int(cfg.train.max_steps)
    log_every, save_every = int(cfg.train.log_every_steps), int(cfg.train.save_every_steps)
    it = batch_iterator(cfg.data.train_csv, int(cfg.data.batch_size),
                        seg_dur=float(cfg.data.seg_dur), epochs=int(cfg.optim.epochs),
                        augmenter=Augmenter(cfg, np.random.default_rng(0)),
                        rank=mesh.index("data"), world_size=mesh.size("data"))

    losses, window_ms = {}, []
    step_count, window = 0, None
    first = next(it)
    for epoch, staged in itertools.chain([to_device(first)],
                                         prefetch(it, size=2, transform=to_device)):
        metrics = step_fn(to_device.ready(staged))
        step_count += 1
        if step_count % log_every == 0 or step_count == 1:
            losses[step_count] = float(metrics["loss"])
            if window and step_count - window[1] == log_every:
                window_ms.append(1e3 * (time.perf_counter() - window[0]) / log_every)
            logger.info("epoch %d step %d loss %.4f acc %.3f gnorm %.3g %s", epoch, step_count,
                        losses[step_count], float(metrics["acc"]), float(metrics["grad_norm"]),
                        f"{window_ms[-1]:.1f} ms/step" if window_ms else "")
            window = (time.perf_counter(), step_count)
        if step_count % save_every == 0:
            ckpt.save(model_state(model), step_count)
            window = (time.perf_counter(), step_count)
        if max_steps and step_count >= max_steps:
            break
    ckpt.save(model_state(model), step_count)
    barrier()
    logger.info("done: %d steps", step_count)
    return {"steps": step_count, "losses": losses, "window_ms": window_ms, "model": model}


if __name__ == "__main__":
    main()

"""FastSpeech2 training on one NVIDIA GPU (port of
``examples/fastspeech2/train.py``).

A step is the float32 teacher-forced forward of ``FastSpeech2WithLoss`` (the
masked multi-term loss: mel and log-duration L1, pitch and energy MSE), the
backward, global-norm clipping at ``optim.grad_clip``, and Adam
(``optax.adam``: the port's AdamW without weight decay, float32 moments) at
``scheduler.exponential_decay_lr`` with its linear warm-up of
``optim.warmup_steps``. The schedule is read at Adam's count before the
update, so the first update has a learning rate of 0 and moves nothing. A
batch whose loss or gradient is not finite leaves the parameters, the
moments and Adam's count as they were (``train/state.make_train_step``).
Dropout (the model's rate, and 0.5 in the variance predictors) draws from a
generator on the card seeded 7, the weights from one seeded ``--init-seed``
(0). The batches come from ``dataset.batch_iterator`` in a worker thread and
are copied to the card on a side stream while the previous step runs.

Every ``train.log_every_steps`` the JAX recipe's line is logged, ``epoch %d
step %d loss %.4f (mel %.4f dur %.4f pitch %.4f energy %.4f) gnorm %.2f %.2f
s/step`` (the convergence run parses it); a checkpoint (every
``train.save_every_steps`` and at the end) holds the parameters of
``FastSpeech2WithLoss``, named under ``model.`` as the JAX recipe's tree is
scoped, and the step (there is no resume). The FastSpeech2 entry points
(this one, ``generate`` and ``convergence_run``) compute in float32, as the
JAX recipe does: :func:`use_float32` turns TF32 off for cuDNN's convolutions
(PyTorch's default is on) and for the matrix products.

Usage::

    python -m mindaudio_torch.recipes.fastspeech2.train [--config fastspeech2.yaml] \\
        [--device cuda] [--init-seed 0] [--train.max_steps 10] [--data.feature_dir ...] ...

``--device`` defaults to ``cuda``; the CPU runs only when asked for.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import torch

from ... import resolve_device
from ...models.fastspeech2 import FastSpeech2, FastSpeech2WithLoss
from ...scheduler.schedules import exponential_decay_lr
from ...train.checkpoint import CheckpointManager, model_state
from ...train.config import get_config
from ...train.log import get_logger
from ...train.optim import AdamW
from ...train.prefetch import ToDevice, prefetch
from ...train.state import make_train_step
from ...parallel.mesh import barrier, init_mesh
from ..conv_tasnet.train import check_supported
from .dataset import batch_iterator
from .text import vocab_size

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastspeech2.yaml")
INIT_SEED, DROPOUT_SEED = 0, 7
LOGGER = "fastspeech2"


def parse_args(argv=None):
    """``(config, device, init_seed)``: the YAML merged with the
    ``--section.key`` overrides of ``argv`` (``sys.argv[1:]`` when None),
    ``--device`` and ``--init-seed``."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--init-seed", type=int, default=INIT_SEED)
    args, _ = parser.parse_known_args(argv)
    return get_config(args.config, argv), resolve_device(args.device), args.init_seed


def build_model(cfg, device, init_seed=INIT_SEED):
    """``(FastSpeech2, FastSpeech2WithLoss)`` of the config on ``device``,
    float32, weights from ``init_seed``; the sinusoid table spans the longer
    of ``max_mel_len`` and ``max_phoneme_len``."""
    m, d = cfg.model, cfg.data
    fs2 = FastSpeech2(vocab_size=vocab_size(), d_model=int(m.d_model), head_num=int(m.head_num),
                      conv_filter=int(m.conv_filter), encoder_layers=int(m.encoder_layers),
                      decoder_layers=int(m.decoder_layers), dropout_rate=float(m.dropout_rate),
                      n_mels=int(d.n_mels),
                      max_seq_len=max(int(d.max_mel_len), int(d.max_phoneme_len)), device=device)
    fs2.reset_parameters(torch.Generator(device=device).manual_seed(init_seed))
    return fs2, FastSpeech2WithLoss(fs2)


def load_params(fs2, params):
    """Load a checkpoint's ``params`` into ``fs2``: the names of either
    layout, ``FastSpeech2WithLoss``'s (``model.``-scoped, as :func:`train`
    saves them) or the bare model's."""
    prefix = "model."
    if all(k.startswith(prefix) for k in params):
        params = {k[len(prefix):]: v for k, v in params.items()}
    fs2.load_state_dict(params, strict=True)
    return fs2


def make_optimizer(cfg, net):
    """``optax.adam(exponential_decay_lr(...))``: the port's AdamW without
    weight decay, float32 moments."""
    o = cfg.optim
    schedule = exponential_decay_lr(float(o.lr), float(o.decay_rate), int(o.decay_steps),
                                    warmup_steps=int(o.get("warmup_steps", 1000)))
    return AdamW(net.named_parameters(), schedule, weight_decay=0.0)


def make_step(cfg, net, optimizer, mesh=None):
    """``step(batch) -> {"loss", "mel", "dur", "pitch", "energy",
    "grad_norm"}`` (device scalars) for a batch of ``phonemes``,
    ``src_lens``, ``mel``, ``pitch``, ``energy`` and ``duration`` on the
    model's device (this rank's rows of the global batch over ``mesh``; the
    loss's masked means divide by the global batch's counts)."""
    def objective(net, batch):
        total, mel, dur, pitch, energy = net(batch["phonemes"], batch["src_lens"], batch["mel"],
                                             batch["pitch"], batch["energy"], batch["duration"])
        return total, {"mel": mel, "dur": dur, "pitch": pitch, "energy": energy}

    return make_train_step(net, optimizer, grad_clip_norm=float(cfg.optim.grad_clip),
                           loss_fn=objective, mesh=mesh)


def checkpoint_state(net, step):
    """What a checkpoint holds: ``params`` (and the empty ``buffers``) of
    ``FastSpeech2WithLoss`` and the global step ``step``."""
    return {**model_state(net), "step": torch.tensor(step, dtype=torch.int32)}


def batches(cfg, mesh=None):
    """The recipe's batch iterator over ``data.feature_dir`` (this rank's
    rows over ``mesh``)."""
    d = cfg.data
    index, n = (0, 1) if mesh is None else (mesh.index("data"), mesh.size("data"))
    return batch_iterator(d.feature_dir, int(d.batch_size), int(d.max_phoneme_len),
                          int(d.max_mel_len), epochs=int(cfg.optim.epochs), rank=index,
                          world_size=n)


def train(cfg, device, init_seed=INIT_SEED):
    """Train as ``cfg`` says. Returns ``{"steps", "losses", "window_ms",
    "model", "net"}``: the steps taken, the metrics (floats) at each log,
    ms per step of each log window (host clock over the ``log_every_steps``
    steps before a log, which ends in the metrics' read-back, with no save
    inside; the collate overlaps the steps through the prefetch thread), the
    trained ``FastSpeech2`` and its ``FastSpeech2WithLoss``."""
    check_supported(cfg)
    device, mesh = init_mesh(device)
    logger = get_logger(LOGGER)
    fs2, net = build_model(cfg, device, init_seed)
    net.train()
    # the ranks' rows differ, so do their dropout streams
    fs2.set_dropout_generator(torch.Generator(device=device).manual_seed(
        DROPOUT_SEED + mesh.index("data")))
    optimizer = make_optimizer(cfg, net)
    logger.info("params: %.3fM, device: %s, processes: %d",
                sum(p.numel() for p in net.parameters()) / 1e6, device, mesh.world_size)
    step_fn = make_step(cfg, net, optimizer, mesh)
    to_device = ToDevice(device)
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep_max=int(cfg.train.keep_checkpoint_max))
    max_steps = int(cfg.train.max_steps)
    log_every, save_every = int(cfg.train.log_every_steps), int(cfg.train.save_every_steps)
    it = batches(cfg, mesh)

    losses, window_ms = {}, []
    step_count, window, t0 = 0, None, time.time()
    # the first batch is staged here, the rest by the prefetch thread while
    # the step before runs
    first = next(it)
    for epoch, staged in itertools.chain([to_device(first)],
                                         prefetch(it, size=2, transform=to_device)):
        metrics = step_fn(to_device.ready(staged))
        step_count += 1
        if step_count % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            losses[step_count] = m
            if window and step_count - window[1] == log_every:
                window_ms.append(1e3 * (time.perf_counter() - window[0]) / log_every)
            logger.info(
                "epoch %d step %d loss %.4f (mel %.4f dur %.4f pitch %.4f "
                "energy %.4f) gnorm %.2f %.2f s/step",
                epoch, step_count, m["loss"], m["mel"], m["dur"], m["pitch"], m["energy"],
                m["grad_norm"], (time.time() - t0) / step_count)
            window = (time.perf_counter(), step_count)
        if step_count % save_every == 0:
            ckpt.save(checkpoint_state(net, step_count), step_count)
            window = (time.perf_counter(), step_count)
        if max_steps and step_count >= max_steps:
            break
    ckpt.save(checkpoint_state(net, step_count), step_count)
    barrier()
    logger.info("done: %d steps", step_count)
    return {"steps": step_count, "losses": losses, "window_ms": window_ms, "model": fs2,
            "net": net}


def use_float32():
    """Run cuDNN's convolutions and the matrix products in float32 (no TF32),
    the precision of the JAX recipe and of the committed convergence runs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None):
    """Train as the config says; see :func:`train` for what is returned."""
    cfg, device, init_seed = parse_args(argv)
    use_float32()
    return train(cfg, device, init_seed)


if __name__ == "__main__":
    main()

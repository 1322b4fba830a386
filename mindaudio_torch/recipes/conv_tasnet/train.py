"""Conv-TasNet LibriMix training on one NVIDIA GPU (port of
``examples/conv_tasnet/train.py``).

A step is the float32 forward on the batch's mixtures, the
permutation-invariant SI-SNR loss over the valid samples
(``loss/separation_loss.pit_si_snr_loss``), the backward, global-norm
clipping at ``optim.grad_clip``, and Adam (``optax.adam(lr)``: the port's
AdamW without weight decay, float32 moments); a batch whose loss or gradient
is not finite leaves the parameters, the moments and Adam's count as they
were (``train/state.make_train_step``). The batches come from
``data/librimix.separation_batch_iterator`` (random crops of
``data.segment_seconds``, shorter utterances zero-padded, their lengths
kept); the collate runs in a worker thread and its batch is copied to the
card on a side stream while the previous step runs. A checkpoint holds the
parameters and the step, as the JAX recipe's holds its parameters (there is
no resume).

The same loop trains TasNet (``recipes/tasnet/train.py``), with the forward
that frames the waveform, separates and overlap-adds it back. cuDNN's
convolutions and LSTM use TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False (PyTorch's default is True).

Usage::

    python -m mindaudio_torch.recipes.conv_tasnet.train [--config conv_tasnet.yaml] \\
        [--device cuda] [--train.max_steps 100] [--data.train_dir ...] ...

``--config`` defaults to the ``conv_tasnet.yaml`` beside this file and
``--device`` to ``cuda``; the CPU runs only when asked for.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import torch

from ... import resolve_device
from ...data.librimix import separation_batch_iterator
from ...loss.separation_loss import pit_si_snr_loss
from ...models.conv_tasnet import ConvTasNet
from ...parallel.mesh import active_mesh, barrier, init_mesh, make_mesh
from ...train.checkpoint import CheckpointManager, model_state
from ...train.config import get_config
from ...train.log import get_logger
from ...train.optim import AdamW
from ...train.prefetch import ToDevice, prefetch
from ...train.state import make_train_step

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conv_tasnet.yaml")
INIT_SEED = 0


def parse_args(argv=None, default_config=DEFAULT_CONFIG):
    """``(config, device)``: the YAML merged with the ``--section.key``
    overrides of ``argv`` (``sys.argv[1:]`` when None), and ``--device``."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", default=default_config)
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args(argv)
    return get_config(args.config, argv), resolve_device(args.device)


def check_supported(cfg):
    """Raise ``ValueError`` when the processes of a data-parallel run
    (``torchrun``'s ``WORLD_SIZE``, or the initialised group) do not split
    ``data.batch_size``: the JAX iterators would silently drop the rows
    left over, so a changed global batch would go unnoticed."""
    dist = torch.distributed
    world = (dist.get_world_size() if dist.is_available() and dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if int(cfg.data.batch_size) % world:
        raise ValueError(f"data parallel over {world} processes: data.batch_size "
                         f"{int(cfg.data.batch_size)} does not split evenly")


def build_model(cfg, device):
    """The float32 ``ConvTasNet`` of the config on ``device``, weights from
    :data:`INIT_SEED`."""
    m = cfg.model
    model = ConvTasNet(enc_dim=int(m.enc_dim), win_len=int(m.win_len),
                       bottleneck=int(m.bottleneck), hidden=int(m.hidden),
                       kernel_size=int(m.kernel_size), num_blocks=int(m.num_blocks),
                       num_repeats=int(m.num_repeats), num_spk=int(m.num_spk),
                       norm_type=str(m.norm_type), mask_nonlinear=str(m.mask_nonlinear),
                       device=device)
    return model.reset_parameters(torch.Generator(device=device).manual_seed(INIT_SEED))


def separate(model, mix):
    """``(B, T)`` mixtures → ``(B, C, T)`` sources: Conv-TasNet frames the
    waveform itself."""
    return model(mix)


def segment_len(cfg):
    """Samples of a training crop (and of an evaluated utterance)."""
    return int(float(cfg.data.segment_seconds) * int(cfg.data.sample_rate))


def make_optimizer(cfg, model):
    """``optax.adam(lr)``: the port's AdamW without weight decay, float32
    moments."""
    return AdamW(model.named_parameters(), float(cfg.optim.lr), weight_decay=0.0)


def make_step(cfg, model, optimizer, separate_fn=separate, mesh=None):
    """``step(batch) -> {"loss", "grad_norm"}`` (device scalars) for a batch
    of ``mix (B, T)``, ``src (B, C, T)`` and ``lengths (B,)`` on the model's
    device (this rank's rows of the global batch over ``mesh``)."""
    def objective(model, batch):
        loss, _ = pit_si_snr_loss(separate_fn(model, batch["mix"]), batch["src"],
                                  batch["lengths"])
        return loss, {}

    return make_train_step(model, optimizer, grad_clip_norm=float(cfg.optim.grad_clip),
                           loss_fn=objective, mesh=mesh)


def checkpoint_state(model, step):
    """What a checkpoint holds: ``params`` (and the empty ``buffers``) and
    the global step ``step``."""
    return {**model_state(model), "step": torch.tensor(step, dtype=torch.int32)}


def train(cfg, device, model, separate_fn, logger_name):
    """The training loop of both separation recipes: ``model`` (built on
    ``device``) trained as ``cfg`` says with ``separate_fn(model, mix)`` as
    its forward. Returns ``{"steps", "losses", "window_ms", "model"}``: the
    steps taken, ``{step: loss}`` at the first step and each log, ms per
    step of each log window (host clock over the ``log_every_steps`` steps
    before a log, which ends in the loss's read-back, with no save inside;
    the collate overlaps the steps through the prefetch thread), and the
    trained model. Data parallel over the active mesh (``main`` builds it
    with ``parallel.mesh.init_mesh`` before the model): each rank collates
    its rows of the global batch, only rank 0 logs and writes."""
    check_supported(cfg)
    mesh = active_mesh() or make_mesh()
    logger = get_logger(logger_name)
    model.train()
    optimizer = make_optimizer(cfg, model)
    logger.info("params: %.3fM, device: %s, processes: %d",
                sum(p.numel() for p in model.parameters()) / 1e6, device, mesh.world_size)
    step_fn = make_step(cfg, model, optimizer, separate_fn, mesh)
    to_device = ToDevice(device)
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep_max=int(cfg.train.keep_checkpoint_max))
    max_steps = int(cfg.train.max_steps)
    log_every, save_every = int(cfg.train.log_every_steps), int(cfg.train.save_every_steps)
    it = separation_batch_iterator(cfg.data.train_dir, int(cfg.data.batch_size),
                                   segment_len(cfg), epochs=int(cfg.optim.epochs),
                                   rank=mesh.index("data"), world_size=mesh.size("data"))

    losses, window_ms = {}, []
    step_count, window = 0, None
    # the first batch is staged here, the rest by the prefetch thread while
    # the step before runs
    first = next(it)
    for epoch, staged in itertools.chain([to_device(first)],
                                         prefetch(it, size=2, transform=to_device)):
        metrics = step_fn(to_device.ready(staged))
        step_count += 1
        # the only reads of a step's metrics: the first step and every log
        if step_count % log_every == 0 or step_count == 1:
            losses[step_count] = float(metrics["loss"])
            if window and step_count - window[1] == log_every:
                window_ms.append(1e3 * (time.perf_counter() - window[0]) / log_every)
            logger.info("epoch %d step %d -si_snr %.3f grad_norm %.3f %s", epoch, step_count,
                        losses[step_count], float(metrics["grad_norm"]),
                        f"{window_ms[-1]:.1f} ms/step" if window_ms else "")
            window = (time.perf_counter(), step_count)
        if step_count % save_every == 0:
            ckpt.save(checkpoint_state(model, step_count), step_count)
            window = (time.perf_counter(), step_count)
        if max_steps and step_count >= max_steps:
            break
    ckpt.save(checkpoint_state(model, step_count), step_count)
    barrier()
    logger.info("done: %d steps", step_count)
    return {"steps": step_count, "losses": losses, "window_ms": window_ms, "model": model}


def main(argv=None):
    """Train as the config says; see :func:`train` for what is returned."""
    cfg, device = parse_args(argv)
    check_supported(cfg)
    device, _ = init_mesh(device)
    return train(cfg, device, build_model(cfg, device), separate, "conv_tasnet_torch")


if __name__ == "__main__":
    main()

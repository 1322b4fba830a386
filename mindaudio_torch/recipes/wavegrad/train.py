"""WaveGrad training on one NVIDIA GPU (port of ``examples/wavegrad/train.py``).

The host cuts random ``crop_frames``-frame windows of mel and audio
(:func:`crop_iterator`, the JAX recipe's NumPy stream); a step draws one
noise level ``s`` in ``[1, 999]`` for the whole batch and, per example, a
scale uniform between ``noise_levels[s]`` and ``noise_levels[s-1]``
(:func:`draw_step`, ``models.wavegrad.diffuse``), both from a generator on
the card seeded 3; then the L1 noise loss of ``WaveGradWithLoss``, the
backward, global-norm clipping at ``optim.grad_clip`` and Adam (the port's
AdamW without weight decay, float32 moments) at ``optax.linear_schedule(0,
lr, warmup_steps)`` (``scheduler.linear_schedule``), read at Adam's count
before the update: the first update has a learning rate of 0 and moves
nothing. A batch whose loss or gradient is not finite leaves the
parameters, the moments and Adam's count as they were
(``train/state.make_train_step``). The weights come from a generator seeded
``--init-seed`` (0); the batches from a worker thread, copied to the card
on a side stream while the previous step runs.

Every ``train.log_every_steps`` the JAX recipe's line ``epoch %d step %d
loss %.5f %.2f s/step`` is logged (the convergence run parses it); a
checkpoint (every ``train.save_every_steps`` and at the end) holds the
parameters of ``WaveGradWithLoss``, named under ``model.`` as the JAX
recipe's tree is scoped, and the step (there is no resume). Training
computes in float32 (``fastspeech2.train.use_float32``: no TF32), as the
other generative recipes do.

Usage::

    python -m mindaudio_torch.recipes.wavegrad.train [--config wavegrad.yaml] \\
        [--device cuda] [--init-seed 0] [--train.max_steps 10] [--data.feature_dir ...] ...

``--device`` defaults to ``cuda``; the CPU runs only when asked for.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch

from ... import resolve_device
from ...models.wavegrad import (WaveGrad, WaveGradWithLoss, default_noise_schedule, diffuse,
                                noise_levels)
from ...scheduler.schedules import linear_schedule
from ...train.checkpoint import CheckpointManager, model_state, restore_checkpoint
from ...train.config import get_config
from ...train.log import get_logger
from ...train.optim import AdamW
from ...train.prefetch import ToDevice, prefetch
from ...train.state import make_train_step
from ...parallel.mesh import barrier, init_mesh
from ..conv_tasnet.train import check_supported
from ..fastspeech2.train import use_float32

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wavegrad.yaml")
INIT_SEED, DIFFUSION_SEED = 0, 3
LOGGER = "wavegrad"

__all__ = ["parse_args", "build_model", "load_vocoder", "make_optimizer", "schedule_levels",
           "draw_step", "make_step", "crop_iterator", "checkpoint_state", "train", "main",
           "use_float32"]


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


def _model_kwargs(cfg):
    m = cfg.model
    return {k: tuple(int(v) for v in m[k]) for k in (
        "up_factors", "down_factors", "down_channels", "film_channels", "up_channels")}


def build_model(cfg, device, init_seed=INIT_SEED):
    """``(WaveGrad, WaveGradWithLoss)`` of the config on ``device``,
    float32, weights from ``init_seed``."""
    wg = WaveGrad(n_mels=int(cfg.data.n_mels), device=device, **_model_kwargs(cfg))
    wg.reset_parameters(torch.Generator(device=device).manual_seed(init_seed))
    if wg.hop != int(cfg.data.hop_length):
        raise ValueError(f"wavegrad: the up factors multiply to {wg.hop}, data.hop_length is "
                         f"{cfg.data.hop_length}")
    return wg, WaveGradWithLoss(wg)


def load_vocoder(directory, device, cfg=None):
    """The ``WaveGrad`` of the latest checkpoint under ``directory``, in
    eval mode on ``device``: either layout (``WaveGradWithLoss``'s
    ``model.``-scoped names, as :func:`train` saves them, or the bare
    model's); the widths are read from the weights, the factors from
    ``cfg.model`` (default: the YAML's)."""
    params = restore_checkpoint(directory)["params"]
    prefix = "model."
    if all(k.startswith(prefix) for k in params):
        params = {k[len(prefix):]: v for k, v in params.items()}

    def widths(fmt):
        out = []
        while fmt.format(len(out)) in params:
            out.append(params[fmt.format(len(out))].shape[0])
        return tuple(out)

    kwargs = _model_kwargs(cfg or get_config(DEFAULT_CONFIG, []))
    kwargs.update(down_channels=widths("dblock_{}.res_conv.weight"),
                  film_channels=widths("film_{}.encoding_conv.weight"),
                  up_channels=widths("ublock_{}.res_conv.weight"))
    wg = WaveGrad(n_mels=params["u_conv.weight"].shape[1], device=device, **kwargs)
    wg.load_state_dict(params, strict=True)
    return wg.eval()


def make_optimizer(cfg, net):
    """``optax.adam(linear_schedule(0, lr, warmup_steps))``: the port's
    AdamW without weight decay, float32 moments."""
    o = cfg.optim
    return AdamW(net.named_parameters(),
                 linear_schedule(0.0, float(o.lr), int(o.get("warmup_steps", 1000))),
                 weight_decay=0.0)


def schedule_levels(cfg, device):
    """The training noise levels ``sqrt(cumprod(1 - betas))`` (float32) of
    the config's schedule, on ``device``."""
    d = cfg.diffusion
    betas = default_noise_schedule(int(d.num_steps), float(d.beta_start), float(d.beta_end))
    return torch.from_numpy(noise_levels(betas)).to(device)


def draw_step(generator, audio, levels):
    """One step's diffusion: ``s`` uniform in ``[1, len(levels) - 1]``, one
    for the whole batch, then :func:`diffuse` between ``levels[s]`` and
    ``levels[s-1]``. Returns ``(noisy, noise, scale, s)``, all on the
    device."""
    s = torch.randint(1, levels.shape[0], (), generator=generator, device=audio.device)
    noisy, noise, scale = diffuse(generator, audio, (levels[s], levels[s - 1]))
    return noisy, noise, scale, s


def make_step(cfg, net, optimizer, generator, mesh=None):
    """``step(batch) -> {"loss", "grad_norm"}`` (device scalars) for a batch
    of ``mel`` and ``audio`` on the model's device; the diffusion draws come
    from ``generator``. Over ``mesh`` the batch is this rank's rows of the
    global one: every rank (its generator seeded alike) draws the global
    batch's level, scales and noise and keeps its rows, so a data-parallel
    step diffuses as the one-process step on the global batch does."""
    levels = schedule_levels(cfg, optimizer.params[0].device)
    index, n = (0, 1) if mesh is None else (mesh.index("data"), mesh.size("data"))

    def objective(net, batch):
        audio = batch["audio"]
        if n == 1:
            noisy, noise, scale, _ = draw_step(generator, audio, levels)
        else:
            b = audio.shape[0]
            _, noise, scale, _ = draw_step(
                generator, audio.new_zeros((n * b,) + audio.shape[1:]), levels)
            noise, scale = noise[index * b:(index + 1) * b], scale[index * b:(index + 1) * b]
            noisy = scale[:, None] * audio + torch.sqrt(1.0 - scale[:, None] ** 2) * noise
        return net(batch["mel"], noisy, scale, noise), {}

    return make_train_step(net, optimizer, grad_clip_norm=float(cfg.optim.grad_clip),
                           loss_fn=objective, mesh=mesh)


def crop_iterator(cfg, batch_size, epochs, seed=0, rank=0, world_size=1):
    """Random ``(mel, audio)`` crops of ``data.crop_frames`` frames, as
    ``(epoch, {"mel", "audio"})`` batches: the JAX recipe's stream. Each
    epoch's ``default_rng(seed + epoch)`` draws the order and then, per
    utterance longer than the crop, its offset; a shorter one is padded
    with zeros. ``data.cache_features`` keeps the decoded files in memory.
    With ``world_size > 1`` every rank walks the same batch sequence and
    loads its contiguous ``1 / world_size`` block of rows, drawing its
    offsets from its own stream, as the JAX recipe does."""
    feature_dir = cfg.data.feature_dir
    with open(os.path.join(feature_dir, "train.txt"), encoding="utf-8") as f:
        utts = [line.strip() for line in f if line.strip()]
    crop = int(cfg.data.crop_frames)
    hop = int(cfg.data.hop_length)
    cache = {} if bool(cfg.data.get("cache_features", False)) else None

    def load(u):
        if cache is not None and u in cache:
            return cache[u]
        d = np.load(os.path.join(feature_dir, u + ".npy"), allow_pickle=True).item()
        if cache is not None:
            cache[u] = d
        return d

    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(utts))
        sel = order[: (len(order) // batch_size) * batch_size].reshape(-1, batch_size)
        for batch_idx in sel:
            if world_size > 1:
                local = batch_size // world_size
                batch_idx = batch_idx[rank * local:(rank + 1) * local]
            mel = np.zeros((len(batch_idx), crop, int(cfg.data.n_mels)), np.float32)
            audio = np.zeros((len(batch_idx), crop * hop), np.float32)
            for i, u in enumerate(batch_idx):
                d = load(utts[u])
                t = d["mel"].shape[0]
                if t <= crop:
                    mel[i, :t] = d["mel"]
                    audio[i, : t * hop] = d["audio"][: t * hop]
                else:
                    off = rng.integers(0, t - crop + 1)
                    mel[i] = d["mel"][off: off + crop]
                    audio[i] = d["audio"][off * hop: (off + crop) * hop]
            yield epoch, {"mel": mel, "audio": audio}


def checkpoint_state(net, step):
    """What a checkpoint holds: ``params`` (and the empty ``buffers``) of
    ``WaveGradWithLoss`` and the global step ``step``."""
    return {**model_state(net), "step": torch.tensor(step, dtype=torch.int32)}


def train(cfg, device, init_seed=INIT_SEED):
    """Train as ``cfg`` says. Returns ``{"steps", "losses", "window_ms",
    "model", "net"}``: the steps taken, the loss and gradient norm (floats)
    at each log, ms per step of each log window (host clock over the
    ``log_every_steps`` steps before a log, which ends in the metrics'
    read-back, with no save inside; the crops overlap the steps through the
    prefetch thread), the trained ``WaveGrad`` and its
    ``WaveGradWithLoss``."""
    check_supported(cfg)
    device, mesh = init_mesh(device)
    logger = get_logger(LOGGER)
    wg, net = build_model(cfg, device, init_seed)
    net.train()
    optimizer = make_optimizer(cfg, net)
    logger.info("params: %.3fM, device: %s, processes: %d",
                sum(p.numel() for p in net.parameters()) / 1e6, device, mesh.world_size)
    step_fn = make_step(cfg, net, optimizer,
                        torch.Generator(device=device).manual_seed(DIFFUSION_SEED), mesh)
    to_device = ToDevice(device)
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep_max=int(cfg.train.keep_checkpoint_max))
    max_steps = int(cfg.train.max_steps)
    log_every, save_every = int(cfg.train.log_every_steps), int(cfg.train.save_every_steps)
    it = crop_iterator(cfg, int(cfg.data.batch_size), int(cfg.optim.epochs),
                       rank=mesh.index("data"), world_size=mesh.size("data"))

    losses, window_ms = {}, []
    step_count, window, t0 = 0, None, time.time()
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
            logger.info("epoch %d step %d loss %.5f %.2f s/step", epoch, step_count, m["loss"],
                        (time.time() - t0) / step_count)
            window = (time.perf_counter(), step_count)
        if step_count % save_every == 0:
            ckpt.save(checkpoint_state(net, step_count), step_count)
            window = (time.perf_counter(), step_count)
        if max_steps and step_count >= max_steps:
            break
    ckpt.save(checkpoint_state(net, step_count), step_count)
    barrier()
    logger.info("done: %d steps", step_count)
    return {"steps": step_count, "losses": losses, "window_ms": window_ms, "model": wg,
            "net": net}


def main(argv=None):
    """Train as the config says; see :func:`train` for what is returned."""
    cfg, device, init_seed = parse_args(argv)
    use_float32()
    return train(cfg, device, init_seed)


if __name__ == "__main__":
    main()

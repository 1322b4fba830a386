"""Learning-rate schedules (port of ``mindaudio_tpu.scheduler.schedules``).

The Conformer recipe's Noam warm-up, the warm-up with a polynomial or a
cosine decay, the step decay, FastSpeech2's exponential decay with a linear
warm-up, ECAPA-TDNN's cyclic triangle and WaveGrad's linear warm-up
(``optax.linear_schedule``). A
schedule is a plain function of the step: a Python int gives a float tensor
on the CPU, a device tensor gives a device tensor (no host round trip inside
a train step).
"""

from __future__ import annotations

import math

import torch

__all__ = ["asr_warmup_lr", "warmup_poly_lr", "cosine_lr", "step_lr", "exponential_decay_lr",
           "cyclic_triangular_lr", "linear_schedule"]


def asr_warmup_lr(lr, warmup_steps=25000, start_steps=0):
    """Noam warm-up: ``lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5)``,
    the step clamped to at least 1."""

    def schedule(step):
        s = (torch.as_tensor(step) + start_steps).clamp_min(1).to(torch.float32)
        return lr * warmup_steps**0.5 * torch.minimum(s**-0.5, s * warmup_steps**-1.5)

    return schedule


def warmup_poly_lr(lr, min_lr, warmup_steps, total_steps, power=1.0, start_steps=0):
    """A linear warm-up ``lr * step / warmup_steps``, then a polynomial
    decay of power ``power`` from ``lr`` to ``min_lr`` at ``total_steps``."""

    def schedule(step):
        s = (torch.as_tensor(step) + start_steps).to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        decay = (lr - min_lr) * (1.0 - frac) ** power + min_lr
        return torch.where(s < warmup_steps, warm, decay)

    return schedule


def cosine_lr(lr, min_lr, warmup_steps, total_steps, start_steps=0):
    """A linear warm-up, then a cosine decay from ``lr`` to ``min_lr`` at
    ``total_steps``."""

    def schedule(step):
        s = (torch.as_tensor(step) + start_steps).to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        decay = min_lr + 0.5 * (lr - min_lr) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, decay)

    return schedule


def step_lr(lr, epoch_size, factor=0.5, interval=2):
    """``lr * factor^(epoch // interval)`` with ``epoch = step //
    epoch_size``."""

    def schedule(step):
        epoch = torch.div(torch.as_tensor(step), epoch_size, rounding_mode="floor")
        exponent = torch.div(epoch, interval, rounding_mode="floor").to(torch.float32)
        return lr * factor ** exponent

    return schedule


def exponential_decay_lr(lr, decay_rate, decay_steps, staircase=True, warmup_steps=0):
    """``lr * decay_rate^(step / decay_steps)`` (the exponent floored when
    ``staircase``), after a linear warm-up ``lr * step / warmup_steps`` over
    the first ``warmup_steps`` steps when that is positive. FastSpeech2's
    post-norm FFT stacks need the warm-up: at Adam 1e-3 from step 0 they fall
    into an input-independent minimum (the JAX package's measurement)."""

    def schedule(step):
        s = torch.as_tensor(step).to(torch.float32)
        p = s / decay_steps
        if staircase:
            p = torch.floor(p)
        base = lr * decay_rate**p
        if warmup_steps <= 0:
            return base
        return torch.where(s < warmup_steps, lr * s / warmup_steps, base)

    return schedule


def cyclic_triangular_lr(min_lr, max_lr, step_size):
    """Triangular cyclic learning rate: from ``min_lr`` up to ``max_lr`` over
    ``step_size`` steps and down again over as many, repeated."""

    def schedule(step):
        step = torch.as_tensor(step)
        cycle = torch.floor(1 + step / (2 * step_size))
        x = torch.abs(step / step_size - 2 * cycle + 1)
        return min_lr + (max_lr - min_lr) * torch.clamp_min(1.0 - x, 0.0)

    return schedule


def linear_schedule(init_value, end_value, transition_steps):
    """``optax.linear_schedule``: from ``init_value`` to ``end_value`` over
    ``transition_steps`` steps, then constant; as in optax, ``(init - end) *
    (1 - step / transition_steps) + end`` with the step clamped into
    ``[0, transition_steps]``, and ``init_value`` throughout when
    ``transition_steps <= 0``. WaveGrad's warm-up is ``linear_schedule(0, lr,
    warmup_steps)``: its FiLM-modulated UBlock stack is sharp at init."""

    def schedule(step):
        s = torch.as_tensor(step).to(torch.float32)
        if transition_steps <= 0:
            return torch.full_like(s, init_value)
        frac = 1.0 - torch.clamp(s, 0.0, transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule

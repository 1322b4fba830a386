"""Learning-rate schedules (port of ``mindaudio_tpu.scheduler.schedules``).

The Conformer recipe's Noam warm-up, FastSpeech2's exponential decay with a
linear warm-up and ECAPA-TDNN's cyclic triangle. A
schedule is a plain function of the step: a Python int gives a float tensor
on the CPU, a device tensor gives a device tensor (no host round trip inside
a train step).
"""

from __future__ import annotations

import torch

__all__ = ["asr_warmup_lr", "exponential_decay_lr", "cyclic_triangular_lr"]


def asr_warmup_lr(lr, warmup_steps=25000, start_steps=0):
    """Noam warm-up: ``lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5)``,
    the step clamped to at least 1."""

    def schedule(step):
        s = (torch.as_tensor(step) + start_steps).clamp_min(1).to(torch.float32)
        return lr * warmup_steps**0.5 * torch.minimum(s**-0.5, s * warmup_steps**-1.5)

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

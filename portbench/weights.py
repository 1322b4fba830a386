"""Seeded weights, made on the device in three large draws.

A model's ``init_spec`` lists ``(name, shape, kind, fan_in)``: ``normal``
leaves get ``N(0, 1 / fan_in)`` (LeCun's scale), ``uniform`` ones
``U(-sqrt(6 / fan_in), sqrt(6 / fan_in))``, and ``zeros`` / ``ones`` their
constant. All normal leaves come from one ``randn`` and all uniform ones
from one ``rand`` of a generator seeded with the run's seed, in the
spec's order, so the same seed gives the same weights to the program and to
the reference.
"""

from __future__ import annotations

import math

import torch


def make(spec, seed, device):
    """``{name: float32 tensor}`` for ``spec``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(s) for _, s, kind, _ in spec if kind == "normal")
    n_uniform = sum(math.prod(s) for _, s, kind, _ in spec if kind == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for name, shape, kind, fan_in in spec:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = (normal[i:i + n] / math.sqrt(fan_in)).view(shape)
            i += n
        elif kind == "uniform":
            bound = math.sqrt(6.0 / fan_in)
            out[name] = ((uniform[j:j + n] * 2.0 - 1.0) * bound).view(shape)
            j += n
        else:
            out[name] = torch.full(shape, 1.0 if kind == "ones" else 0.0, device=device)
    return out


@torch.no_grad()
def load(model, weights):
    """Copy ``weights`` into ``model``'s parameters; the names must match
    exactly."""
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise KeyError("the weights and the model name different parameters: "
                       f"{sorted(set(named) ^ set(weights))[:8]}")
    for name, p in named.items():
        p.copy_(weights[name])

"""Global-norm clipping, AdamW and the Noam warm-up, per leaf in float32.

AdamW as optax computes it (Loshchilov and Hutter, arXiv:1711.05101):
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, both corrected by
``1 - b^t``, ``p -= lr (m^ / (sqrt(v^) + eps) + wd p)``, the learning rate
read at the count before the update. The clip scales the gradients by
``min(1, max_norm / (norm + 1e-6))``.
"""

from __future__ import annotations

import math

import torch


def noam(lr, warmup):
    """``lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5)``, ``s = max(step, 1)``."""
    def schedule(step):
        s = max(step, 1)
        return lr * warmup ** 0.5 * min(s ** -0.5, s * warmup ** -1.5)
    return schedule


def constant(lr):
    return lambda step: lr


def clip(grads, max_norm):
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
    return [g * scale for g in grads]


class AdamW:
    def __init__(self, params, schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        self.params, self.schedule = list(params), schedule
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.schedule(self.count)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(lr * ((m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p))


def follow(model, names, batches, loss_and_grads, make_optimizer, max_norm):
    """The reference's steps on ``batches``: each step's loss, the norm of
    each leaf's first (clipped) gradient, each leaf's change over all the
    steps; ``loss_and_grads(batch) -> (loss, grads)``."""
    params = [dict(model.named_parameters())[n] for n in names]
    start = [p.detach().clone() for p in params]
    opt = make_optimizer(params)
    losses, first = [], None
    for batch in batches:
        loss, grads = loss_and_grads(batch)
        grads = clip(grads, max_norm)
        if first is None:
            first = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append(float(loss))
    change = {n: float(torch.linalg.vector_norm(p.detach() - s))
              for n, p, s in zip(names, params, start)}
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"the reference's loss is not finite: {losses}")
    return {"losses": losses, "grad_norms": first, "change": change}

"""Additive angular margin (AAM-softmax) for speaker verification (port of
``mindaudio_tpu.loss.aam_softmax``): the target class's cosine becomes
``cos(θ + m)``, every logit is scaled by ``scale``, and the loss is the
cross-entropy over those logits.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

__all__ = ["additive_angular_margin", "aam_softmax_loss"]


def additive_angular_margin(cosine, targets_onehot, margin=0.2, scale=30.0, easy_margin=False):
    """``scale`` times the cosines with ``cos(θ + m)`` at the target class.

    The cosines are clipped to ``±(1 - 1e-4)`` before the sine: the
    derivative of ``sqrt(1 - x^2)`` is infinite at ``|x| = 1``, where a
    cosine of two normalized vectors can land in TF32 or bf16. Past ``θ = π
    - m`` the target logit is ``cos θ - m sin m`` (``cos θ`` where ``cos θ
    <= 0`` with ``easy_margin``), so it stays monotonic in ``θ``.
    """
    cos_m, sin_m = np.cos(margin), np.sin(margin)
    th = np.cos(np.pi - margin)
    mm = np.sin(np.pi - margin) * margin
    cosine_in = torch.clamp(cosine, -1.0 + 1e-4, 1.0 - 1e-4)
    sine = torch.sqrt(1.0 - cosine_in**2)
    phi = cosine_in * float(cos_m) - sine * float(sin_m)  # cos(θ + m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine > float(th), phi, cosine - float(mm))
    return scale * torch.where(targets_onehot > 0, phi, cosine)


def aam_softmax_loss(cosine, targets, margin=0.2, scale=30.0, easy_margin=False):
    """Mean cross-entropy over the AAM-margined cosine logits ``(B,
    classes)``, in float32; ``targets`` int ``(B,)``."""
    onehot = F.one_hot(targets.long(), cosine.shape[-1]).to(cosine.dtype)
    logits = additive_angular_margin(cosine, onehot, margin, scale, easy_margin)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(onehot * logp).sum(-1).mean()

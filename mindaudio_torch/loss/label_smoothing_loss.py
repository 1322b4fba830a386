"""Label-smoothing KL-divergence loss for the attention decoder branch (port
of ``mindaudio_tpu.loss.label_smoothing_loss``).

The smoothed target puts ``confidence`` on the target class and one constant
``low`` everywhere else, so the KL collapses to a gather plus two row
reductions::

    KL(p || q) = sum p log p - (conf - low) * log q[target] - low * sum_v log q_v

and no ``(B, L, vocab)`` one-hot or true-distribution tensor is built.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import data_denominator

__all__ = ["IGNORE_ID", "label_smoothing_loss"]

IGNORE_ID = -1


def label_smoothing_loss(logits, targets, smoothing=0.1, ignore_id=IGNORE_ID,
                         normalize_length=False):
    """KL(smoothed one-hot || softmax(logits)), pad-masked, in float32.

    Args:
        logits: ``(B, L, vocab)``, any float dtype (cast to float32 first).
        targets: ``(B, L)`` int ids, ``ignore_id`` at padding.
        smoothing: mass distributed over the non-target classes.
        normalize_length: divide by the token count instead of the batch size.
    """
    vocab = logits.shape[-1]
    confidence = 1.0 - smoothing
    low = smoothing / (vocab - 1)

    mask = targets != ignore_id
    safe_t = torch.where(mask, targets, 0).long()

    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)  # (B, L)
    logq_t = logits.gather(-1, safe_t[..., None])[..., 0] - lse
    sum_logq = logits.sum(-1) - vocab * lse

    # sum p log p: a constant of the smoothing, not of the logits
    plogp = confidence * math.log(confidence) if confidence > 0 else 0.0
    if low > 0:
        plogp += (vocab - 1) * low * math.log(low)

    kl = plogp - (confidence - low) * logq_t - low * sum_logq
    kl = torch.where(mask, kl, 0.0)
    # the token count of the global batch (summed over the data group)
    denom = data_denominator(mask.sum()) if normalize_length else targets.shape[0]
    return kl.sum() / denom

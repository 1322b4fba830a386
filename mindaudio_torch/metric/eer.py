"""Equal error rate for speaker verification (the port's copy of
``mindaudio_tpu.metric.eer``, pinned to it by ``tests/test_torch_ecapa.py``):
the ROC of the scores, then the root of ``1 - fpr - tpr(fpr)`` on its linear
interpolation. NumPy and SciPy on the host.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d
from scipy.optimize import brentq

__all__ = ["get_eer", "get_eer_from_scores", "compute_fa_miss"]


def _roc(labels, scores):
    order = np.argsort(-scores)
    labels = np.asarray(labels)[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    return fpr, tpr


def compute_fa_miss(scores, labels, pos_label=1, return_thresholds=True):
    """False-alarm and miss probability curves ``(P_fa, P_miss[,
    thresholds])`` by increasing ``P_fa``, one point per distinct score
    (accept when ``score >= threshold``)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = (np.asarray(labels) == pos_label).astype(np.int64)
    order = np.argsort(-scores)
    s, l = scores[order], labels[order]
    distinct = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
    tps = np.cumsum(l)[distinct]
    fps = (distinct + 1) - tps
    n_pos = max(int(l.sum()), 1)
    n_neg = max(int(len(l) - l.sum()), 1)
    fpr = fps / n_neg
    tpr = tps / n_pos
    P_fa = fpr[::-1]
    P_miss = (1.0 - tpr)[::-1]
    thresholds = s[distinct][::-1]
    if return_thresholds:
        return P_fa, P_miss, thresholds
    return P_fa, P_miss


def get_eer(positive_scores, negative_scores):
    """``(eer, threshold)`` from the positive and the negative trials' scores."""
    scores = np.concatenate([positive_scores, negative_scores])
    labels = np.concatenate(
        [np.ones(len(positive_scores)), np.zeros(len(negative_scores))]
    )
    return get_eer_from_scores(scores, labels)


def get_eer_from_scores(scores, labels):
    """``(eer, threshold)`` from scores and binary labels. The threshold is
    the cut where the swept false-accept and false-reject rates meet, moved
    to the middle of the gap to the next score."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    fpr, tpr = _roc(labels, scores)
    fpr = np.concatenate([[0.0], fpr])
    tpr = np.concatenate([[0.0], tpr])
    eer = brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0)

    sorted_scores = np.sort(scores)[::-1]  # descending candidate cuts
    fnr_sweep = 1.0 - tpr[1:]
    fpr_sweep = fpr[1:]
    idx = int(np.argmin(np.abs(fpr_sweep - fnr_sweep)))
    thresh = sorted_scores[idx]
    if idx + 1 < len(sorted_scores):
        thresh = 0.5 * (thresh + sorted_scores[idx + 1])
    return float(eer), float(thresh)

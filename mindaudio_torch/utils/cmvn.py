"""Global CMVN statistics: accumulate, save, load (the port's copy of
``mindaudio_tpu.utils.cmvn``, pinned to it by
``tests/test_torch_recipe_infra.py``).

The JSON file keeps the accumulator's fields (``mean_stat``, ``var_stat``,
``frame_num``), so a stats file written by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["CMVNAccumulator", "save_cmvn", "load_cmvn"]

VAR_FLOOR = 1e-3  # near-constant feature dims would otherwise get istd ~ 1e10


class CMVNAccumulator:
    """Streaming sum and sum of squares over ``(N, T, F)`` feature batches."""

    def __init__(self, feat_dim: int):
        self.mean_stat = np.zeros(feat_dim, np.float64)
        self.var_stat = np.zeros(feat_dim, np.float64)
        self.frame_num = 0

    def update(self, feats, feat_lens=None):
        """Add the frames of ``feats``; only the first ``feat_lens[i]`` of
        row ``i`` when lengths are given."""
        feats = np.asarray(feats, np.float64)
        if feats.ndim == 2:
            feats = feats[None]
        if feat_lens is None:
            valid = feats.reshape(-1, feats.shape[-1])
        else:
            valid = np.concatenate([x[: int(n)] for x, n in zip(feats, np.asarray(feat_lens))],
                                   axis=0)
        self.mean_stat += valid.sum(0)
        self.var_stat += (valid**2).sum(0)
        self.frame_num += valid.shape[0]

    def finalize(self):
        return _mean_istd(self.mean_stat, self.var_stat, self.frame_num)


def _mean_istd(mean_stat, var_stat, frame_num):
    mean = np.asarray(mean_stat, np.float64) / frame_num
    var = np.asarray(var_stat, np.float64) / frame_num - mean**2
    istd = 1.0 / np.sqrt(np.maximum(var, VAR_FLOOR))
    return mean.astype(np.float32), istd.astype(np.float32)


def save_cmvn(path: str, acc: CMVNAccumulator):
    with open(path, "w") as f:
        json.dump({
            "mean_stat": acc.mean_stat.tolist(),
            "var_stat": acc.var_stat.tolist(),
            "frame_num": acc.frame_num,
        }, f)


def load_cmvn(path: str):
    """``(mean, istd)`` float32 arrays from a stats file."""
    with open(path) as f:
        stats = json.load(f)
    return _mean_istd(stats["mean_stat"], stats["var_stat"], stats["frame_num"])

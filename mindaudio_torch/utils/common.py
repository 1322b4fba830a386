"""Host-side batch-assembly helpers (port of ``mindaudio_tpu.utils.common``)."""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "IGNORE_ID",
    "pad_sequence",
    "add_sos_eos",
    "remove_duplicates_and_blank",
    "log_add",
]

IGNORE_ID = -1


def pad_sequence(sequences, padding_value=0, max_len=None):
    """Pad a list of 1-D/2-D arrays to a common (or given) length, batch first."""
    seqs = [np.asarray(s) for s in sequences]
    if max_len is None:
        max_len = max(s.shape[0] for s in seqs)
    trailing = seqs[0].shape[1:]
    out = np.full((len(seqs), max_len) + trailing, padding_value, dtype=seqs[0].dtype)
    for i, s in enumerate(seqs):
        out[i, : s.shape[0]] = s[:max_len]
    return out


def add_sos_eos(ys_pad, sos, eos, ignore_id=IGNORE_ID):
    """Decoder input (``<sos> y``, eos-padded) and target (``y <eos>``,
    ``ignore_id``-padded) batches of shape ``(B, L + 1)``."""
    ys_pad = np.asarray(ys_pad)
    b, length = ys_pad.shape
    ys_in = np.full((b, length + 1), eos, dtype=ys_pad.dtype)
    ys_out = np.full((b, length + 1), ignore_id, dtype=ys_pad.dtype)
    ys_in[:, 0] = sos
    for i in range(b):
        valid = ys_pad[i][ys_pad[i] != ignore_id]
        n = len(valid)
        ys_in[i, 1 : 1 + n] = valid
        ys_out[i, :n] = valid
        ys_out[i, n] = eos
    return ys_in, ys_out


def remove_duplicates_and_blank(hyp, blank_id=0):
    """Collapse repeats then drop blanks (CTC greedy post-process)."""
    out = []
    prev = None
    for t in hyp:
        if t != prev and t != blank_id:
            out.append(int(t))
        prev = t
    return out


def log_add(args):
    """Numerically-stable log-sum-exp over a Python list."""
    if all(a == -float("inf") for a in args):
        return -float("inf")
    a_max = max(args)
    return a_max + math.log(sum(math.exp(a - a_max) for a in args))

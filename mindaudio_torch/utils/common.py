"""Host-side batch-assembly helpers and model utilities (port of
``mindaudio_tpu.utils.common``)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

__all__ = [
    "IGNORE_ID",
    "pad_sequence",
    "add_sos_eos",
    "add_blank",
    "remove_duplicates_and_blank",
    "log_add",
    "get_parameter_numel",
    "get_activation",
    "get_subsample",
    "get_feat_extract_output_lengths",
    "set_weight_decay",
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


def add_blank(ys_pad, blank, ignore_id=IGNORE_ID):
    """Interleave CTC blanks: ``y -> blank y1 blank y2 ... blank``; the
    ``ignore_id`` padding becomes ``blank`` too."""
    ys_pad = np.asarray(ys_pad)
    b, length = ys_pad.shape
    out = np.full((b, 2 * length + 1), blank, dtype=ys_pad.dtype)
    out[:, 1::2] = np.where(ys_pad == ignore_id, blank, ys_pad)
    return out


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


def get_parameter_numel(params):
    """Total number of parameters of a module (its ``parameters()``) or of a
    state dict / any mapping of tensors and arrays."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(np.shape(v))) for v in params.values())


def get_activation(act):
    """Activation function by name: ``tanh``, ``relu``, ``swish`` (SiLU) or
    ``gelu`` (its tanh approximation, ``jax.nn.gelu``'s default)."""
    funcs = {
        "tanh": torch.tanh,
        "relu": F.relu,
        "swish": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }
    return funcs[act]


def get_subsample(config):
    """Subsampling factor of an encoder config dict: ``conv2d`` → 4,
    ``conv2d6`` → 6, ``conv2d8`` → 8."""
    input_layer = config["encoder_conf"]["input_layer"]
    factors = {"conv2d": 4, "conv2d6": 6, "conv2d8": 8}
    if input_layer not in factors:
        raise ValueError(f"unknown input_layer {input_layer!r}")
    return factors[input_layer]


def get_feat_extract_output_lengths(input_length, kernel_size, stride):
    """Sequence length after a stack of valid convs; ints, arrays or tensors."""
    len_ds = input_length
    for k, s in zip(kernel_size, stride):
        len_ds = (len_ds - k) // s + 1
    return len_ds


def set_weight_decay(named_parameters):
    """``(decay, no_decay)`` lists of parameter names, the JAX rule: no decay
    for a name that contains ``bias`` or ``norm`` (case-insensitive; biases
    and LayerNorm scales), decay for the rest. ``train.optim.AdamW`` takes the
    ``decay`` list as its ``decay=``."""
    decay, no_decay = [], []
    for name, _ in named_parameters:
        parts = name.lower().split(".")
        skip = any("bias" in k for k in parts) or any("norm" in k for k in parts)
        (no_decay if skip else decay).append(name)
    return decay, no_decay

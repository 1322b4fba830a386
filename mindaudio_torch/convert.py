"""JAX (flax) parameters → the port's ``state_dict``.

The port's module names follow the flax ones, with five renames
(``Dense_0``/``Dense_1`` of the feed-forward blocks are ``w_1``/``w_2``,
the subsampling's ``Conv_0``/``Conv_1`` are ``conv1``/``conv2``,
Conv-TasNet's ``PReLU_0`` is ``prelu``) and ``layer_<i>`` becoming
``layers.<i>`` of an ``nn.ModuleList``. Leaves change layout as PyTorch
wants it:

- Dense ``kernel`` ``(in, out)`` → ``Linear.weight`` ``(out, in)``;
- Conv2d ``kernel`` HWIO → OIHW;
- Conv1d ``kernel`` ``(k, Cin, Cout)`` → ``(Cout, Cin, k)`` (depthwise:
  ``(k, 1, C)`` → ``(C, 1, k)``);
- ECAPA-TDNN's cosine ``Classifier`` ``weight`` keeps flax's ``(lin, out)``;
- LayerNorm and BatchNorm ``scale`` → ``weight``; Embed ``embedding`` →
  ``weight``;
- DeepSpeech2's BiLSTM ``wx (2, D, 4H)`` / ``wh (2, H, 4H)`` →
  ``weight_ih (2, 4H, D)`` / ``weight_hh (2, 4H, H)``;
- flax's ``OptimizedLSTMCell_<n>`` (TasNet's; gates ``ii``/``if``/``ig``/
  ``io`` without bias and ``hi``/``hf``/``hg``/``ho`` with one): cell
  ``2i + d`` is direction ``d`` of the port's ``lstm_<i>`` (a BiLSTM), its
  kernels transposed and stacked in the gate order i, f, g, o into
  ``weight_ih[d]`` and ``weight_hh[d]``, the ``h*`` biases into
  ``bias[d]``; a cell whose leaves are not exactly those twelve, or a
  layer with one direction, raises;
- Conv-TasNet's layer norms' ``gamma``/``beta`` ``(1, 1, C)`` → ``(C,)``;
  PReLU's ``negative_slope`` ``()`` → ``weight (1,)``;
- ``bias``, ``pos_bias_u`` and ``pos_bias_v`` are carried across, and so
  are the MoE layer's ``gate``, ``w1``, ``b1``, ``w2``, ``b2`` (the port
  keeps their flax layouts);
- with ``batch_stats``, a batch norm's ``mean``/``var`` → its
  ``running_mean``/``running_var`` buffers;
- a leaf of any other name raises.

FastSpeech2's ``enc_<i>``/``dec_<i>`` blocks keep their flax names in the
port. The JAX FastSpeech2 recipe saves the parameters of
``FastSpeech2WithLoss``, the model under the scope ``model``:
:func:`unwrap_model_scope` takes the model's own tree out of such a tree.

The AdamW moments have the parameters' tree, so :func:`convert_adamw_state`
carries an optax state across by the same rules.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["module_name", "convert_params", "convert_adamw_state", "unwrap_model_scope"]

_RENAME = {"Dense_0": "w_1", "Dense_1": "w_2", "Conv_0": "conv1", "Conv_1": "conv2",
           "PReLU_0": "prelu"}
_KERNEL_LAYOUT = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
# the MoE layer's router and expert stacks keep flax's names and layouts
_CARRIED = {"bias", "pos_bias_u", "pos_bias_v", "weight", "running_mean", "running_var",
            "gate", "w1", "b1", "w2", "b2"}


def module_name(path):
    """Flax module path tuple (as ``quantize_dense_params`` keys it) → the
    port's dotted module name, e.g. ``('encoder', 'layer_0', 'self_attn',
    'linear_q')`` → ``'encoder.layers.0.self_attn.linear_q'``."""
    out = []
    for key in path:
        if key.startswith("layer_") and key[6:].isdigit():
            out += ["layers", key[6:]]
        else:
            out.append(_RENAME.get(key, key))
    return ".".join(out)


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


_LSTM = {"wx": "weight_ih", "wh": "weight_hh"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_CELL = re.compile(r"^OptimizedLSTMCell_(\d+)$")
_CELL_LEAVES = {(f"{side}{g}", "kernel") for side in "ih" for g in "ifgo"} | {
    (f"h{g}", "bias") for g in "ifgo"}


def _gates(cell, side, leaf):
    """One cell's ``<side>i``, ``<side>f``, ``<side>g``, ``<side>o`` leaves
    stacked along the output axis: kernels ``(in, H)`` → ``(4H, in)``,
    biases → ``(4H,)``."""
    arrs = [np.asarray(cell[(side + g, leaf)], np.float32) for g in "ifgo"]
    return np.concatenate([a.T if leaf == "kernel" else a for a in arrs])


def _lstm_cells(leaves):
    """Split the leaves of flax ``OptimizedLSTMCell_<n>`` modules off
    ``leaves``; returns ``(the other leaves, {key: tensor})`` with the
    cells stacked into the port's BiLSTM parameters."""
    cells, rest = {}, []
    for path, leaf in leaves:
        match = _CELL.match(path[-3]) if len(path) >= 3 else None
        if match is None:
            rest.append((path, leaf))
        else:
            cells.setdefault((path[:-3], int(match.group(1))), {})[path[-2:]] = leaf
    layers = {}
    for (scope, n), cell in sorted(cells.items()):
        if set(cell) != _CELL_LEAVES:
            raise ValueError(f"convert_params: OptimizedLSTMCell_{n} has leaves "
                             f"{sorted(cell)}, not {sorted(_CELL_LEAVES)}")
        layers.setdefault((scope, n // 2), {})[n % 2] = cell
    state = {}
    for (scope, i), dirs in layers.items():
        if set(dirs) != {0, 1}:
            raise ValueError(f"convert_params: LSTM layer {i} has directions {sorted(dirs)}")
        prefix = ".".join(filter(None, (module_name(scope), f"lstm_{i}")))
        for name, side, leaf in (("weight_ih", "i", "kernel"), ("weight_hh", "h", "kernel"),
                                 ("bias", "h", "bias")):
            arr = np.stack([_gates(dirs[d], side, leaf) for d in (0, 1)])
            state[f"{prefix}.{name}"] = torch.from_numpy(arr)
    return rest, state


def convert_params(params, batch_stats=None):
    """Nested dict of arrays (``model.init(...)["params"]``, and optionally
    its ``"batch_stats"``) → float32 ``state_dict`` tensors (CPU) keyed by the
    port's parameter and buffer names."""
    leaves = list(_flatten(params))
    if batch_stats is not None:
        leaves += [(path[:-1] + (_STATS[path[-1]],), leaf) for path, leaf in _flatten(batch_stats)]
    leaves, state = _lstm_cells(leaves)
    for path, leaf in leaves:
        arr = np.asarray(leaf, dtype=np.float32)
        *mod, leaf_name = path
        if leaf_name == "kernel":
            arr, leaf_name = arr.transpose(_KERNEL_LAYOUT[arr.ndim]), "weight"
        elif leaf_name in _LSTM:
            arr, leaf_name = arr.transpose(0, 2, 1), _LSTM[leaf_name]
        elif leaf_name in ("scale", "embedding"):
            leaf_name = "weight"
        elif leaf_name in ("gamma", "beta"):
            arr = arr.reshape(-1)
        elif leaf_name == "negative_slope":
            arr, leaf_name = arr.reshape(1), "weight"
        elif leaf_name not in _CARRIED:
            raise ValueError(f"convert_params: no rule places the leaf {'/'.join(path)}")
        key = ".".join(filter(None, (module_name(mod), leaf_name)))
        state[key] = torch.from_numpy(np.array(arr, order="C"))
    return state


def unwrap_model_scope(params):
    """The tree under ``model`` when ``params`` has that key (a
    ``FastSpeech2WithLoss`` tree, as the JAX recipe saves it), else
    ``params``: the JAX recipe's ``generate`` reads both layouts so."""
    return params["model"] if "model" in params else params


def convert_adamw_state(opt_state):
    """State of ``optax.adamw`` (its chain's tuple, or the ``ScaleByAdamState``
    itself, leaves readable by numpy) → ``{"count", "mu", "nu"}`` for
    ``train.optim.AdamW.load_state_dict``: the moments keyed and laid out as
    :func:`convert_params` does the parameters, in float32 (the optimizer
    casts the first moment back to its ``mu_dtype``)."""
    states = opt_state if isinstance(opt_state, (tuple, list)) and not hasattr(
        opt_state, "mu") else [opt_state]
    adam = next((s for s in states if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("convert_adamw_state: no state with mu and nu in opt_state")
    return {"count": torch.tensor(int(adam.count), dtype=torch.int32),
            "mu": convert_params(adam.mu), "nu": convert_params(adam.nu)}

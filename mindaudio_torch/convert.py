"""JAX (flax) parameters → the port's ``state_dict``.

The port's module names follow the flax ones, with four renames
(``Dense_0``/``Dense_1`` of the feed-forward blocks are ``w_1``/``w_2``,
the subsampling's ``Conv_0``/``Conv_1`` are ``conv1``/``conv2``) and
``layer_<i>`` becoming ``layers.<i>`` of an ``nn.ModuleList``. Leaves
change layout as PyTorch wants it:

- Dense ``kernel`` ``(in, out)`` → ``Linear.weight`` ``(out, in)``;
- Conv2d ``kernel`` HWIO → OIHW;
- depthwise Conv1d ``kernel`` ``(k, 1, C)`` → ``(C, 1, k)``;
- LayerNorm ``scale`` → ``weight``; Embed ``embedding`` → ``weight``;
- ``bias``, ``pos_bias_u`` and ``pos_bias_v`` are carried across.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["module_name", "convert_params"]

_RENAME = {"Dense_0": "w_1", "Dense_1": "w_2", "Conv_0": "conv1", "Conv_1": "conv2"}
_KERNEL_LAYOUT = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


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


def convert_params(params):
    """Nested dict of arrays (``model.init(...)["params"]``) → float32
    ``state_dict`` tensors (CPU) keyed by the port's parameter names."""
    state = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        *mod, leaf_name = path
        if leaf_name == "kernel":
            arr, leaf_name = arr.transpose(_KERNEL_LAYOUT[arr.ndim]), "weight"
        elif leaf_name in ("scale", "embedding"):
            leaf_name = "weight"
        key = ".".join(filter(None, (module_name(mod), leaf_name)))
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state

"""The MoE Conformer family: the Conformer family's recipe driving, corpus
and batches (``families/conformer.py``, loaded here as a module of its own)
with the MoE reference (``reference/conformer_moe.py``) in place of the dense
one, for the seeded weights and for the readings that decide ``correct``.

Set-up first checks that the port has the dropless MoE layer and the
macaron option (``MoEFeedForward.dropless``, ``ConformerEncoderLayer``'s
``moe_macaron``), and raises at once where it has not. The model FLOPs of a
step (``train_mfu``) are the dense model's at the step's padded shapes with
each encoder FFN counted as its ``k`` experts on the valid frames and the
router on every frame: the meta device cannot route.
"""

from __future__ import annotations

import inspect
from pathlib import Path

from portbench.harness import load_module
from portbench.reference.conformer_moe import ConformerMoE

_dense = load_module(Path(__file__).with_name("conformer.py"),
                     "portbench_family_conformer_moe_base")


def reference_model(config):
    return ConformerMoE(**config["model"])


_dense.reference_model = reference_model
Trainer, shape, reference_readings = _dense.Trainer, _dense.shape, _dense.reference_readings


def require_dropless():
    """Raise unless the port has the dropless MoE layer and the macaron
    option this configuration trains."""
    from mindaudio_torch.models.conformer import ConformerEncoderLayer
    from mindaudio_torch.parallel.moe import MoEFeedForward

    if not hasattr(MoEFeedForward, "dropless") or "moe_macaron" not in inspect.signature(
            ConformerEncoderLayer).parameters:
        raise RuntimeError("the port has no dropless MoE layer with a macaron MoE "
                           "(MoEFeedForward.dropless, ConformerEncoderLayer(moe_macaron=...))")


def corpus(config, cell, seed, device, root=None):
    require_dropless()
    return _dense.corpus(config, cell, seed, device, root)


def moe_ffns(model):
    """The number of MoE FFNs in the encoder."""
    return model["num_encoder_layers"] * (2 if model.get("moe_macaron") else 1)


def flops(config, s):
    """Model FLOPs of one step at shape ``s`` (forward and backward): the
    dense model's, with each MoE FFN's ``12 D H`` a frame counted on ``k``
    experts a valid frame in place of one a padded frame, and the float32
    router's ``6 D E`` a padded frame added."""
    model = config["model"]
    dense = dict(config, model={k: v for k, v in model.items() if not k.startswith("moe_")})
    frames = s["rows"] * s["enc_frames"]
    d, h, e, k = model["d_model"], model["ffn_dim"], model["moe_experts"], model["moe_top_k"]
    per_ffn = 12 * d * h * (k * s["enc_valid"] - frames) + 6 * d * e * frames
    return _dense.flops(dense, s) + moe_ffns(model) * per_ffn

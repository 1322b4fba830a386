"""The expert products' least time: a dropless MoE FFN of ``E`` experts runs
six grouped products an application over its ``rows = k x valid frames``
assignments (forward: ``(rows, D) x (D, H)`` and ``(rows, H) x (H, D)``;
backward: each one's input gradient and weight gradient), each
``2 rows D H`` FLOPs, reading its two operands and writing its result once
in bf16 (``2 (rows D + rows H + E D H)`` bytes, the expert matrices counted
once); a product's least time is the larger of its FLOPs at the bf16 peak
and its bytes at the memory bandwidth."""

from __future__ import annotations

from .peaks import BF16_FLOP_PER_S, BYTES_PER_S


def product_bound_s(rows, d, h, experts):
    """Least seconds of one grouped product over ``rows`` assignments."""
    flops = 2 * rows * d * h
    nbytes = 2 * (rows * d + rows * h + experts * d * h)
    return max(flops / BF16_FLOP_PER_S, nbytes / BYTES_PER_S)


def step_bound_s(model, enc_valid):
    """Least seconds of one train step's expert products: every MoE FFN of
    the encoder (``model``: a configuration's model keys), six products
    each, over ``k x enc_valid`` assignments."""
    ffns = model["num_encoder_layers"] * (2 if model.get("moe_macaron") else 1)
    rows = model["moe_top_k"] * enc_valid
    return ffns * 6 * product_bound_s(rows, model["d_model"], model["ffn_dim"],
                                      model["moe_experts"])

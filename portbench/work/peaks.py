"""Published peaks of one NVIDIA H100 (the SXM part's data sheet, dense
rates without sparsity, at its 700 W limit)."""

BYTES_PER_S = 3.35e12  # HBM3
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores
INT8_OP_PER_S = 1979e12

PEAKS = {"bf16": BF16_FLOP_PER_S, "tf32": TF32_FLOP_PER_S, "f32": F32_FLOP_PER_S,
         "int8": INT8_OP_PER_S}

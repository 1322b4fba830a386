"""``moe_gemm_roofline``: the MoE layer's grouped GEMM (``ops/grouped_gemm``,
CUDA kernels ``grouped_gemm_kernel``, ``grouped_gemm_wgrad_kernel`` and its
sum over row chunks, ``grouped_gemm_wgrad_reduce_kernel``) against its roofline over the traced window: the summed least time of each
traced step's expert products (``work/moe.py``: six products for each MoE
FFN over ``k x enc_valid`` assignments) over the summed device time of the
kernels named below, in %."""

from portbench.work.moe import step_bound_s

MOVES = "train_audio_s_per_s"
KERNELS = ("grouped_gemm_kernel", "grouped_gemm_wgrad_kernel", "grouped_gemm_wgrad_reduce_kernel")


def read(r):
    seconds = r["trace"].op_seconds(KERNELS)
    if seconds <= 0:
        return None
    model = r["config"]["model"]
    return 100.0 * sum(step_bound_s(model, s["enc_valid"]) for s in r["steps"]) / seconds

"""``ctc_roofline``: the CTC kernel pair (``ops/ctc_dp`` ->
``ops/csrc/ctc_dp.cu``) against its roofline over the traced window: the
summed least time of each step's pair at its shapes (``work/ctc.py``, bound
by bytes) over the summed device time of the kernels named below, in %."""

from portbench.work.ctc import pair_bound_s

MOVES = "train_audio_s_per_s"
KERNELS = ("ctc_fwd_", "ctc_bwd_")


def read(r):
    seconds = r["trace"].op_seconds(KERNELS)
    if seconds <= 0:
        return None
    bound = sum(pair_bound_s(s["rows"], s["enc_frames"], s["enc_valid"], s["labels"])
                for s in r["steps"])
    return 100.0 * bound / seconds

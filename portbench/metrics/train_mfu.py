"""``train_mfu``: model FLOPs of the traced steps (forward and backward, no
recomputation, counted on the reference at each step's padded shapes by
``work/flops.py``) over the traced window's wall time and the
configuration's declared peak (``peak`` in its file: bf16 or TF32 of
``work/peaks.py``), in %."""

from portbench.work.peaks import PEAKS

MOVES = "train_audio_s_per_s"


def read(r):
    trace, steps = r["trace"], r["steps"]
    if not trace.ops or not steps:
        return None
    counted = {}
    total = 0
    for s in steps:
        key = tuple(sorted(s.items()))
        if key not in counted:
            counted[key] = r["family"].flops(r["config"], s)
        total += counted[key]
    return 100.0 * total / trace.window_s / PEAKS[r["config"]["peak"]]

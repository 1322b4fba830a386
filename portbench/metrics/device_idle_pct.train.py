"""``device_idle_pct.train``: the share of the traced window in which no
operation ran on the device, ``1 - union of the device operations'
intervals / window``, in %."""

MOVES = "train_audio_s_per_s"


def read(r):
    trace = r["trace"]
    if not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

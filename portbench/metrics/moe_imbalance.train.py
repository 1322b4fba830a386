"""``moe_imbalance.train``: how unevenly the router loads the experts in the
traced window: for each MoE application the program recorded there
(``train.profiler.moe_timeline``: the assignments to each expert), the
largest expert's count over the mean count, averaged over the applications;
1 is an even load, ``E / k`` every frame on the same experts. The grouped
GEMM's tail follows the largest group."""

MOVES = "train_audio_s_per_s"


def read(r):
    try:
        from mindaudio_torch.train.profiler import moe_timeline
    except ImportError:
        return None
    trace = r["trace"]
    ratios = [max(counts) * len(counts) / sum(counts)
              for _, counts in moe_timeline(trace.t0, trace.t1) if sum(counts)]
    return sum(ratios) / len(ratios) if ratios else None

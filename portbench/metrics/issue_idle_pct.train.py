"""``issue_idle_pct.train``: the share of the traced window in which the
device is idle while the host is inside the program's train step,
``100 x |idle ∩ union of the train.step spans| / window``, in %. Idle is the
window less the union of the device operations' intervals
(``Trace.busy``); the spans are the program's own
(``mindaudio_torch.train.profiler.timeline``), on the main thread.
:func:`by_phase` splits that idle time by the step's phase spans.

The helpers :func:`spans` and :func:`idle_ns` serve the other readers of the
program's timeline too."""

import threading

from portbench.harness import merged

MOVES = "train_audio_s_per_s"
PHASES = ("train.features", "train.forward", "train.backward", "train.sync_grads",
          "train.clip", "train.update")


def spans(names, t0, t1=None, main=True):
    """``(name, thread id, start_ns, end_ns)`` of the program's spans named in
    ``names`` that overlap ``[t0, t1]`` (``t1`` None: open), recorded on the
    main thread (``main``) or on any other; none where the program keeps no
    timeline."""
    try:
        from mindaudio_torch.train.profiler import timeline
    except ImportError:
        return []
    main_id = threading.main_thread().ident
    return [s for s in timeline(t0, t1) if s[0] in names and (s[1] == main_id) == main]


def idle_ns(trace, intervals):
    """Nanoseconds of the window in which the device is idle and some
    interval of ``intervals`` (``(start, end)`` pairs) is open, each moment
    counted once."""
    held = merged([(max(a, trace.t0), min(b, trace.t1)) for a, b in intervals
                   if b > trace.t0 and a < trace.t1])
    busy, j, overlap = trace.busy, 0, 0
    for a, b in held:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            overlap += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return sum(b - a for a, b in held) - overlap


def read(r):
    trace = r["trace"]
    steps = spans({"train.step"}, trace.t0, trace.t1)
    if not trace.ops or not steps:
        return None
    return 100.0 * idle_ns(trace, [(a, b) for _, _, a, b in steps]) / (trace.t1 - trace.t0)


def by_phase(r):
    """Idle ms of the window within each phase span of the step that the
    timeline holds, and within ``train.step`` outside every phase (the key
    ``train.step``)."""
    trace = r["trace"]
    found = spans({"train.step", *PHASES}, trace.t0, trace.t1)
    out = {name: idle_ns(trace, [(a, b) for n, _, a, b in found if n == name]) / 1e6
           for name in PHASES if any(s[0] == name for s in found)}
    step = idle_ns(trace, [(a, b) for n, _, a, b in found if n == "train.step"])
    phases = idle_ns(trace, [(a, b) for n, _, a, b in found if n != "train.step"])
    out["train.step"] = (step - phases) / 1e6
    return out

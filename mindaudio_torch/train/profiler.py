"""Profiling and per-step timing (port of ``mindaudio_tpu.train.profiler``):
``torch.profiler`` traces for TensorBoard or Perfetto, the program's named
spans on their timeline, the dropout's count of fused and plain
applications, the MoE layer's counts of its routing, and a host-side step
timer with an ETA."""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch

from ..ops import fused_dropout
from ..parallel import moe

__all__ = ["trace", "annotate", "timeline", "dropout_counts", "reset_dropout_counts",
           "moe_counts", "reset_moe_counts", "moe_timeline", "StepTimer"]

# the spans recorded while a profiler session records: (name, thread id,
# start_ns, end_ns) on the wall clock, the newest 2**17 kept
_SPANS = collections.deque(maxlen=1 << 17)
_OFF = contextlib.nullcontext()
# torch's own flag, set while any profiler session records
_autograd_profiler = torch.autograd.profiler


@contextlib.contextmanager
def trace(log_dir):
    """Trace the enclosed steps, host and (where there is one) the CUDA
    device, into a Chrome trace under ``log_dir`` (open it in Perfetto or
    ``chrome://tracing``). Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class _Span:
    """One recorded span: a ``record_function`` range, and an entry of the
    timeline when it closes."""

    __slots__ = ("name", "_range", "_start")

    def __init__(self, name):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        _SPANS.append((self.name, threading.get_ident(), self._start, end))
        return False


def annotate(name):
    """A named span of the host's work. While a ``torch.profiler`` session
    records (whatever its activities), the span is kept for :func:`timeline`
    on the wall clock (``time.time_ns()``, the clock the profiler puts the
    device's operations on) and shows as a ``record_function`` range in the
    session's trace. Otherwise it is a shared no-op that costs one read of
    the profiler's flag. A span reads no device state and never
    synchronises."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def timeline(t0_ns=None, t1_ns=None):
    """The recorded spans ``(name, thread id, start_ns, end_ns)`` that
    overlap ``[t0_ns, t1_ns]`` (``None``: that side open), in the order they
    closed."""
    return [s for s in list(_SPANS)
            if (t0_ns is None or s[3] > t0_ns) and (t1_ns is None or s[2] < t1_ns)]


def dropout_counts():
    """``{"fused": n, "plain": m}``: the training-mode applications of
    ``models.layers.FastDropout`` (those that draw bytes: rate above 0) since
    the last :func:`reset_dropout_counts`, by whether they ran through the
    fused kernels (``ops.fused_dropout``) or PyTorch's plain chain. Read it
    beside :func:`timeline` to see whether the fused path engages; a
    rematerialized block counts its recomputation again."""
    return dict(fused_dropout.applications)


def reset_dropout_counts():
    """Set both counts of :func:`dropout_counts` to 0."""
    for key in fused_dropout.applications:
        fused_dropout.applications[key] = 0


def moe_counts():
    """``{"applications": n, "assigned": [...], "dropped": d}``: the
    applications of ``parallel.moe.MoEFeedForward`` since the last
    :func:`reset_moe_counts`, the router's assignments to each expert summed
    over them (a token counts once for each of its top-k experts; padding
    none) and the assignments the capacity dropped (always 0 on the dropless
    path). The sums are kept on the device, added to without a
    synchronisation inside the step; reading them here waits for the
    device."""
    total, dropped = moe.counters["assigned"], moe.counters["dropped"]
    return {"applications": moe.counters["applications"],
            "assigned": [] if total is None else total.tolist(),
            "dropped": 0 if dropped is None else int(dropped)}


def reset_moe_counts():
    """Zero :func:`moe_counts` and forget :func:`moe_timeline`'s records."""
    moe.counters.update(applications=0, assigned=None, dropped=None)
    moe.records.clear()


def moe_timeline(t0_ns=None, t1_ns=None):
    """``(time_ns, [assignments per expert])`` of every MoE application
    made while a ``torch.profiler`` session recorded, at a wall-clock time
    within ``[t0_ns, t1_ns]`` (``None``: that side open), in order; the
    counts are read from the device here."""
    return [(t, counts.tolist()) for t, counts in list(moe.records)
            if (t0_ns is None or t >= t0_ns) and (t1_ns is None or t <= t1_ns)]


class StepTimer:
    """Wall-clock time per step and ETA, the first ``warmup`` steps (the
    kernels' build and first launches) left out of the average. Use it as
    ``with timer: step(...)``; once the process has used CUDA its exit waits
    for the device before it reads the clock, so a step is timed to its end
    and not to its last enqueue."""

    def __init__(self, total_steps=None, warmup=1):
        self.total_steps = total_steps
        self.warmup = warmup
        self.count = 0
        self._t0 = None
        self._elapsed = 0.0
        self._last = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._last = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self._elapsed += self._last

    @property
    def last_ms(self):
        return self._last * 1e3

    @property
    def avg_ms(self):
        steady = max(self.count - self.warmup, 1)
        return self._elapsed / steady * 1e3

    @property
    def eta_s(self):
        if not self.total_steps or self.count <= self.warmup:
            return None
        return (self.total_steps - self.count) * self.avg_ms / 1e3

    def summary(self):
        eta = self.eta_s
        return (f"step {self.count}: {self.last_ms:.1f} ms "
                f"(avg {self.avg_ms:.1f} ms"
                + (f", ETA {eta / 60:.1f} min" if eta is not None else "") + ")")

"""Profiling and per-step timing (port of ``mindaudio_tpu.train.profiler``):
``torch.profiler`` traces for TensorBoard or Perfetto, named regions on
their timeline, and a host-side step timer with an ETA."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate", "StepTimer"]


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


def annotate(name):
    """A named region that shows on the trace's timeline."""
    return torch.profiler.record_function(name)


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

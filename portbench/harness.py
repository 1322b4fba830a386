"""What every cell shares: its files found by name, the device's record, the
host's spans, the reduction of a ``torch.profiler`` trace, the numbers that
decide ``correct``, and the result line.

A cell ``<cell>`` is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its driver (``drivers/<kind>.py``); a
configuration names its family (``families/<family>.py``). A per-layer
metric ``<metric>`` is ``metrics/<metric>.py``. ``BENCHMARK.json`` at the
root of the checkout says which metrics each cell reports. Adding a cell, a
configuration or a metric adds files and entries and edits none of these.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "mindaudio_tpu")


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path, name):
    """The Python file ``path`` as a module named ``name`` (metric files
    carry dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """The files of one benchmark tree: ``root/BENCHMARK.json`` and
    ``root/portbench/...`` (a test points it at a copy)."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name):
        cell = load_json(self.dir / "workloads" / f"{name}.json")
        return dict(cell, name=name)

    def config(self, name):
        return dict(load_json(self.dir / "configs" / f"{name}.json"), name=name)

    def driver(self, kind):
        return load_module(self.dir / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")

    def family(self, name):
        return load_module(self.dir / "families" / f"{name}.py", f"portbench_family_{name}")

    def reader(self, metric):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))

    def end_to_end(self, cell):
        """The cell's end-to-end metrics, as ``BENCHMARK.json`` lists them."""
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell):
        """The cell's per-layer metrics: those that list it, and those
        without a list that move an end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


class Spans:
    """Host spans named by layer: each ``with spans("name")`` adds one
    duration in seconds to ``durations[name]``; with ``timeline`` each span
    is also kept as ``(name, start_ns, end_ns)`` on the wall clock, the
    clock ``torch.profiler`` puts the device's operations on, so that a
    trace can tell what the host was doing in each of the device's idle
    gaps."""

    def __init__(self, timeline=False):
        self.durations = {}
        self.timeline = [] if timeline else None

    @contextlib.contextmanager
    def __call__(self, name):
        wall, t0 = time.time_ns(), time.perf_counter()
        yield
        self.durations.setdefault(name, []).append(time.perf_counter() - t0)
        if self.timeline is not None:
            self.timeline.append((name, wall, time.time_ns()))


def merged(intervals):
    """The union of ``(start, end)`` intervals, as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


class Trace:
    """A ``torch.profiler`` capture of the device's operations (kernels,
    copies, sets) with the benchmark's host spans (:class:`Spans` with a
    timeline), cut to the traced window (the span ``window``); times in ns
    on the wall clock. The profiler records the device alone, so that its
    own cost on the host (it grows with every operator it records) does not
    stretch the window it measures."""

    def __init__(self, prof, spans):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ops = [] if prof is None else [
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
        windows = [s for s in spans.timeline if s[0] == "window"]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
        _, self.t0, self.t1 = windows[0]
        self.spans = [s for s in spans.timeline if s[0] != "window"]
        self.ops = [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in ops
                    if b > self.t0 and a < self.t1]
        self.busy = merged([(a, b) for _, a, b in self.ops])

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self):
        """Seconds in which some operation ran on the device: the union of
        the operations' intervals, so that overlapping streams count once."""
        return sum(b - a for a, b in self.busy) / 1e9

    def op_seconds(self, names):
        """Summed device seconds of the operations whose name contains one
        of ``names`` (a kernel's name as traced: ``void ctc_fwd_...<2>(...)``)."""
        return sum(b - a for n, a, b in self.ops if any(k in n for k in names)) / 1e9

    def breakdown(self, top=10):
        """The contract's ``breakdown``: the device operations that took the
        most time, and the longest idle gaps, each named by the innermost
        benchmark span the host was in when the gap began."""
        by_name = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:top]:
            inside = [s for s in self.spans if s[1] <= a < s[2]]
            label = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "outside spans"
            named.append([label, (b - a) / 1e9])
        return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": named}


class Check:
    """One number compared for ``correct``, with its limit (a number above
    its limit fails)."""

    def __init__(self, name, value, limit):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self):
        return math.isfinite(self.value) and self.value <= self.limit


def leaf_gaps(program, reference, keep):
    """The gap of per-leaf norms, leaf by leaf: ``|p - r| / max(r, median
    r)`` over the leaves ``keep`` names (``program`` and ``reference`` map a
    leaf's name to its norm)."""
    median = statistics.median(reference[n] for n in keep)
    return [abs(program[n] - reference[n]) / max(reference[n], median, 1e-30) for n in keep]


def forbidden_modules():
    """Modules of JAX or the JAX package that this process holds, compared
    by whole top-level names."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def device_record(torch, count):
    """The result line's ``device``: the card's name, the cards used and the
    peak of allocated memory."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None):
    """The contract's last line of standard output, with the compared
    numbers last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)

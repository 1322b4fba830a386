"""The program's spans (``train.profiler.annotate`` and ``timeline``): off
without a profiler session, recorded on the wall clock with their threads
under one, placed in the train step's phases and in ``train.prefetch``'s
worker and consumer; and, on the card, on the device trace's clock.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. On the card::

    python -m pytest --noconftest -p no:cacheprovider -s -m cuda tests/test_torch_timeline.py
"""

import collections
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mindaudio_torch.parallel.mesh import Mesh
from mindaudio_torch.train import profiler as tprof
from mindaudio_torch.train.optim import AdamW
from mindaudio_torch.train.prefetch import prefetch
from mindaudio_torch.train.state import make_train_step


def cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def test_annotate_off_records_nothing(monkeypatch):
    """Without a session: the shared no-op, no clock read, no
    ``record_function``, nothing kept."""
    def boom(*args, **kwargs):
        raise AssertionError("touched while no session records")

    monkeypatch.setattr(tprof.torch.profiler, "record_function", boom)
    monkeypatch.setattr(tprof.time, "time_ns", boom)
    before = len(tprof.timeline())
    spans = [tprof.annotate("a"), tprof.annotate("b")]
    with spans[0], spans[1]:
        pass
    assert spans[0] is spans[1] is tprof._OFF
    monkeypatch.undo()
    assert len(tprof.timeline()) == before


def test_annotate_records_nested_spans_with_threads():
    """Nested spans on the main thread and one on another thread, each with
    its thread and on the wall clock, the ``record_function`` ranges in the
    session's own record."""
    def work():
        with tprof.annotate("test.worker"):
            time.sleep(0.002)

    t0 = time.time_ns()
    with cpu_session() as prof:
        with tprof.annotate("test.outer"):
            with tprof.annotate("test.inner"):
                (torch.ones(8) * 2).sum()
            thread = threading.Thread(target=work)
            thread.start()
            thread.join(timeout=10)
    t1 = time.time_ns()
    assert not thread.is_alive()
    got = {s[0]: s for s in tprof.timeline(t0, t1) if s[0].startswith("test.")}
    assert set(got) == {"test.outer", "test.inner", "test.worker"}
    main = threading.main_thread().ident
    assert got["test.outer"][1] == got["test.inner"][1] == threading.get_ident() == main
    assert got["test.worker"][1] == thread.ident != main
    _, _, a, b = got["test.outer"]
    assert t0 <= a <= got["test.inner"][2] <= got["test.inner"][3] <= b <= t1
    assert a <= got["test.worker"][2] and got["test.worker"][3] - got["test.worker"][2] >= 2e6
    assert {"test.outer", "test.inner"} <= {e.key for e in prof.key_averages()}


def test_timeline_keeps_the_spans_that_overlap_the_window(monkeypatch):
    spans = [("before", 1, 0, 10), ("crosses_start", 1, 5, 25), ("inside", 1, 30, 40),
             ("crosses_end", 2, 45, 70), ("after", 2, 60, 80), ("around", 1, 0, 90)]
    monkeypatch.setattr(tprof, "_SPANS", collections.deque(spans, maxlen=8))
    names = [s[0] for s in tprof.timeline(20, 50)]
    assert names == ["crosses_start", "inside", "crosses_end", "around"]
    assert [s[0] for s in tprof.timeline(50)] == ["crosses_end", "after", "around"]
    assert len(tprof.timeline()) == len(spans)


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 1)

    def forward(self, batch):
        loss = ((self.fc(batch["feats"]).squeeze(-1) - batch["y"]) ** 2).mean()
        return loss, {"aux": loss * 0}


@pytest.mark.parametrize("mesh", [None, Mesh({"data": 1, "model": 1, "seq": 1, "pipe": 1}, 0)],
                         ids=["one_process", "mesh_of_one"])
def test_train_step_records_its_phases_in_order(mesh):
    """``train.step`` holds its phases, in order, disjoint, on the caller's
    thread; ``train.sync_grads`` only over a mesh."""
    torch.manual_seed(0)
    model = Tiny()
    opt = AdamW(model.named_parameters(), 1e-2)
    step = make_train_step(model, opt, features_fn=lambda b: (b["x"] * 2, None),
                           grad_clip_norm=1.0, mesh=mesh)
    batch = {"x": torch.randn(5, 4), "y": torch.randn(5)}
    step(batch)  # off: records nothing
    t0 = time.time_ns()
    with cpu_session():
        metrics = step(batch)
    got = [s for s in tprof.timeline(t0) if s[0].startswith("train.")]
    assert torch.isfinite(metrics["loss"]) and "grad_norm" in metrics
    phases = ["train.features", "train.forward", "train.backward"]
    phases += ["train.sync_grads"] * (mesh is not None) + ["train.clip", "train.update"]
    outer = [s for s in got if s[0] == "train.step"]
    inner = sorted((s for s in got if s[0] != "train.step"), key=lambda s: s[2])
    assert len(outer) == 1 and [s[0] for s in inner] == phases
    _, thread, a, b = outer[0]
    assert thread == threading.get_ident() and all(s[1] == thread for s in inner)
    assert a <= inner[0][2] and inner[-1][3] <= b
    assert all(p[3] <= q[2] for p, q in zip(inner, inner[1:]))


def test_prefetch_records_worker_and_consumer_spans():
    """The worker records ``prefetch.produce`` then ``prefetch.stage`` for
    each item (and the produce that finds the iterator exhausted), the
    consumer ``prefetch.wait`` for each item and the end."""
    t0 = time.time_ns()
    with cpu_session():
        got = list(prefetch(iter(range(5)), size=2, transform=lambda x: x * 2))
    assert got == [0, 2, 4, 6, 8]
    spans = sorted((s for s in tprof.timeline(t0) if s[0].startswith("prefetch.")),
                   key=lambda s: s[2])
    main = threading.get_ident()
    worker = [s for s in spans if s[1] != main]
    assert [s[0] for s in worker] == ["prefetch.produce", "prefetch.stage"] * 5 + [
        "prefetch.produce"]
    assert len({s[1] for s in worker}) == 1
    assert [s[0] for s in spans if s[1] == main] == ["prefetch.wait"] * 6


@pytest.mark.cuda
def test_span_clock_matches_the_device_trace():
    """With the device idle, a kernel issued inside a span starts on the
    device after the span's start and within 1 ms of it, under a CUDA-only
    session (the benchmark's): the spans and the device trace share a
    clock. Prints the offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace's clock")
    torch.cuda._sleep(1000)  # the sleep kernel loaded before the session
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(5):
            torch.cuda.synchronize()
            time.sleep(0.005)
            with tprof.annotate(f"clock.{k}"):
                torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    starts = {s[0]: s[2] for s in tprof.timeline(t0) if s[0].startswith("clock.")}
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    kernels = sorted(e.start_ns() for e in events if "spin_kernel" in e.name())
    assert len(kernels) == 5 and len(starts) == 5, [e.name() for e in events]
    offsets = [kernels[k] - starts[f"clock.{k}"] for k in range(5)]
    print("span start to kernel start, ns:", offsets)
    assert all(0 < d < 1_000_000 for d in offsets), offsets

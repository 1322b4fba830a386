"""The readers of the program's spans (``issue_idle_pct.train``,
``data_idle_pct.train``, ``prefetch_worker_ms.train``) on a synthetic device
trace and a synthetic timeline: spans that cross the window's edges,
overlapping device streams counted once, nested spans counted once, and no
number without device operations, without spans, or from a program that
keeps no timeline."""

import collections
import threading

import pytest

from mindaudio_torch.train import profiler as tprof
from portbench.harness import Bench, Spans, Trace

from .test_portbench_harness import FakeEvent, FakeProf

NAMES = ("issue_idle_pct.train", "data_idle_pct.train", "prefetch_worker_ms.train")
WORKER = 7


def trace(ops=True):
    spans = Spans(timeline=True)
    spans.timeline.append(("window", 1000, 2000))
    events = [FakeEvent("gemm", 1100, 1300),
              FakeEvent("copy", 1200, 1400),  # a side stream, overlapping the gemm
              FakeEvent("ctc", 1700, 1900)] if ops else []
    return Trace(FakeProf(events), spans)  # idle: 1000-1100, 1400-1700, 1900-2000


def timeline():
    main = threading.main_thread().ident
    return [("train.step", main, 900, 1250),  # crosses the start
            ("train.forward", main, 1350, 1500),
            ("train.step", main, 1450, 1600),  # nested in the next step span
            ("train.backward", main, 1500, 1750),
            ("train.step", main, 1350, 1800),
            ("prefetch.wait", main, 1880, 2100),  # crosses the end
            ("prefetch.produce", WORKER, 950, 1000),  # starts before the window
            ("prefetch.stage", WORKER, 1000, 1010),
            ("prefetch.produce", WORKER, 1100, 1150),
            ("prefetch.stage", WORKER, 1150, 1250),
            ("prefetch.produce", WORKER, 1950, 1980),
            ("prefetch.stage", WORKER, 2000, 2100),  # starts at the window's end
            ("train.step", WORKER, 1000, 2000)]  # not the main thread's


@pytest.fixture
def readers(monkeypatch):
    monkeypatch.setattr(tprof, "_SPANS", collections.deque(timeline()))
    bench = Bench()
    return {n: bench.reader(n) for n in NAMES}


def test_the_entries_read_the_programs_spans():
    entries = {m["name"]: m for m in Bench().spec["per_layer"]}
    for name in NAMES:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["moves"] == "train_audio_s_per_s"
        assert entries[name]["workloads"] == ["conformer-train", "ds2-train"]


def test_idle_split_by_host_cause(readers):
    r = {"trace": trace()}
    device_idle = Bench().reader("device_idle_pct.train").read(r)
    issue = readers["issue_idle_pct.train"].read(r)
    data = readers["data_idle_pct.train"].read(r)
    assert device_idle == pytest.approx(50.0)
    assert issue == pytest.approx(40.0)  # 1000-1100 and 1400-1700, each once
    assert data == pytest.approx(10.0)  # 1900-2000
    assert issue + data <= device_idle + 1e-9


def test_by_phase(readers):
    split = readers["issue_idle_pct.train"].by_phase({"trace": trace()})
    assert split == pytest.approx({"train.forward": 100e-6, "train.backward": 200e-6,
                                   "train.step": 100e-6})


def test_prefetch_worker_ms(readers):
    # the batches whose produce starts in the window: 50 + 100 ns, 30 + 100 ns
    assert readers["prefetch_worker_ms.train"].read({"trace": trace()}) == pytest.approx(140e-6)


def test_nothing_without_ops_or_spans(readers, monkeypatch):
    for name in NAMES:
        assert readers[name].read({"trace": trace(ops=False)}) is None
    monkeypatch.setattr(tprof, "_SPANS", collections.deque())
    for name in NAMES:
        assert readers[name].read({"trace": trace()}) is None
    monkeypatch.delattr(tprof, "timeline")  # a program that keeps no timeline
    for name in NAMES:
        assert readers[name].read({"trace": trace()}) is None

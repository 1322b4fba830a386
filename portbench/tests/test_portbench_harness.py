"""The harness: a rate over the whole window, the trace's arithmetic, new
cells, configurations and metrics found as new files, and the exits that
print no result."""

import hashlib
import subprocess
import sys
import time

import pytest

from portbench.harness import ROOT, Bench, Spans, Trace, merged

from .conftest import load_json, run_cell, write_json


def test_a_stall_moves_the_rate(toy):
    """One step that stalls for three seconds inside a short window lowers the
    rate: the window's time is all of it, not the steps' alone."""
    def stall_once(ctx):
        fam = ctx.family
        base = fam.Trainer

        class Stalling(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                inner, calls = self.step, []

                def step(batch):
                    calls.append(1)
                    if len(calls) == self.steps_per_epoch + 2:  # inside the window
                        time.sleep(3.0)
                    return inner(batch)

                self.step = step

        fam.Trainer = Stalling

    rc, plain, err = run_cell(toy, "toy-ds2-train", seed=5, seconds=0.2)
    assert rc == 0, err
    rc, stalled, err = run_cell(toy, "toy-ds2-train", seed=5, seconds=0.2, patch=stall_once)
    assert rc == 0, err
    rate = "train_audio_s_per_s"
    assert stalled["metrics"][rate]["value"] < 0.6 * plain["metrics"][rate]["value"]


class FakeEvent:
    def __init__(self, name, start, end):
        import torch

        self._n, self._s, self._e = name, start, end
        self._d = torch.autograd.DeviceType.CUDA

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


class FakeProf:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def test_trace_counts_overlap_once_and_a_stall_as_idle():
    spans = Spans(timeline=True)
    spans.timeline += [("window", 0, 1000), ("step", 0, 340), ("next", 340, 900)]
    ops = [FakeEvent("void ctc_fwd_warp_kernel<2>(...)", 100, 300),
           FakeEvent("copy", 200, 350),  # overlaps the kernel on a side stream
           FakeEvent("gemm", 900, 1000)]
    trace = Trace(FakeProf(ops), spans)
    assert trace.busy_s == pytest.approx(350e-9)
    assert trace.window_s == pytest.approx(1000e-9)
    assert trace.op_seconds(["ctc_fwd_"]) == pytest.approx(200e-9)
    gaps = trace.breakdown()["idle_gaps"]
    assert gaps[0] == ["next", pytest.approx(550e-9)]  # the stall, named by the host's span


def test_merged():
    assert merged([(5, 6), (1, 3), (2, 4)]) == [[1, 4], [5, 6]]


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_new_files_are_found(toy, tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    (with entries in BENCHMARK.json) run; no file the benchmark had changes."""
    import shutil

    root = tmp_path / "tree"
    shutil.copytree(toy, root)
    before = {p.relative_to(root): digest(p) for p in (root / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    pb = root / "portbench"
    config = load_json(pb / "configs" / "toy-ds2.json")
    config["model"]["hidden_size"] = 8
    write_json(pb / "configs" / "tiny-ds2.json", config)
    cell = load_json(pb / "workloads" / "toy-ds2-train.json")
    cell["config"] = "tiny-ds2"
    write_json(pb / "workloads" / "tiny-ds2-train.json", cell)
    (pb / "metrics" / "steps_traced.py").write_text(
        'MOVES = "train_audio_s_per_s"\n\n\ndef read(r):\n    return float(len(r["steps"]))\n')
    bench = load_json(root / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ds2-train" in m.get("workloads", ()):
            m["workloads"].append("tiny-ds2-train")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["tiny-ds2-train"]})
    write_json(root / "BENCHMARK.json", bench)
    rc, result, err = run_cell(root, "tiny-ds2-train", seed=9, trace=1)
    assert rc == 0, err
    assert result["metrics"]["steps_traced"]["value"] == 3.0
    assert "host_wait_ms.train" in result["metrics"]
    after = {p: digest(root / p) for p in before}
    assert after == before


def test_no_card_no_result():
    from portbench import run

    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", "ds2-train", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2


def test_the_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    exits non-zero and prints no result: the program is not there."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from portbench import run; sys.exit(run.main(['--workload', "
            "'ds2-train', '--seed', '1', '--seconds', '1', '--trace', '0'], device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, env={"PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "No module named 'mindaudio_torch'" in proc.stderr


def test_every_listed_cell_has_its_files():
    bench = Bench()
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["traffic"]["name"] == w["traffic"] and cell["why"] == w["why"]
        config = bench.config(w["config"])
        bench.family(config["family"])
        bench.driver(cell["driver"])
        assert set(cell["limits"])
    for m in bench.spec["per_layer"]:
        assert bench.reader(m["name"]).MOVES == m["moves"]

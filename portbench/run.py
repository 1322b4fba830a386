"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``mindaudio_torch`` and a card.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (from one more epoch or pass under ``torch.profiler``); both
decide ``correct``. The compared numbers and their limits are the last lines
of standard error and the last key of the result line. Exits 2 without the
cards the cell asks for, and 3 if the process holds JAX or the JAX package
once the window has closed; neither prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from portbench.harness import ROOT, Bench, device_record, forbidden_modules, result_line  # noqa: E402,E501


@dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments, where to
    write, and the device."""

    bench: Bench
    cell: dict
    config: dict
    family: object
    seed: int
    seconds: float
    trace: bool
    device: object
    tmpdir: str
    t_start: float

    def memory_peak(self):
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return p.parse_args(argv)


def cache_dirs(root):
    """Kernel caches a library may keep, at fixed paths inside the checkout
    (the port's own builds go to ``ops/csrc/build`` and ``_native/build``)."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None, device=None, root=ROOT, patch=None):
    """Run the cell; return the process's exit code. ``device`` (tests only)
    runs on that device without looking for cards; ``patch(ctx)`` (tests
    only) may break the program under test before the run."""
    args = parse(argv)
    bench = Bench(root)
    cell = bench.cell(args.workload)
    cache_dirs(str(bench.root))
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: the cell needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    config = bench.config(cell["config"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmpdir:
        ctx = Context(bench, cell, config, bench.family(config["family"]), args.seed,
                      args.seconds, bool(args.trace), device, tmpdir, T_START)
        if patch is not None:
            patch(ctx)
        out = bench.driver(cell["driver"]).run(ctx)

    held = forbidden_modules()
    if held:
        print(f"portbench: the process holds JAX or the JAX package: {held}", file=sys.stderr)
        return 3
    if device.type == "cuda":
        record = device_record(torch, cell["chips"])
        record["memory_peak_bytes"] = out["memory_peak_bytes"]
    else:
        record = {"platform": device.type, "kind": device.type, "count": 1,
                  "memory_peak_bytes": 0}
    breakdown = None
    if args.trace:
        trace = out["trace"]
        record.update(busy_s=trace.busy_s, window_s=trace.window_s)
        readings = {"trace": trace, "steps": out["traced_steps"], "spans": out["spans"],
                    "config": config, "cell": cell, "family": ctx.family}
        metrics = {}
        for m in bench.per_layer(cell["name"]):
            value = bench.reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace.breakdown()
    else:
        metrics = {}
        for m in bench.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    print("portbench: " + " ".join(f"{k} {v!r}" for k, v in out["phases"].items()),
          file=sys.stderr)
    checks = out["checks"]
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(result_line(all(c.ok for c in checks), out["attempted"], out["failed"], metrics,
                      record, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

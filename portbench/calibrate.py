"""The readings the limits of ``correct`` are set from, for a train cell.

    python -m portbench.calibrate --workload <cell> --seeds <n,n,...> --faults <n,n,...>

For each seed of ``--seeds``: the program's first three steps, through the
run's own set-up, call and feed, against the reference (the sound runs:
their largest reading is a number's lower reading). For each seed of
``--faults`` also the control, in the program's place: the program with
its own lower-precision path switched on where its family has one, else the
reference in the configuration's lower precision (``control`` in its file);
and the reference with half of each batch's rows left out (a planted
fault); each against the reference: their smallest reading is a number's
upper reading. A state left unchanged reads 1 on the gradient and the
change by construction and needs no run. One JSON line a reading. Runs on
the first CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import statistics
import sys
import tempfile
import time

from portbench.drivers.train import Run, Spans, training_checks
from portbench.harness import Bench
from portbench.run import Context, cache_dirs

UNLIMITED = {k: float("inf") for k in ("loss1_gap", "loss2_gap", "loss3_gap", "grad_gap",
                                       "change_gap", "grad_median_gap", "change_median_gap",
                                       "logit_gap")}


def readings(program, reference):
    out = {c.name: c.value for c in training_checks(program, reference, UNLIMITED)}
    median = statistics.median(reference["grad_norms"].values())
    moved = [n for n, g in reference["grad_norms"].items() if g >= 1e-3 * median]
    for key in ("grad_norms", "change"):
        worst = max(moved, key=lambda n: abs(program[key][n] - reference[key][n])
                    / max(reference[key][n], median))
        out[f"worst_{key}"] = [worst, program[key][worst], reference[key][worst]]
    return out


def program_control(ctx, family, seed, device):
    """The program's first three steps with its own lower-precision path
    switched on (the family's ``Trainer(control=True)``), through the same
    set-up, call and feed."""
    import torch

    base = family.Trainer
    family.Trainer = functools.partial(base, control=True)
    try:
        r = Run(ctx)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        readings_fn = r.first_steps(Spans())
        r.close()
    finally:
        family.Trainer = base
    return readings_fn()


def main(argv=None, device="cuda:0"):
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    bench = Bench()
    cache_dirs(str(bench.root))
    import torch

    device = torch.device(device)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    family = bench.family(config["family"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    faults = [int(s) for s in args.faults.split(",") if s]
    for seed in seeds + [s for s in faults if s not in seeds]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmpdir:
            ctx = Context(bench, cell, config, family, seed, 0.0, False, device, tmpdir, t0)
            r = Run(ctx)
            torch.backends.cuda.matmul.allow_tf32 = False  # as PyTorch leaves it
            torch.backends.cudnn.allow_tf32 = True
            program = r.first_steps(Spans())
            r.close()
            reference = r.reference()
            out = []
            if seed in seeds:
                out.append(("program", readings(program(), reference)))
            if seed in faults:
                if "control" in inspect.signature(family.Trainer).parameters:
                    control = program_control(ctx, family, seed, device)
                else:
                    control = r.reference(precision=config["control"])
                out.append(("control", readings(control, reference)))
                out.append(("half_rows", readings(r.reference(half_rows=True), reference)))
        for kind, values in out:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **values,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

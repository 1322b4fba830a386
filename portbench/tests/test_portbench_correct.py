"""``correct`` comes out false when the timed path is broken underneath: a
step that leaves the state unchanged, or that sees half of each batch and
takes the mean over it; and the control (the reference in the
configuration's lower precision, in the program's place) reads far above a
sound run. Toy widths on the CPU, the program in float32, so that a sound
run reads at float32's rounding."""

import pytest
import torch

from portbench.drivers.train import training_checks
from portbench.harness import Bench

from .conftest import run_cell

CELLS = ("toy-conformer-train", "toy-ds2-train")


def broken(fault):
    def patch(ctx):
        base = ctx.family.Trainer

        class Broken(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                if fault == "state_unchanged":
                    self.optimizer.step = lambda grads, ok=None: None
                else:
                    inner = self.step
                    self.step = lambda b: inner({k: v[:len(v) // 2] for k, v in b.items()})

        ctx.family.Trainer = Broken

    return patch


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(toy_f32, cell):
    rc, result, err = run_cell(toy_f32, cell, seed=31)
    assert rc == 0, err
    assert result["correct"], result["checks"]
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(toy_f32, cell, fault):
    rc, result, err = run_cell(toy_f32, cell, seed=31, patch=broken(fault))
    assert rc == 0, err
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(toy_f32, tmp_path, cell):
    """At toy widths the control's gradient gaps stand well above the
    float32 program's, so the comparison tells a lower precision from the
    program (PERF.md gives the control's readings at the cells' own size,
    against their limits)."""
    bench = Bench(toy_f32)
    spec = bench.cell(cell)
    config = bench.config(spec["config"])
    fam = bench.family(config["family"])
    cpu = torch.device("cpu")
    corpus = fam.corpus(config, spec, 41, cpu, str(tmp_path))
    reference = fam.reference_readings(config, spec, corpus, 41, cpu)
    control = fam.reference_readings(config, spec, corpus, 41, cpu,
                                     precision=config["control"])
    rc, sound, err = run_cell(toy_f32, cell, seed=41)
    assert rc == 0, err
    ctl = {c.name: c.value for c in training_checks(control, reference, spec["limits"])}
    for name in ("grad_gap", "grad_median_gap"):
        assert ctl[name] > 10 * sound["checks"][name]["value"], (name, ctl, sound["checks"])

"""Toy cells for the benchmark's CPU tests: a copy of the benchmark tree with
a Conformer and a DeepSpeech2 configuration at toy widths, trained on a few
dozen short utterances, added as new files (and entries of
``BENCHMARK.json``), run on the CPU through ``portbench.run.main``.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil

import pytest

from portbench.harness import ROOT

# every number a train run computes: the toy cells report them all, with the
# real cell's limit where it has one
TRAIN_NUMBERS = ("loss1_gap", "loss2_gap", "loss3_gap", "grad_gap", "change_gap",
                 "grad_median_gap", "change_median_gap", "logit_gap")
TOY_CELLS = {"toy-conformer-train": "conformer-train", "toy-ds2-train": "ds2-train"}


def write_json(path, data):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1)


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def toy_tree(root, f32=False):
    """A copy of the benchmark tree under ``root`` with the two toy cells;
    ``f32`` trains the toy Conformer without autocast (so that the program
    and the reference compute alike)."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load_json(ROOT / "BENCHMARK.json")
    pb = root / "portbench"
    conf = load_json(pb / "configs" / "conformer-aishell.json")
    conf["model"].update(vocab_size=50, d_model=32, head_num=2, ffn_dim=64,
                         num_encoder_layers=2, num_decoder_layers=1)
    if f32:
        conf["recipe"]["optim"].update(bf16=False, mu_dtype="float32")
    write_json(pb / "configs" / "toy-conformer.json", conf)
    cell = load_json(pb / "workloads" / "conformer-train.json")
    cell["config"] = "toy-conformer"
    cell["traffic"]["groups"] = [
        {"count": 8, "min_s": 1.5, "max_s": 2.28}, {"count": 6, "min_s": 2.31, "max_s": 4.2},
        {"count": 4, "min_s": 4.23, "max_s": 6.12}, {"count": 1, "min_s": 6.15, "max_s": 8.04},
        {"count": 1, "min_s": 8.07, "max_s": 10.27}]
    cell["recipe"]["data"]["batch_factor"] = 0.05
    cell["limits"] = dict(dict.fromkeys(TRAIN_NUMBERS, 1.0), **cell["limits"])
    write_json(pb / "workloads" / "toy-conformer-train.json", cell)
    ds = load_json(pb / "configs" / "deepspeech2-librispeech.json")
    ds["model"].update(hidden_size=16, num_rnn_layers=2)
    ds["recipe"]["data"]["batch_size"] = 3
    write_json(pb / "configs" / "toy-ds2.json", ds)
    cell = load_json(pb / "workloads" / "ds2-train.json")
    cell["config"] = "toy-ds2"
    cell["limits"] = dict(dict.fromkeys(TRAIN_NUMBERS, 1.0), **cell["limits"])
    cell["traffic"]["groups"] = [{"count": 3, "min_s": 1.5, "max_s": 1.9},
                                 {"count": 3, "min_s": 2.0, "max_s": 3.0},
                                 {"count": 3, "min_s": 4.0, "max_s": 5.0}]
    write_json(pb / "workloads" / "toy-ds2-train.json", cell)
    for toy_name, name in TOY_CELLS.items():
        for m in bench["end_to_end"] + bench["per_layer"]:
            if name in m.get("workloads", ()):
                m["workloads"].append(toy_name)
    write_json(root / "BENCHMARK.json", bench)
    return root


def run_cell(root, cell, seed, trace=0, seconds=0.5, patch=None):
    """``(exit code, result line as a dict or None, standard error)``."""
    from portbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", root=root, patch=patch)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture(scope="session")
def toy(tmp_path_factory):
    return toy_tree(tmp_path_factory.mktemp("toy"))


@pytest.fixture(scope="session")
def toy_f32(tmp_path_factory):
    return toy_tree(tmp_path_factory.mktemp("toy_f32"), f32=True)

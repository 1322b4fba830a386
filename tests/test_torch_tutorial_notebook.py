"""The port's tutorial notebook runs, and is what its generator writes.

Runs every code cell of
``tutorials/audio_data_processing_with_mindaudio_torch.ipynb`` in order in
one namespace on the CPU: only the first code cell, ``DEVICE = "cuda"``, is
replaced by ``DEVICE = "cpu"``. The committed notebook's cells (their kinds
and sources; outputs may differ) must equal those of
``tutorials/make_notebook_torch.py``.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

TUTORIALS = Path(__file__).resolve().parents[1] / "tutorials"
NB = TUTORIALS / "audio_data_processing_with_mindaudio_torch.ipynb"


def _notebook():
    return json.loads(NB.read_text())


def test_notebook_cells_execute_on_the_cpu():
    code = ["".join(c["source"]) for c in _notebook()["cells"] if c["cell_type"] == "code"]
    assert len(code) >= 10, "tutorial lost its code cells"
    assert code[0] == 'DEVICE = "cuda"\n'
    code[0] = 'DEVICE = "cpu"\n'
    ns = {}
    for i, src in enumerate(code):
        try:
            exec(compile(src, f"<nb cell {i}>", "exec"), ns)  # noqa: S102
        except Exception as e:  # pragma: no cover
            pytest.fail(f"notebook cell {i} raised {type(e).__name__}: {e}\n"
                        f"--- cell source ---\n{src}")
    assert ns["out"].shape[-1] == 128 and ns["logmel"].device.type == "cpu"


def test_notebook_is_what_the_generator_writes():
    spec = importlib.util.spec_from_file_location("make_notebook_torch",
                                                  TUTORIALS / "make_notebook_torch.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    want = [("markdown" if kind == "md" else "code", text.splitlines(keepends=True))
            for kind, text in gen.CELLS]
    got = [(c["cell_type"], c["source"]) for c in _notebook()["cells"]]
    assert got == want


def test_notebook_uses_the_package_level_names_only():
    """Every import of the port in the notebook is of the package or one of
    its subpackages' ``__init__``s."""
    allowed = {"import mindaudio_torch as ma", "from mindaudio_torch import ops",
               "from mindaudio_torch import models",
               "from mindaudio_torch.ops import spec_augment"}
    lines = [line.strip() for c in _notebook()["cells"] if c["cell_type"] == "code"
             for line in "".join(c["source"]).splitlines() if "mindaudio_torch" in line]
    assert lines and set(lines) <= allowed, set(lines) - allowed

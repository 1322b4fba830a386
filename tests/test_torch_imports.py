"""The port stands alone: no file of ``mindaudio_torch/`` (its recipes
included, nor ``chip_smoke.py``) imports JAX, its libraries, the JAX package
or a module of ``examples/``, and importing the port needs neither CUDA nor
nvcc."""

import ast
import importlib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mindaudio_tpu", "examples"}
# the JAX recipes' top-level modules (``examples/*/*.py``) and packages
# (``examples/fastspeech2/text``), importable by name once their directory is
# on sys.path
FORBIDDEN |= {p.stem for p in (ROOT / "examples").glob("*/*.py")}
FORBIDDEN |= {p.parent.name for p in (ROOT / "examples").glob("*/*/__init__.py")}
PORT_FILES = sorted((ROOT / "mindaudio_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom flax import linen\nimportlib.import_module('jax.numpy')\n")
    assert _imported_roots(f) & FORBIDDEN == {"flax", "jax"}


def test_the_recipes_are_scanned():
    recipes = {p.relative_to(ROOT).as_posix() for p in PORT_FILES if "recipes" in p.parts}
    assert {f"mindaudio_torch/recipes/conformer/{m}.py" for m in (
        "dataset", "train", "predict", "compute_cmvn_stats", "convergence_run")} <= recipes
    assert {f"mindaudio_torch/recipes/deepspeech2/{m}.py" for m in (
        "dataset", "train", "eval", "synthetic")} <= recipes
    assert {f"mindaudio_torch/recipes/ecapa_tdnn/{m}.py" for m in (
        "dataset", "train_speaker_embeddings", "speaker_verification_cosine",
        "convergence_run")} <= recipes
    assert {f"mindaudio_torch/recipes/fastspeech2/{m}.py" for m in (
        "dataset", "preprocess", "train", "generate", "convergence_run", "synthetic",
        "text/__init__", "text/cleaners", "text/numbers", "text/pinyin")} <= recipes
    assert {f"mindaudio_torch/recipes/wavegrad/{m}.py" for m in (
        "preprocess", "train", "reverse", "convergence_run")} <= recipes
    assert "reverse" in FORBIDDEN
    assert {"train_speaker_embeddings", "speaker_verification_cosine",
            "convergence_run", "preprocess", "generate", "text"} <= FORBIDDEN
    assert {"dataset", "train", "predict", "eval", "examples"} <= FORBIDDEN


def test_the_training_and_dsp_modules_are_scanned():
    """The modules of the W8A8 training, remat and DSP slice, the training
    utilities and the NumPy data copies are among the files scanned."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"mindaudio_torch/{m}.py" for m in (
        "ops/quant", "ops/spectral", "ops/filterbanks", "ops/resample", "models/layers",
        "models/conformer", "models/asr_model", "utils/common", "train/profiler",
        "train/optim", "data/filters", "data/spectrum", "data/features", "data/processing",
        "data/augment", "data/aishell")} <= scanned


def test_every_module_imports_without_cuda():
    for path in PORT_FILES:
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[0] == "mindaudio_torch":
            importlib.import_module(".".join(parts[:-1] if parts[-1] == "__init__" else parts))


def test_cuda_device_raises_without_a_card():
    from mindaudio_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the error path is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()

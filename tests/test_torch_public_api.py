"""The port's public API against the JAX package's.

- Every name that a JAX ``__init__`` exports (the top level, ``data``,
  ``ops``, ``models``, ``loss``, ``metric``, ``scheduler``, ``train``,
  ``utils``, ``parallel`` and ``_native``) resolves in the port's counterpart,
  and is the object of the same name in the port's module it comes from. The
  JAX names are read from the ``__init__`` files' syntax trees (star exports
  through the modules' ``__all__``), not by importing them.
- Every public function and class of every JAX module resolves in the
  port's module of the same name (``ops.pallas_mel`` is ``ops.logmel``,
  ``ops.pallas_ctc`` is ``ops.ctc_dp``).
- ``EXEMPT`` lists the names left JAX-only on purpose, each with its reason;
  each must still exist on the JAX side and be absent from the port.
- ``import mindaudio_torch.ops`` imports no ``triton`` and builds, loads or
  compiles nothing.
- The options the port's public functions had dropped, held against JAX on
  seeded numpy inputs: ``write(bits=24)`` and ``write(big_endian=True)``
  byte for byte, ``resample(res_type="kaiser")`` at three filter shapes
  (1e-6), ``pad_sequence(batch_first=False)`` exactly,
  ``GlobalCMVN(norm_var=False)`` (1e-6), a 2-layer encoder of
  ``ConformerEncoderLayer(use_macaron=False)`` blocks on converted parameters
  (2e-5, the JAX encoder tests' tolerance), ``make_train_step`` with and
  without ``skip_nonfinite`` on a NaN batch, and ``prepare_librispeech`` on a
  synthetic tarball.
"""

import ast
import functools
import importlib
import inspect
import io as pyio
import json
import os
import subprocess
import sys
import tarfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_layers import random_params

from mindaudio_tpu.data import io as jio
from mindaudio_tpu.data import librispeech as jlibri
from mindaudio_tpu.data import processing as jproc
from mindaudio_tpu.models import conformer as jconf
from mindaudio_tpu.models import layers as jl
from mindaudio_tpu.train import state as jstate
from mindaudio_tpu.utils import common as jcommon
from mindaudio_torch.convert import convert_params
from mindaudio_torch.data import io as tio
from mindaudio_torch.data import librispeech as tlibri
from mindaudio_torch.data import processing as tproc
from mindaudio_torch.models import conformer as tconf
from mindaudio_torch.models import layers as tl
from mindaudio_torch.train import state as tstate
from mindaudio_torch.train.optim import AdamW
from mindaudio_torch.utils import common as tcommon

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "mindaudio_tpu", "mindaudio_torch"
PACKAGES = ["", "data", "ops", "models", "loss", "metric", "scheduler", "train", "utils",
            "parallel", "_native"]
# the port's module for a JAX module of another name, and the port's name for
# a JAX function of another name
MODULE_OF = {"ops.pallas_mel": "ops.logmel", "ops.pallas_ctc": "ops.ctc_dp"}
RENAMED = {("ops.pallas_ctc", "ctc_per_seq_loss_pallas"): "ctc_per_seq_loss_kernel",
           ("ops", "pallas_mel"): "logmel"}

# (JAX module, name): why the port has no counterpart
EXEMPT = {
    ("ops.quant", "intercept_dense_int8"):
        "flax method interception; the port swaps the modules (ops.quant.swap_quantized)",
    ("ops.quant", "strip_quantized"):
        "undoes the flax interception; the port's swap leaves no tree to strip",
    ("train.state", "TrainState"):
        "a JAX state pytree; the port trains nn.Modules with train.optim.AdamW",
    ("train", "TrainState"): "as train.state.TrainState",
    ("train.state", "create_train_state"): "builds the JAX TrainState",
    ("train.state", "fast_dropout_rng"):
        "threefry/rbg keys; the port's dropout draws from a torch.Generator",
    ("train.state", "as_dropout_key"): "threefry/rbg keys, as fast_dropout_rng",
    ("loss.separation_loss", "cal_si_snr_jax"):
        "the JAX-array variant; the port's cal_si_snr takes its place",
    ("loss", "cal_si_snr_jax"): "as loss.separation_loss.cal_si_snr_jax",
    ("data.librispeech", "download_data"): "the port downloads nothing",
    ("data.aishell", "download_aishell"): "the port downloads nothing",
}


# ---------------------------------------------------------------- JAX names


def _path(pkg):
    base = JAX_PKG.joinpath(*pkg.split(".")) if pkg else JAX_PKG
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _all_of(module):
    """``module``'s ``__all__`` (dotted, relative to the JAX package),
    evaluated from its syntax tree; its public definitions if it has none."""
    tree = ast.parse(_path(module).read_text())
    pkg = module if _path(module).name == "__init__.py" else module.rpartition(".")[0]

    def ev(node):
        if isinstance(node, (ast.List, ast.Tuple)):
            return [x for e in node.elts for x in ev(e)]
        if isinstance(node, ast.Constant):
            return [node.value]
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            return ev(node.left) + ev(node.right)
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "list"
                and isinstance(node.args[0], ast.Attribute) and node.args[0].attr == "__all__"):
            return _all_of(".".join(filter(None, (pkg, node.args[0].value.id))))
        raise ValueError(f"{module}: cannot evaluate {ast.dump(node)}")

    names = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            names = ev(node.value)
        elif isinstance(node, ast.AugAssign) and getattr(node.target, "id", None) == "__all__":
            names += ev(node.value)
    if names is None:
        names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                 and not n.name.startswith("_")]
    return names


def _public(name):
    return not name.startswith("_") or (name.startswith("__") and name != "__all__")


def init_names(pkg):
    """``{name: the module it is imported from (relative to pkg, "" for pkg
    itself), or None for an alias or a definition}`` for every public name
    of the JAX ``__init__`` of ``pkg``."""
    out = {}
    for node in ast.parse(_path(pkg).read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                if a.name == "*":
                    out.update((n, node.module) for n in
                               _all_of(".".join(filter(None, (pkg, node.module)))))
                else:  # ``from . import m``: the source is the package itself, ""
                    out[a.asname or a.name] = node.module or ""
        elif isinstance(node, ast.Assign):
            out.update((t.id, None) for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = None
    return {k: v for k, v in out.items() if _public(k)}


def module_names(module):
    tree = ast.parse(_path(module).read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


JAX_MODULES = sorted(
    ".".join(p.relative_to(JAX_PKG).with_suffix("").parts)
    for p in JAX_PKG.rglob("*.py") if p.name not in ("__init__.py", "version.py"))


def _port(module):
    module = MODULE_OF.get(module, module)
    return importlib.import_module(".".join(filter(None, (PORT_PKG, module))))


# ---------------------------------------------------------------- names


INIT_CASES = [(pkg, name, src) for pkg in PACKAGES for name, src in init_names(pkg).items()]


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "top")
def test_the_jax_init_is_read(pkg):
    """The parse finds each ``__init__``'s names (a guard against a parse
    that silently finds none)."""
    names = init_names(pkg)
    assert names
    if pkg == "":
        assert {"read", "write", "stft", "fbank", "prepare_aishell", "io", "spectrum",
                "__version__"} <= set(names)


@pytest.mark.parametrize("pkg,name,src", INIT_CASES,
                         ids=[f"{p or 'top'}.{n}" for p, n, _ in INIT_CASES])
def test_init_name_resolves_in_the_port(pkg, name, src):
    if (pkg, name) in EXEMPT:
        assert not hasattr(_port(pkg), name), f"{pkg}.{name} is exempt but exists"
        return
    got = getattr(_port(pkg), RENAMED.get((pkg, name), name))
    if src is None:
        return  # an alias or a definition of the __init__ itself
    module = ".".join(filter(None, (pkg, src)))
    if inspect.ismodule(got):
        assert got is _port(".".join(filter(None, (module, name))))
    else:
        assert got is getattr(_port(module), name), f"{pkg}.{name} is not {module}.{name}"


MODULE_CASES = [(m, n) for m in JAX_MODULES for n in module_names(m)]


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_names_resolve_in_the_port(module):
    missing = [n for n in module_names(module) if (module, n) not in EXEMPT
               and not hasattr(_port(module), RENAMED.get((module, n), n))]
    assert not missing, f"mindaudio_torch.{MODULE_OF.get(module, module)} lacks {missing}"


@pytest.mark.parametrize("key", sorted(EXEMPT), ids=lambda k: ".".join(k))
def test_exempt_names_are_jax_only(key):
    module, name = key
    assert EXEMPT[key]
    jax_names = init_names(module) if _path(module).name == "__init__.py" else \
        module_names(module)
    assert name in jax_names, f"{module}.{name} is no longer in the JAX package"
    assert not hasattr(_port(module), name)


def test_the_aliases_are_bound_as_in_jax():
    import mindaudio_torch.loss as L
    import mindaudio_torch.scheduler as S

    assert L.CTC is L.ctc_loss and L.LabelSmoothingLoss is L.label_smoothing_loss
    assert L.AdditiveAngularMargin is L.additive_angular_margin
    assert L.Separation_Loss is L.Convtasnet_Loss is L.pit_si_snr_loss
    assert L.FastSpeech2Loss is L.fastspeech2_loss
    assert S.ASRWarmupLR is S.asr_warmup_lr and S.ASRLearningRate is S.warmup_poly_lr
    assert S.CosineLearningRate is S.cosine_lr


def test_top_level_all_is_composed_as_in_jax():
    import mindaudio_torch as ma

    assert sorted(ma.data.__all__) == sorted(_all_of("data"))
    assert set(ma.__all__) == set(_all_of("data")) | {"resolve_device", "check_generator",
                                                      "__version__"}
    from mindaudio_torch.version import __version__

    assert ma.__version__ == __version__ and ma.read is tio.read


_IMPORT_OPS = """
import os, subprocess, sys
popen = subprocess.Popen
class Refuse(popen):
    def __init__(self, args, *rest, **kwargs):
        cmd = args if isinstance(args, str) else str(args[0])
        if os.path.basename(cmd.split()[0]) in ("nvcc", "g++", "gcc", "c++", "cc"):
            raise AssertionError(f"importing the ops ran {args!r}")
        super().__init__(args, *rest, **kwargs)
subprocess.Popen = Refuse
import mindaudio_torch.ops
from mindaudio_torch.ops import _build
from mindaudio_torch import _native
assert "triton" not in sys.modules, "triton imported"
assert not _build._loaded and not _native._loaded, "a library was loaded"
print("clean")
"""


def test_importing_the_ops_builds_nothing():
    """In a fresh process: no compiler is started (a build is one), no
    library is loaded and ``triton`` stays out of ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_OPS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr


# ---------------------------------------------------------------- options


@pytest.mark.parametrize("port_fn,jax_fn,option", [
    (tio.write, jio.write, "bits"), (tio.write, jio.write, "big_endian"),
    (tproc.resample, jproc.resample, "lowpass_filter_width"),
    (tproc.resample, jproc.resample, "rolloff"), (tproc.resample, jproc.resample, "beta"),
    (tcommon.pad_sequence, jcommon.pad_sequence, "batch_first"),
    (tl.GlobalCMVN, jl.GlobalCMVN, "norm_var"),
    (tconf.ConformerEncoderLayer, jconf.ConformerEncoderLayer, "use_macaron"),
    (tstate.make_train_step, jstate.make_train_step, "skip_nonfinite"),
])
def test_option_has_the_jax_default(port_fn, jax_fn, option):
    assert (inspect.signature(port_fn).parameters[option].default
            == inspect.signature(jax_fn).parameters[option].default)


def _wav_case(kind):
    x = np.random.default_rng(3).uniform(-0.9, 0.9, (401, 2) if "stereo" in kind else 401)
    if kind.startswith("int32"):
        return (x * 2**31).astype(np.int32)
    if kind.startswith("float"):
        return x.astype(np.float32)
    return (x * 32767).astype(np.int16)


@pytest.mark.parametrize("kind,kw", [
    ("int32", {"bits": 24}), ("int32_stereo", {"bits": 24}),
    ("int32", {"bits": 24, "big_endian": True}),
    ("int16", {"big_endian": True}), ("int16_stereo", {"big_endian": True}),
    ("float32", {"big_endian": True}), ("int32", {"big_endian": True}),
    ("int16", {"bits": 16}),
])
def test_write_options_match_jax_bytes(tmp_path, kind, kw):
    data = _wav_case(kind)
    tio.write(str(tmp_path / "t.wav"), data, 22050, **kw)
    jio.write(str(tmp_path / "j.wav"), data, 22050, **kw)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = tio.read(str(tmp_path / "t.wav"))
    want, _ = jio.read(str(tmp_path / "j.wav"))
    assert sr == 22050
    np.testing.assert_array_equal(got, want)
    buf = pyio.BytesIO()  # an open handle, rewound afterwards
    tio.write(buf, data, 22050, **kw)
    assert buf.tell() == 0 and buf.getvalue() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("kind,kw", [("int16", {"bits": 24}), ("float32", {"bits": 24}),
                                     ("int16", {"bits": 8})])
def test_write_refuses_what_jax_refuses(tmp_path, kind, kw):
    for mod in (tio, jio):
        with pytest.raises(ValueError):
            mod.write(str(tmp_path / "x.wav"), _wav_case(kind), 16000, **kw)


@pytest.mark.parametrize("orig,new", [(16000, 22050), (44100, 16000)])
@pytest.mark.parametrize("shape", [
    dict(), dict(lowpass_filter_width=16, rolloff=0.85, beta=8.555),
    dict(lowpass_filter_width=4, rolloff=0.945, beta=5.0)], ids=["default", "wide", "narrow"])
def test_kaiser_resample_options_match_jax(orig, new, shape):
    x = np.random.default_rng(8).standard_normal((2, 1501)).astype(np.float32)
    got = tproc.resample(x, orig, new, res_type="kaiser", **shape)
    want = jproc.resample(x, orig, new, res_type="kaiser", **shape)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(batch_first=False), dict(batch_first=False, max_len=3),
                                dict(batch_first=True, padding_value=-1)])
@pytest.mark.parametrize("trailing", [(), (3,)])
def test_pad_sequence_batch_first_matches_jax(kw, trailing):
    rng = np.random.default_rng(4)
    seqs = [rng.standard_normal((n,) + trailing).astype(np.float32) for n in (5, 2, 4)]
    got, want = tcommon.pad_sequence(seqs, **kw), jcommon.pad_sequence(seqs, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm_var", [False, True])
def test_global_cmvn_norm_var_matches_jax(norm_var):
    rng = np.random.default_rng(5)
    mean = rng.standard_normal(12).astype(np.float32)
    istd = (rng.random(12) + 0.5).astype(np.float32)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    want = jl.GlobalCMVN(jnp.asarray(mean), jnp.asarray(istd), norm_var=norm_var).apply(
        {}, jnp.asarray(x))
    got = tl.GlobalCMVN(mean, istd, norm_var=norm_var)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_macaron", [False, True])
def test_encoder_without_macaron_matches_jax(monkeypatch, use_macaron):
    """Both encoders build their blocks through the module-level name
    ``ConformerEncoderLayer``; it is bound to the layer with ``use_macaron``
    set, on each side, for the test."""
    monkeypatch.setattr(jconf, "ConformerEncoderLayer", functools.partial(
        jconf.ConformerEncoderLayer, use_macaron=use_macaron))
    monkeypatch.setattr(tconf, "ConformerEncoderLayer", functools.partial(
        tconf.ConformerEncoderLayer, use_macaron=use_macaron))
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 45, 20)).astype(np.float32)
    lens = np.array([45, 33])
    kw = dict(input_dim=20, d_model=32, head_num=4, ffn_dim=64, num_layers=2, kernel_size=5)
    jm = jconf.ConformerEncoder(**kw)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(feats),
                                           jnp.asarray(lens))["params"], 9)
    assert ("norm_ff_macaron" in params["layer_0"]) == use_macaron
    tm = tconf.ConformerEncoder(**kw)
    tm.load_state_dict(convert_params(params), strict=True)
    assert all(hasattr(layer, "feed_forward_macaron") == use_macaron for layer in tm.layers)
    jout, jmask = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(lens))
    tout, tmask = tm.eval()(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)


class _Affine(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = torch.nn.Parameter(torch.from_numpy(w)), torch.nn.Parameter(
            torch.from_numpy(b))

    def forward(self, batch):
        err = batch["x"] @ self.w + self.b - batch["y"]
        return (err * err).mean(), {}


@pytest.mark.parametrize("skip_nonfinite", [False, True])
def test_train_step_on_a_nan_batch_matches_jax(skip_nonfinite):
    """A finite step, then a batch with one NaN input: with
    ``skip_nonfinite=False`` both sides apply the NaN update, with the
    default both keep their parameters; then a finite step again."""
    rng = np.random.default_rng(10)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    batches = []
    for poison in (False, True, False):
        x = rng.standard_normal((5, 4)).astype(np.float32)
        if poison:
            x[2, 1] = np.nan
        batches.append({"x": x, "y": rng.standard_normal((5, 3)).astype(np.float32)})

    def jax_loss(params, state, batch, rng_key):
        err = batch["x"] @ params["w"] + params["b"] - batch["y"]
        return jnp.mean(err * err), {}

    jstate_ = jstate.create_train_state(types.SimpleNamespace(apply=None),
                                        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                        optax.adamw(1e-2, weight_decay=1e-2))
    jstep = jstate.make_train_step(jax_loss, donate=False, skip_nonfinite=skip_nonfinite)
    model = _Affine(w.copy(), b.copy())
    opt = AdamW(model.named_parameters(), 1e-2, weight_decay=1e-2)
    tstep = tstate.make_train_step(model, opt, skip_nonfinite=skip_nonfinite)
    for batch in batches:
        jstate_, jmetrics = jstep(jstate_, {k: jnp.asarray(v) for k, v in batch.items()})
        tmetrics = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tmetrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-6)
        for name in ("w", "b"):  # NaN where JAX has NaN (assert_allclose pairs them)
            np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                       np.asarray(jstate_.params[name]), rtol=1e-6, atol=1e-6)
    assert np.isnan(model.w.detach().numpy()).all() != skip_nonfinite
    assert opt.count.item() == int(jstate_.opt_state[0].count)


def _librispeech_tarball(root):
    """``dev-clean.tar.gz`` in LibriSpeech's layout: two chapters, WAVs."""
    buf_files = {}
    rng = np.random.default_rng(11)
    for spk, chap, n in (("84", "121123", 2), ("174", "50561", 1)):
        lines = []
        for i in range(n):
            utt = f"{spk}-{chap}-{i:04d}"
            wav = pyio.BytesIO()
            jio.write(wav, (rng.uniform(-0.5, 0.5, 800) * 32767).astype(np.int16), 16000)
            buf_files[f"LibriSpeech/dev-clean/{spk}/{chap}/{utt}.wav"] = wav.getvalue()
            lines.append(f"{utt} WORD {i} OF {spk}")
        buf_files[f"LibriSpeech/dev-clean/{spk}/{chap}/{spk}-{chap}.trans.txt"] = \
            ("\n".join(lines) + "\n").encode()
    os.makedirs(root, exist_ok=True)
    with tarfile.open(os.path.join(root, "dev-clean.tar.gz"), "w:gz") as tar:
        for name, data in sorted(buf_files.items()):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, pyio.BytesIO(data))


def test_prepare_librispeech_matches_jax(tmp_path):
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    for root in (port_root, jax_root):
        _librispeech_tarball(root)
    tlibri.prepare_librispeech(port_root, tarballs={"val": ["dev-clean.tar.gz"]})
    jlibri.prepare_librispeech(jax_root, urls={"val": ["https://host/dev-clean.tar.gz"]})

    def manifest(root):
        m = json.loads(Path(root, "val", "libri_val_manifest.json").read_text())
        assert m.pop("data_path") == os.path.join(root, "val")
        return m

    got, want = manifest(port_root), manifest(jax_root)
    assert got == want and len(got["samples"]) == 3
    for s in got["samples"]:
        for key in ("wav_path", "txt_path"):
            assert (Path(port_root, "val", s[key]).read_bytes()
                    == Path(jax_root, "val", s[key]).read_bytes())


def test_prepare_librispeech_refuses_to_download(tmp_path):
    with pytest.raises(ValueError, match="does not download"):
        tlibri.prepare_librispeech(str(tmp_path), download=True)
    assert not any(tmp_path.iterdir())


def test_pin_memory_walks_nested_batches():
    import mindaudio_torch as ma

    rng = np.random.default_rng(12)
    src = {"wav": rng.standard_normal((2, 5)).astype(np.float32),
           "pair": (torch.arange(3), [rng.integers(0, 9, 4)]), "name": "utt", "n": 2}
    moved = ma.pin_memory(src, device="cpu")
    assert moved["wav"].dtype == torch.float32 and isinstance(moved["pair"], tuple)
    np.testing.assert_array_equal(moved["wav"].numpy(), src["wav"])
    assert torch.equal(moved["pair"][0], src["pair"][0])
    np.testing.assert_array_equal(moved["pair"][1][0].numpy(), src["pair"][1][0])
    assert moved["name"] == "utt" and moved["n"] == 2
    assert ma.recursive_to(src, "cpu").keys() == src.keys()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            ma.pin_memory(src)  # the card by default


@pytest.mark.parametrize("query,lib", [("available", "wav_loader"), ("beam_available", "ctc_beam")])
def test_native_queries(monkeypatch, query, lib):
    from mindaudio_torch import _native

    assert getattr(_native, query)() is True
    assert lib in _native._loaded

    def broken(name):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(_native, "_load", broken)
    assert getattr(_native, query)() is False

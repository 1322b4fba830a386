"""Port parity for the DeepSpeech2 recipe (``mindaudio_torch/recipes/deepspeech2``
and ``mindaudio_torch/data/librispeech``) against the JAX recipe
(``examples/deepspeech2``) and ``mindaudio_tpu.data.librispeech``, on the CPU
at a toy size (hidden 32, 2 layers).

The JAX recipe's files are top-level modules (``dataset``, ``train``,
``eval``); they are loaded by path and removed from ``sys.modules`` (and
their directory from ``sys.path``) afterwards.

- both LibriSpeech builders lay out the same extracted tree, and the same
  tarball, into the same files and manifests;
- both ``batch_iterator``s yield equal batches (arrays and order) for the
  same seed, shuffled or not, with and without ``drop_last``, on one rank
  (the port has no data parallelism yet);
- ``device_features`` agree (1e-5 relative, a floor of 1e-5 of the peak);
- one step of the JAX recipe's ``make_step`` (on a one-device mesh) and one
  of the port's, from the same parameters, statistics and a running AdamW
  state: the loss, parameters, both moments and the running statistics
  agree within 1e-5 relative (float32 sums in another order), with a floor
  of 1e-6 of each leaf's peak (1e-5 for the moments) for the elements near
  zero, and the gradient norm within 1e-4; a poisoned batch then leaves
  the parameters, moments, AdamW's count and running statistics bit-equal,
  in both;
- ``train.main()`` and ``eval.main()`` run end to end on ``--device cpu``
  on a synthetic corpus, with the frame buckets cut to 40 and 80 frames.
"""

import importlib.util
import os
import shutil
import sys
import tarfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.data import librispeech as jlibri
from mindaudio_tpu.parallel.mesh import make_mesh
from mindaudio_tpu.parallel.shardings import state_shardings
from mindaudio_tpu.train import config as jconfig
from mindaudio_tpu.train.state import TrainState
from mindaudio_torch.convert import convert_adamw_state, convert_params
from mindaudio_torch.data import librispeech as tlibri
from mindaudio_torch.models.layers import running_stats
from mindaudio_torch.recipes.deepspeech2 import dataset, synthetic
from mindaudio_torch.recipes.deepspeech2 import eval as teval
from mindaudio_torch.recipes.deepspeech2 import train as ttrain
from mindaudio_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_RECIPE = os.path.join(REPO, "examples", "deepspeech2")
TOY = ["--model.hidden_size", "32", "--model.num_rnn_layers", "2"]
# utterances of 30-80 frames (400-bucket batches) and of 500-700 (800-bucket)
TOY_FRAMES = ((30, 80), (500, 700))


@pytest.fixture(scope="module")
def jax_recipe():
    names = ("dataset", "train", "eval")
    saved_path = list(sys.path)
    saved = {n: sys.modules.get(n) for n in names}
    try:
        mods = {}
        for name in names:
            spec = importlib.util.spec_from_file_location(name, os.path.join(JAX_RECIPE,
                                                                             f"{name}.py"))
            mods[name] = sys.modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])  # train.py imports `dataset` by name
        yield SimpleNamespace(**mods)
    finally:
        sys.path[:] = saved_path
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds2"))
    train_json, test_json = synthetic.gen(root, n_train=7, n_test=5, seed=1,
                                          train_frames=TOY_FRAMES, test_frames=((30, 900),))
    return SimpleNamespace(root=root, train=train_json, test=test_json)


def test_constants_config_and_transcripts(jax_recipe, tmp_path):
    for name in ("LABELS", "BLANK_ID", "N_FFT", "HOP", "FRAME_BUCKETS", "MAX_LABEL_LEN",
                 "CHAR2ID", "SAMPLE_RATE"):
        assert getattr(dataset, name) == getattr(jax_recipe.dataset, name), name
    txt = tmp_path / "t.txt"
    txt.write_text("Hello, world's end\n2 tabs\there", encoding="utf-8")
    np.testing.assert_array_equal(dataset.encode_transcript(str(txt)),
                                  jax_recipe.dataset.encode_transcript(str(txt)))
    argv = ["--optim.lr", "0.001"] + TOY
    tcfg, device = ttrain.parse_args(argv + ["--device", "cpu"])
    jcfg = jconfig.get_config(os.path.join(JAX_RECIPE, "deepspeech2.yaml"), argv)
    assert tcfg.to_dict() == jcfg.to_dict() and device == torch.device("cpu")


def _extracted_tree(root):
    rng = np.random.default_rng(3)
    synthetic._write_tree(os.path.join(root, "LibriSpeech", "test-clean"), rng, 3,
                          ((20, 40), (50, 60)))


def _tree_files(root):
    """``{relative path: bytes}`` of the files under ``root`` with ``root``
    replaced in their contents; tarballs left out (gzip stamps its time)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".tar.gz"):
                continue
            path = os.path.join(dirpath, f)
            data = open(path, "rb").read()
            out[os.path.relpath(path, root)] = data.replace(str(root).encode(), b"ROOT")
    return out


def test_librispeech_layout_matches_jax(tmp_path):
    ours, theirs = tmp_path / "t", tmp_path / "j"
    for root in (ours, theirs):
        _extracted_tree(str(root / "x"))
    man_t = {"data_path": "D", "samples": []}
    man_j = {"data_path": "D", "samples": []}
    tlibri._relayout_tree(str(ours / "x"), str(ours / "split"), man_t)
    jlibri._relayout_tree(str(theirs / "x"), str(theirs / "split"), man_j)
    assert man_t == man_j and len(man_t["samples"]) == 6
    assert _tree_files(str(ours)) == _tree_files(str(theirs))

    # a tarball through create_json_dict (JAX: prepare_librispeech without
    # its download), and build_split
    for root in (tmp_path / "tt", tmp_path / "tj"):
        _extracted_tree(str(root))
        with tarfile.open(root / "test-clean.tar.gz", "w:gz") as tar:
            tar.add(str(root / "LibriSpeech"), arcname="LibriSpeech")
        shutil.rmtree(root / "LibriSpeech")
    tlibri.create_json_dict(str(tmp_path / "tt"), {"test_clean": ["test-clean.tar.gz"]})
    jlibri.prepare_librispeech(str(tmp_path / "tj"), download=False,
                               urls={"test_clean": ["https://example.invalid/test-clean.tar.gz"]})
    assert {s: [os.path.basename(u) for u in us] for s, us in jlibri.LIBRI_SPEECH_URLS.items()
            } == tlibri.LIBRI_SPEECH_TARBALLS
    assert _tree_files(str(tmp_path / "tt")) == _tree_files(str(tmp_path / "tj"))
    manifest = tmp_path / "tt" / "test_clean" / "libri_test_clean_manifest.json"
    assert manifest.exists()
    split = tmp_path / "b"
    _extracted_tree(str(split / "x"))
    built = tlibri.build_split([str(split / "x" / "LibriSpeech")], str(split / "test_clean"),
                               "test_clean")
    assert (open(built, encoding="utf-8").read().replace(str(split), "R")
            == manifest.read_text(encoding="utf-8").replace(str(tmp_path / "tt"), "R"))


def test_synthetic_corpus(corpus, jax_recipe):
    pairs = dataset.read_manifest(corpus.train)
    assert pairs == jax_recipe.dataset.read_manifest(corpus.train) and len(pairs) == 14
    for wav, txt in pairs:
        n = 1 + dataset.io.info(wav)[0] // dataset.HOP
        label = dataset.encode_transcript(txt)
        assert any(lo <= n <= hi for lo, hi in TOY_FRAMES)
        assert n // 10 <= len(label) <= n // 6 and dataset.BLANK_ID not in label
        assert "  " not in open(txt, encoding="utf-8").read()


@pytest.mark.parametrize("shuffle,drop_last,seed", [
    (True, True, 5), (False, False, 5), (True, False, 8)])
def test_batch_iterators_agree(jax_recipe, corpus, shuffle, drop_last, seed):
    kw = dict(epochs=2, seed=seed, shuffle=shuffle, drop_last=drop_last)
    ours = list(dataset.batch_iterator(corpus.train, 4, **kw))
    theirs = list(jax_recipe.dataset.batch_iterator(corpus.train, 4, **kw))
    assert len(ours) == len(theirs) == (3 if drop_last else 4) * 2  # 14 files, B = 4
    assert {b["wavs"].shape[1] // dataset.HOP for _, b in ours} == {400, 800}
    for (e, got), (je, want) in zip(ours, theirs):
        assert e == je and got.keys() == want.keys()
        for key in want:
            if key == "n_valid":
                assert got[key] == want[key]
                continue
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _batch(seed=2, b=3, frames=60):
    rng = np.random.default_rng(seed)
    wav_lens = np.array([frames * 160 - 1, 41 * 160, 23 * 160 + 7], np.int32)[:b]
    wavs = np.zeros((b, frames * 160), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = 0.1 * rng.standard_normal(n)
    labels = np.zeros((b, dataset.MAX_LABEL_LEN), np.int32)
    label_lens = np.array([7, 5, 3], np.int32)[:b]
    for i, n in enumerate(label_lens):
        labels[i, :n] = rng.integers(0, dataset.BLANK_ID, n)
    return {"wavs": wavs, "wav_lens": wav_lens, "labels": labels, "label_lens": label_lens}


def test_device_features(jax_recipe):
    batch = _batch()
    want, want_lens = jax_recipe.train.device_features(jnp.asarray(batch["wavs"]),
                                                       jnp.asarray(batch["wav_lens"]))
    got, got_lens = ttrain.device_features(torch.from_numpy(batch["wavs"]),
                                           torch.from_numpy(batch["wav_lens"]).long())
    assert got.shape == want.shape == (3, 61, 161)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


def _draw(tree, rng):
    def leaf(path, a):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if len(a.shape) == 1 or path[-1].key == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) if path[-1].key == "kernel" else a.shape[-2]
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _running_adam(opt_state, rng):
    """Non-zero moments drawn with numpy, count 3: a running optimizer (the
    second moment well above the squared gradients' rounding, so that Adam's
    quotient does not turn a near-zero gradient into an update of full size
    and random sign)."""
    adam = opt_state[0]
    mu = jax.tree_util.tree_map(lambda m: jnp.asarray(0.01 * rng.standard_normal(m.shape),
                                                      jnp.float32), adam.mu)
    nu = jax.tree_util.tree_map(lambda v: jnp.asarray(1e-4 * (1.0 + rng.random(v.shape)),
                                                      jnp.float32), adam.nu)
    count = jnp.asarray(3, jnp.int32)
    rest = tuple(s._replace(count=count) if "count" in s._fields else s for s in opt_state[1:])
    return (adam._replace(count=count, mu=mu, nu=nu), *rest)


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def test_one_step_matches_the_jax_recipe_and_a_poisoned_batch_is_skipped(jax_recipe):
    argv = TOY + ["--optim.lr", "0.001"]
    jcfg = jconfig.get_config(os.path.join(JAX_RECIPE, "deepspeech2.yaml"), argv)
    tcfg, device = ttrain.parse_args(argv + ["--device", "cpu"])
    batch = _batch()
    jmodel = jax_recipe.train.DeepSpeechModel(vocab_size=len(dataset.LABELS), hidden_size=32,
                                              num_rnn_layers=2)
    feats, feat_lens = jax_recipe.train.device_features(jnp.asarray(batch["wavs"]),
                                                        jnp.asarray(batch["wav_lens"]))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), feats, feat_lens)
    rng = np.random.default_rng(4)
    params = _draw(shapes["params"], rng)
    stats = jax.tree_util.tree_map(lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
                                   shapes["batch_stats"])
    tx = optax.adamw(float(jcfg.optim.lr), weight_decay=float(jcfg.optim.weight_decay))
    state = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx, batch_stats=stats)
    state = state.replace(step=3, opt_state=_running_adam(state.opt_state, rng))
    start = _host({"params": state.params, "opt": state.opt_state, "stats": state.batch_stats})

    # the port, from the same state
    model = ttrain.build_model(tcfg, device)
    model.load_state_dict(convert_params(params, stats), strict=True)
    model.train()
    opt = ttrain.make_optimizer(tcfg, model)
    opt.load_state_dict(convert_adamw_state(start["opt"]))
    step = ttrain.make_step(tcfg, model, opt)

    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    st_sh = state_shardings(state, mesh)
    jstep, _ = jax_recipe.train.make_step(jcfg, jmodel, mesh, st_sh)
    state, want = jstep(jax.device_put(state, st_sh), {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    got = step({k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                for k, v in batch.items()})
    # the gradient norm passes through the whole backward: 1e-4, as the
    # Conformer's train step tests hold it
    for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=rtol, err_msg=key)
    assert float(want["grad_norm"]) > float(jcfg.optim.grad_clip)  # the clip is active

    def agree(ours, theirs, what, floor):
        for name, t in ours.items():
            w = theirs[name].numpy()
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=1e-5,
                                       atol=floor * np.abs(w).max(), err_msg=f"{what} {name}")

    want_state = convert_params(state.params, state.batch_stats)
    agree(dict(model.named_parameters()), want_state, "param", 1e-6)
    agree({n: b for n, b in model.named_buffers()}, want_state, "statistic", 1e-6)
    jopt = convert_adamw_state(state.opt_state)
    agree(dict(zip(opt.names, opt.mu)), jopt["mu"], "mu", 1e-5)
    agree(dict(zip(opt.names, opt.nu)), jopt["nu"], "nu", 1e-5)
    assert opt.count.item() == int(jopt["count"]) == 4
    moved = max((p.detach() - convert_params(params)[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > 1e-4

    # a poisoned batch: the port keeps everything, AdamW's count included, bit for bit
    bad = dict(batch, wavs=batch["wavs"].copy())
    bad["wavs"][1, 100] = np.inf
    before = [t.clone() for t in (*model.parameters(), *opt.mu, *opt.nu, *running_stats(model))]
    got = step({k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                for k, v in bad.items()})
    assert not np.isfinite(got["loss"].item())
    after = (*model.parameters(), *opt.mu, *opt.nu, *running_stats(model))
    assert len(before) == len(after) == 3 * 19 + 2 * 4  # params, mu, nu; 4 batch norms
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    # and so does the JAX recipe, its optax state included (its global step advances)
    held = _host({"params": state.params, "stats": state.batch_stats, "opt": state.opt_state})
    state, want = jstep(state, {k: jnp.asarray(v) for k, v in bad.items()})
    assert not np.isfinite(float(want["loss"])) and int(state.step) == 5
    assert opt.count.item() == int(convert_adamw_state(state.opt_state)["count"]) == 4
    now = {"params": state.params, "stats": state.batch_stats, "opt": state.opt_state}
    for a, b in zip(jax.tree_util.tree_leaves(held), jax.tree_util.tree_leaves(now)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_model_state_round_trip(tmp_path):
    cfg, device = ttrain.parse_args(TOY + ["--device", "cpu"])
    model = ttrain.build_model(cfg, device)
    model.train()(*ttrain.device_features(torch.from_numpy(_batch()["wavs"]),
                                          torch.from_numpy(_batch()["wav_lens"]).long()))
    tckpt.save_checkpoint(str(tmp_path), ttrain.checkpoint_state(model, 7), 7)
    saved = tckpt.restore_checkpoint(str(tmp_path))
    assert set(saved) == {"params", "buffers", "step"}  # the JAX recipe's: no moments
    assert set(saved["buffers"]) == {n for n, _ in model.named_buffers()}
    assert len(saved["buffers"]) == 2 * 4 and int(saved["step"]) == 7
    other = ttrain.build_model(cfg, device)
    tckpt.load_model_state(other, saved)
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(KeyError):
        tckpt.load_model_state(other, {"params": saved["params"], "buffers": {}})


def test_parallel_settings_raise():
    """ZeRO-1 needs the mesh of several processes: without one (a single
    process) the moments stay whole; the parallel runs themselves are in
    ``test_torch_parallel_ds2.py``."""
    cfg, _ = ttrain.parse_args(TOY + ["--device", "cpu"])
    cfg.train["zero1_optimizer"] = True
    model = ttrain.build_model(cfg, "cpu")
    opt = ttrain.make_optimizer(cfg, model)
    assert opt.zero1_group is None
    assert opt._mu.numel() == sum(p.numel() for p in model.parameters())


def test_train_and_eval_end_to_end(monkeypatch, tmp_path):
    monkeypatch.setattr(dataset, "FRAME_BUCKETS", (40, 80))
    train_json, test_json = synthetic.gen(str(tmp_path), n_train=4, n_test=5, seed=2,
                                          train_frames=((30, 40), (60, 80)),
                                          test_frames=((30, 80),))
    argv = TOY + ["--device", "cpu", "--data.train_manifest", train_json,
                  "--data.test_manifest", test_json, "--data.batch_size", "4",
                  "--train.ckpt_dir", str(tmp_path / "ckpt"), "--train.max_steps", "5",
                  "--train.log_every_steps", "2", "--train.save_every_steps", "4",
                  "--optim.epochs", "5", "--optim.lr", "0.003"]
    out = ttrain.main(argv)
    assert out["steps"] == 5 and sorted(out["losses"]) == [1, 2, 4]
    assert np.isfinite(list(out["losses"].values())).all()
    assert set(out["buckets"].values()) <= {40, 80} and len(out["window_ms"]) == 1
    assert tckpt.list_steps(str(tmp_path / "ckpt")) == [4, 5]
    last = tckpt.restore_checkpoint(str(tmp_path / "ckpt"))
    assert int(last["step"]) == 5
    assert not torch.equal(last["buffers"]["head_bn.running_var"],
                           torch.ones_like(last["buffers"]["head_bn.running_var"]))
    result = teval.main(argv)
    assert result["utts"] == 5 and 0 <= result["cer"] < float("inf")
    assert 0 <= result["wer"] < float("inf")

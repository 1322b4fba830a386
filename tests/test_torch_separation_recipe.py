"""Port parity for the separation recipes (``mindaudio_torch/recipes/conv_tasnet``
and ``recipes/tasnet``), their data (``data/librimix``), metrics
(``metric/snr``) and the convergence corpus, against the JAX recipes
(``examples/conv_tasnet``, ``examples/tasnet``), the JAX package and
``benchmarks/separation_convergence.py``, on the CPU at a toy size
(Conv-TasNet N 32, bottleneck 8, hidden 16, X 3, R 2; TasNet N 32, hidden
32, 2 layers).

The JAX recipes' ``train.py`` files and the benchmark are loaded by path
under names of their own, and ``sys.path`` is restored afterwards.

- the YAMLs are the JAX recipes' (after the same overrides);
- the copies ``metric/snr`` (to 1e-9 in float64: the same code), and
  ``data/librimix`` and ``make_corpus`` (batches and bytes exactly);
- one step of each recipe against the JAX recipe's step (its loss, the
  clip at 5.0, optax's Adam, ``skip_nonfinite_update``), from the same
  parameters and a running Adam state: the loss within 1e-5 relative, the
  gradient norm within 1e-4, each parameter's update within 1e-4 of its
  leaf's largest (float32 sums in another order); a batch with a NaN then
  leaves the parameters, moments and Adam's count as they were, in both;
- the eval loop on converted weights: SI-SNRi and SDRi within 1e-3 dB of
  the JAX eval's, on 4 short utterances;
- ``train.main()`` and ``eval.main()`` of both recipes, and the
  convergence run, end to end on ``--device cpu``.
"""

import glob
import hashlib
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.data import librimix as jlibrimix
from mindaudio_tpu.loss.separation_loss import pit_si_snr_loss as jpit
from mindaudio_tpu.metric import snr as jsnr
from mindaudio_tpu.train import config as jconfig
from mindaudio_tpu.train.state import TrainState, clip_by_global_norm, skip_nonfinite_update
from mindaudio_torch.convert import convert_adamw_state, convert_params
from mindaudio_torch.data import librimix as tlibrimix
from mindaudio_torch.metric import snr as tsnr
from mindaudio_torch.recipes.conv_tasnet import convergence_run as tconv
from mindaudio_torch.recipes.conv_tasnet import eval as tct_eval
from mindaudio_torch.recipes.conv_tasnet import train as tct_train
from mindaudio_torch.recipes.tasnet import eval as ttas_eval
from mindaudio_torch.recipes.tasnet import train as ttas_train
from mindaudio_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOY = {
    "conv_tasnet": ["--model.enc_dim", "32", "--model.bottleneck", "8", "--model.hidden", "16",
                    "--model.num_blocks", "3", "--model.num_repeats", "2"],
    "tasnet": ["--model.enc_dim", "32", "--model.hidden", "32", "--model.num_layers", "2"],
}
PORT = {"conv_tasnet": (tct_train, tct_eval, tct_train.separate),
        "tasnet": (ttas_train, ttas_eval, ttas_train.separate_full)}
MODELS = sorted(TOY)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_side():
    """The JAX recipes' ``train`` modules and the convergence benchmark."""
    saved_path = list(sys.path)
    try:
        yield SimpleNamespace(
            train={m: _load(f"jax_{m}_train", os.path.join(REPO, "examples", m, "train.py"))
                   for m in MODELS},
            bench=_load("jax_separation_convergence",
                        os.path.join(REPO, "benchmarks", "separation_convergence.py")))
    finally:
        sys.path[:] = saved_path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 training and 8 test mixtures of 2000 samples; ``tt4`` lists the
    first 4 test mixtures."""
    root = str(tmp_path_factory.mktemp("sep"))
    tconv.make_corpus(root, n_utts=8, seconds=0.25, seed=3)
    os.makedirs(f"{root}/tt4")
    for part in ("mix", "s1", "s2"):
        with open(f"{root}/tt/{part}.json") as f:
            entries = json.load(f)[:4]
        with open(f"{root}/tt4/{part}.json", "w") as f:
            json.dump(entries, f)
    return root


def _argv(model, root, *extra):
    return ["--data.train_dir", f"{root}/tr", "--data.test_dir", f"{root}/tt4", *TOY[model],
            *extra]


@pytest.mark.parametrize("model", MODELS)
def test_config_matches_the_jax_recipe(model):
    argv = TOY[model] + ["--optim.lr", "0.002"]
    tcfg, device = PORT[model][0].parse_args(argv + ["--device", "cpu"])
    jcfg = jconfig.get_config(os.path.join(REPO, "examples", model, f"{model}.yaml"), argv)
    assert tcfg.to_dict() == jcfg.to_dict() and device == torch.device("cpu")
    assert tcfg.optim.lr == 0.002 and tcfg.optim.grad_clip == 5.0


# -------------------------------------------------------------- host copies


def test_metric_copies():
    rng = np.random.default_rng(0)
    for c, perm in ((2, True), (2, False), (3, True)):
        ref = rng.standard_normal((c, 1500))
        est = ref[::-1] + 0.3 * rng.standard_normal(ref.shape)
        for got, want in zip(tsnr.bss_eval_sources(ref, est, compute_permutation=perm),
                             jsnr.bss_eval_sources(ref, est, compute_permutation=perm)):
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    mix = ref.sum(0)
    np.testing.assert_allclose(tsnr.cal_SISNRi(ref, est, mix), jsnr.cal_SISNRi(ref, est, mix),
                               rtol=1e-9)
    ref, est, mix = ref[:2], est[:2], ref[:2].sum(0)
    np.testing.assert_allclose(tsnr.cal_SDRi(ref, est, mix), jsnr.cal_SDRi(ref, est, mix),
                               rtol=1e-9)
    assert tsnr.cal_SISNR(ref[0], est[1]) == pytest.approx(jsnr.cal_SISNR(ref[0], est[1]),
                                                           rel=1e-9)


def test_librimix_copies(corpus, tmp_path):
    for out, module in ((tmp_path / "t", tlibrimix), (tmp_path / "j", jlibrimix)):
        module.preprocess_librimix(corpus, str(out), splits=("tr", "tt"))
    for split in ("tr", "tt"):
        for part in ("mix", "s1", "s2"):
            got = (tmp_path / "t" / split / f"{part}.json").read_text()
            assert got == (tmp_path / "j" / split / f"{part}.json").read_text()
            assert len(json.loads(got)) == 8
    for kw in (dict(batch_size=3, segment_len=1500, epochs=2, seed=4),
               dict(batch_size=2, segment_len=2600, epochs=1, shuffle=False),
               dict(batch_size=4, segment_len=1000, epochs=1, seed=1, rank=1, world_size=2)):
        got = list(tlibrimix.separation_batch_iterator(f"{corpus}/tr", **kw))
        want = list(jlibrimix.separation_batch_iterator(f"{corpus}/tr", **kw))
        assert len(got) == len(want) > 0
        for (ge, gb), (we, wb) in zip(got, want):
            assert ge == we and set(gb) == set(wb) == {"mix", "src", "lengths"}
            for k in gb:
                assert gb[k].dtype == wb[k].dtype
                np.testing.assert_array_equal(gb[k], wb[k])


def test_make_corpus_writes_the_same_bytes(jax_side, tmp_path):
    def digest(root):
        out = {}
        for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
            if os.path.isfile(path):
                data = open(path, "rb").read().replace(str(root).encode(), b"ROOT")
                out[os.path.relpath(path, root)] = hashlib.sha256(data).hexdigest()
        return out

    ours, theirs = tmp_path / "t", tmp_path / "j"
    tconv.make_corpus(str(ours), n_utts=3, seconds=0.1, seed=5)
    jax_side.bench.make_corpus(str(theirs), n_utts=3, seconds=0.1, seed=5)
    got = digest(str(ours))
    assert got == digest(str(theirs)) and len(got) == (3 + 8) * 3 + 6


# ------------------------------------------------------------ one train step


def _draw(tree, rng):
    def leaf(path, a):
        name = path[-1].key
        if name in ("scale", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bias", "beta"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "negative_slope":
            return np.asarray(rng.uniform(0.0, 0.3), np.float32)
        return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _running_adam(opt_state, rng):
    """Moments drawn with numpy, count 3: an update smooth in the gradient."""
    adam = opt_state[0]
    mu = jax.tree_util.tree_map(
        lambda m: jnp.asarray(1e-3 * rng.standard_normal(m.shape), jnp.float32), adam.mu)
    nu = jax.tree_util.tree_map(
        lambda v: jnp.asarray(1e-4 * (1.0 + rng.random(v.shape)), jnp.float32), adam.nu)
    return (adam._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu), *opt_state[1:])


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jax_model(jax_side, model, jcfg):
    """``(flax model, forward(params, mix) -> (B, C, T))`` as the JAX recipe
    builds and runs it."""
    jtrain = jax_side.train[model]
    jmodel = jtrain.build_model(jcfg)
    if model == "tasnet":
        return jmodel, lambda params, mix: jtrain.separate_full(jmodel, params, mix)
    return jmodel, lambda params, mix: jmodel.apply({"params": params}, mix)


def _param_shapes(jmodel, model, mix):
    """The flax parameter shapes, the model initialised as its recipe does
    (TasNet on the framed mixture)."""
    def init(m):
        return jmodel.init(jax.random.PRNGKey(0),
                           jmodel.frame_waveform(m) if model == "tasnet" else m)
    return jax.eval_shape(init, jnp.asarray(mix))["params"]


def _jax_step(forward, grad_clip):
    """The JAX recipes' step (``examples/conv_tasnet/train.py:76-88``, the
    same in ``examples/tasnet``)."""
    def loss_fn(params, batch):
        loss, _ = jpit(forward(params, batch["mix"]), batch["src"], batch["lengths"])
        return loss

    def step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        new_state = skip_nonfinite_update(state, state.apply_gradients(grads=grads), loss,
                                          grads=grads)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return jax.jit(step)


@pytest.mark.parametrize("model", MODELS)
def test_one_step_matches_the_jax_recipe_and_a_nan_batch(jax_side, corpus, model):
    argv = _argv(model, corpus, "--optim.lr", "0.01")
    jcfg = jconfig.get_config(os.path.join(REPO, "examples", model, f"{model}.yaml"), argv)
    ttrain, _, separate_fn = PORT[model]
    tcfg, _ = ttrain.parse_args(argv + ["--device", "cpu"])
    # crops of 0.3 s from utterances of 0.25 s: zero-padded, lengths 2000
    _, batch = next(tlibrimix.separation_batch_iterator(f"{corpus}/tr", 2, 2400, seed=2))
    assert (batch["lengths"] == 2000).all()

    jmodel, forward = _jax_model(jax_side, model, jcfg)
    rng = np.random.default_rng(11)
    params = _draw(_param_shapes(jmodel, model, batch["mix"]), rng)
    state = TrainState.create(apply_fn=jmodel.apply, params=params,
                              tx=optax.adam(float(jcfg.optim.lr)))
    state = state.replace(opt_state=_running_adam(state.opt_state, rng))
    opt_host = _host(state.opt_state)
    jstep = _jax_step(forward, float(jcfg.optim.grad_clip))

    tmodel = ttrain.build_model(tcfg, torch.device("cpu"))
    tmodel.load_state_dict(convert_params(params), strict=True)
    tmodel.train()
    opt = tct_train.make_optimizer(tcfg, tmodel)
    opt.load_state_dict(convert_adamw_state(opt_host))
    tstep = tct_train.make_step(tcfg, tmodel, opt, separate_fn)

    def run(b):
        nonlocal state
        before_j = convert_params(_host(state.params))
        state, want = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        after_j = convert_params(_host(state.params))
        before_t = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
        got = tstep({k: torch.from_numpy(v) for k, v in b.items()})
        return (want, {n: after_j[n] - before_j[n] for n in before_j}, got,
                {n: p.detach() - before_t[n] for n, p in tmodel.named_parameters()})

    want, want_updates, got, updates = run(batch)
    assert set(updates) == set(want_updates)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    for name, w in want_updates.items():
        assert w.abs().max() > 0, name
        np.testing.assert_allclose(updates[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * w.abs().max().item(), err_msg=name)
    assert opt.count.item() == int(state.opt_state[0].count) == 4

    # a NaN in one mixture: both keep the parameters, moments and count
    bad = dict(batch, mix=batch["mix"].copy())
    bad["mix"][1, 7] = np.nan
    moments = {k: [t.clone() for t in getattr(opt, k)] for k in ("mu", "nu")}
    jmoments = _host(state.opt_state[0])
    want, want_updates, got, updates = run(bad)
    assert np.isnan(got["loss"].item()) and np.isnan(float(want["loss"]))
    assert opt.count.item() == int(state.opt_state[0].count) == 4
    for name in updates:
        assert not updates[name].any() and not want_updates[name].any(), name
    for k in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(opt, k), moments[k]))
        for a, b in zip(jax.tree_util.tree_leaves(getattr(state.opt_state[0], k)),
                        jax.tree_util.tree_leaves(getattr(jmoments, k))):
            np.testing.assert_array_equal(np.asarray(a), b)


# ------------------------------------------------------------------- eval


@pytest.mark.parametrize("model", MODELS)
def test_eval_matches_the_jax_eval(jax_side, corpus, model):
    """The JAX recipes' eval loop (``examples/conv_tasnet/eval.py:33-57``)
    restated on the JAX model, against the port's ``evaluate``, from the
    same weights; test utterances of 2000 samples padded to the recipe's
    4 s segment."""
    argv = _argv(model, corpus)
    jcfg = jconfig.get_config(os.path.join(REPO, "examples", model, f"{model}.yaml"), argv)
    ttrain, _, separate_fn = PORT[model]
    tcfg, _ = ttrain.parse_args(argv + ["--device", "cpu"])
    seg = int(float(jcfg.data.segment_seconds) * int(jcfg.data.sample_rate))
    jmodel, forward = _jax_model(jax_side, model, jcfg)
    params = _draw(_param_shapes(jmodel, model, np.zeros((1, seg), np.float32)),
                   np.random.default_rng(12))

    @jax.jit
    def separate(mix, src, lengths):
        est = forward(params, mix)
        _, perm = jpit(est, src, lengths)
        return est, jnp.take_along_axis(src, perm[:, :, None], axis=1)

    si_snri, sdri, count = 0.0, 0.0, 0
    for _, batch in jlibrimix.separation_batch_iterator(jcfg.data.test_dir, 1, seg, epochs=1,
                                                        shuffle=False):
        est, src = separate(*(jnp.asarray(batch[k]) for k in ("mix", "src", "lengths")))
        n = int(batch["lengths"][0])
        est, src, mix = np.asarray(est)[0, :, :n], np.asarray(src)[0, :, :n], batch["mix"][0, :n]
        si_snri += jsnr.cal_SISNRi(src, est, mix)[0]
        sdri += jsnr.cal_SDRi(src, est, mix)[0]
        count += 1

    tmodel = ttrain.build_model(tcfg, torch.device("cpu"))
    tmodel.load_state_dict(convert_params(params), strict=True)
    got = tct_eval.evaluate(tmodel, separate_fn, tcfg.data.test_dir, tct_train.segment_len(tcfg),
                            torch.device("cpu"))
    assert got["utts"] == count == 4
    assert abs(got["si_snri"] - si_snri / count) <= 1e-3
    assert abs(got["sdri"] - sdri / count) <= 1e-3


# ------------------------------------------------------------- end to end


@pytest.mark.parametrize("model", MODELS)
def test_train_and_eval_end_to_end(corpus, tmp_path, model):
    ttrain, teval, _ = PORT[model]
    argv = _argv(model, corpus, "--device", "cpu", "--data.segment_seconds", "0.2",
                 "--data.batch_size", "4", "--train.ckpt_dir", str(tmp_path / "ckpt"),
                 "--train.max_steps", "3", "--train.log_every_steps", "2",
                 "--train.save_every_steps", "2")
    out = ttrain.main(argv)
    assert out["steps"] == 3 and sorted(out["losses"]) == [1, 2]
    assert np.isfinite(list(out["losses"].values())).all()
    assert tckpt.list_steps(str(tmp_path / "ckpt")) == [2, 3]
    saved = tckpt.restore_checkpoint(str(tmp_path / "ckpt"))
    assert set(saved) == {"params", "buffers", "step"} and int(saved["step"]) == 3
    for name, p in out["model"].named_parameters():
        assert torch.equal(saved["params"][name], p.detach()), name
    result = teval.main(argv)
    assert result["utts"] == 4 and np.isfinite([result["si_snri"], result["sdri"]]).all()


def test_check_supported_refuses_several_processes(monkeypatch):
    """Several processes run data parallel, but only over a global batch
    they split evenly."""
    cfg, _ = tct_train.parse_args(["--device", "cpu"])
    tct_train.check_supported(cfg)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    cfg.data["batch_size"] = 4
    tct_train.check_supported(cfg)
    cfg.data["batch_size"] = 3
    with pytest.raises(ValueError, match="data parallel"):
        tct_train.check_supported(cfg)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the error path is for CPU-only hosts")
    for parse in (tct_train.parse_args, ttas_train.parse_args):
        with pytest.raises(RuntimeError, match="CUDA"):
            parse([])
    with pytest.raises(RuntimeError, match="CUDA"):
        tconv.main(["--steps", "1"])


def test_convergence_run_end_to_end(tmp_path, monkeypatch):
    """Two steps of the protocol on clips of 0.25 s, the TF32 flag on (it
    only touches cuDNN): the result lands in ``results.json`` under its
    key, beside what was there."""
    monkeypatch.setattr(tconv, "SECONDS", 0.25)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    out = tmp_path / "out"
    out.mkdir()
    (out / "results.json").write_text(json.dumps({"earlier": {}}))
    result = tconv.main(["--model", "tasnet", "--steps", "2", "--init-seed", "3",
                         "--cudnn-tf32", "--device", "cpu", "--root", str(tmp_path / "c"),
                         "--out", str(out)])
    stored = json.loads((out / "results.json").read_text())
    assert set(stored) == {"earlier", "tasnet seed 3 tf32 on"}
    assert stored["tasnet seed 3 tf32 on"] == result
    assert result["utts"] == 8 and result["device"] == "cpu" and result["steps"] == 2
    assert np.isfinite([result["final_loss"], result["si_snri_db"], result["sdri_db_bss_eval"]]).all()

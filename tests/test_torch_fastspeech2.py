"""Port parity for FastSpeech2's modules (``mindaudio_torch.models.fastspeech2``,
``loss/fastspeech2_loss``, ``scheduler.exponential_decay_lr`` and
``convert`` on its flax trees) against the JAX package on the same numpy
inputs, on the CPU at a toy size (d_model 32, 2 heads, FFN 64, 2 encoder and
2 decoder blocks, 16 mels; the variance predictors keep their filter of
256, as in JAX).

Tolerances, all float32 on both sides:
- ``FFTBlock``, ``VariancePredictor`` and the whole model's outputs (with
  targets and through ``infer``): 1e-5 of the largest output (sums of a
  few hundred products and LayerNorm statistics in another order); integer
  outputs (predicted durations, ``mel_len``, the masks) exactly;
- ``LengthRegulator``: exact (a gather), on zero durations, totals past
  ``max_len`` and padded phonemes;
- the bucket edges: bit for bit with ``np.asarray(jnp.linspace(...))``, and
  the buckets exactly, values on the edges included; within one ulp of the
  range's largest magnitude of the edges JAX folds under jit;
- the loss terms 1e-6 relative and their gradients 1e-6 of the largest;
- ``exponential_decay_lr``: exact with the staircase, 1e-6 relative without
  (a float32 power computed by another library);
- one deterministic train step of the recipe (the loss, the clip at 1.0,
  Adam at the schedule, ``skip_nonfinite_update``) from the same parameters
  and a running Adam state at a learning rate of 0.05, then a second one on
  those moments: the loss
  within 1e-5 relative, the gradient norm 1e-4, each parameter's update
  within 1e-4 of its leaf's largest or one float32 ulp of the parameter
  (the resolution of an update measured as a difference of parameters),
  the larger; a NaN batch leaves both as they were;
- dropout (the model's 0.2, the variance predictors' fixed 0.5): the keep
  share within 5 standard deviations of ``(256 - round(256 r)) / 256``.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.models import fastspeech2 as jfs2
from mindaudio_tpu.scheduler import schedules as jsched
from mindaudio_tpu.train import config as jconfig
from mindaudio_tpu.train.state import TrainState, clip_by_global_norm, skip_nonfinite_update
from mindaudio_torch import loss as tloss_pkg
from mindaudio_torch.convert import convert_adamw_state, convert_params, unwrap_model_scope
from mindaudio_torch.models import fastspeech2 as tfs2
from mindaudio_torch.models.layers import FastDropout
from mindaudio_torch.recipes.fastspeech2 import train as ttrain
from mindaudio_torch.scheduler import schedules as tsched

torch.set_num_threads(1)
# the modules (each package binds the name to the function)
jloss = importlib.import_module("mindaudio_tpu.loss.fastspeech2_loss")
tloss = importlib.import_module("mindaudio_torch.loss.fastspeech2_loss")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
D, HEADS, FFN, N_MELS, VOCAB, MAX_SEQ = 32, 2, 64, 16, 50, 64
TOY = dict(vocab_size=VOCAB, d_model=D, n_mels=N_MELS, encoder_layers=2, decoder_layers=2,
           head_num=HEADS, conv_filter=FFN, max_seq_len=MAX_SEQ, dropout_rate=0.2)


def _close(got, want, atol_of_peak=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_of_peak * np.abs(want).max())


def _draw(tree, rng):
    """Parameters drawn with numpy for a ``jax.eval_shape`` tree: kernels
    with std 1/sqrt(fan in), embeddings N(0, 1), biases 0.1 N(0, 1), scales
    1 + 0.1 N(0, 1)."""
    def leaf(path, a):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "embedding":
            return rng.standard_normal(a.shape).astype(np.float32)
        return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _init(module, *inputs, seed=1, **kw):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw),
                            *map(jnp.asarray, inputs))
    return _draw(shapes["params"], np.random.default_rng(seed))


def _port(module, params):
    module.load_state_dict(convert_params(params), strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _batch(rng, b=3, lp=12, t=40, lens=(12, 7, 1)):
    """A toy batch: phonemes, lengths, durations (zeros included, padded
    phonemes 0), pitch near the log1p(Hz) range, energies, mel targets."""
    lens = np.asarray(lens, np.int32)
    valid = np.arange(lp)[None] < lens[:, None]
    phonemes = np.where(valid, rng.integers(1, VOCAB, (b, lp)), 0).astype(np.int32)
    duration = np.where(valid, rng.integers(0, 6, (b, lp)), 0).astype(np.int32)
    pitch = np.where(valid, rng.uniform(3.5, 6.0, (b, lp)), 0).astype(np.float32)
    energy = np.where(valid, rng.uniform(0.0, 6.0, (b, lp)), 0).astype(np.float32)
    mel = rng.standard_normal((b, t, N_MELS)).astype(np.float32)
    return {"phonemes": phonemes, "src_lens": lens, "mel": mel, "pitch": pitch,
            "energy": energy, "duration": duration}


# ------------------------------------------------------------------ blocks


def test_fft_block():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 10, D)).astype(np.float32)
    mask = np.arange(10)[None] < np.array([10, 6, 1])[:, None]
    jm = jfs2.FFTBlock(D, HEADS, FFN)
    params = _init(jm, x, mask)
    want = jm.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask))
    got = _port(tfs2.FFTBlock(D, HEADS, FFN), params)(_t(x), _t(mask))
    _close(got.detach(), want)
    assert not got[~_t(mask)].any()
    # no mask at all
    want = jm.apply({"params": params}, jnp.asarray(x))
    _close(_port(tfs2.FFTBlock(D, HEADS, FFN), params)(_t(x)).detach(), want)


def test_fft_block_with_no_valid_key():
    """An all-False mask (``mel_len = 0``): -1e9 gives a uniform softmax and
    finite values, zeroed rows, as in JAX."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    mask = np.arange(6)[None] < np.array([0, 3])[:, None]
    jm = jfs2.FFTBlock(D, HEADS, FFN)
    params = _init(jm, x, mask)
    want = jm.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask))
    got = _port(tfs2.FFTBlock(D, HEADS, FFN), params)(_t(x), _t(mask)).detach()
    assert torch.isfinite(got).all() and not got[0].any()
    _close(got, want)


def test_variance_predictor():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, D)).astype(np.float32)
    mask = np.arange(9)[None] < np.array([9, 4, 0])[:, None]
    jm = jfs2.VariancePredictor()
    params = _init(jm, x, mask)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    got = _port(tfs2.VariancePredictor(D), params)(_t(x), _t(mask)).detach()
    _close(got, want)
    assert not got[~_t(mask)].any()


@pytest.mark.parametrize("case", ["plain", "zeros", "past_max_len", "all_zero", "padded"])
def test_length_regulator(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4)).astype(np.float32)
    dur = {"plain": [[1, 2, 3, 1, 2], [2, 2, 2, 2, 2]],
           "zeros": [[0, 3, 0, 0, 2], [0, 0, 0, 0, 4]],
           "past_max_len": [[5, 5, 5, 5, 5], [9, 0, 9, 0, 1]],
           "all_zero": [[0, 0, 0, 0, 0], [1, 0, 0, 0, 0]],
           "padded": [[2, 1, 0, 0, 0], [3, 3, 3, 0, 0]]}[case]
    dur = np.asarray(dur, np.int32)
    want_x, want_len = jfs2.LengthRegulator().apply({}, jnp.asarray(x), jnp.asarray(dur), 12)
    got_x, got_len = tfs2.LengthRegulator()(_t(x), _t(dur), 12)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


# ---------------------------------------------------------------- buckets


@pytest.mark.parametrize("lo,hi", [tfs2.PITCH_RANGE, tfs2.ENERGY_RANGE, (-7.3, 3.1), (0.0, 1.0)])
def test_bucket_edges_bit_for_bit(lo, hi):
    want = np.asarray(jnp.linspace(lo, hi, tfs2.N_BINS - 1))
    got = tfs2.jax_linspace(lo, hi, tfs2.N_BINS - 1)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi,n_differ", [(*tfs2.PITCH_RANGE, 89), (*tfs2.ENERGY_RANGE, 85)])
def test_bucket_edges_one_ulp_from_the_jitted_ones(lo, hi, n_differ):
    # the JAX recipe runs the adaptor under jit, where XLA folds the edges
    # without the fused multiply-add: one ulp of the range apart at some
    jitted = np.asarray(jax.jit(lambda: jnp.linspace(lo, hi, tfs2.N_BINS - 1))())
    got = tfs2.jax_linspace(lo, hi, tfs2.N_BINS - 1)
    assert (got != jitted).sum() == n_differ
    ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
    assert np.abs(got.astype(np.float64) - jitted).max() <= ulp


def test_adaptor_edges_and_buckets_at_the_edges():
    adaptor = tfs2.VarianceAdaptor(D)
    bins = {"pitch": np.asarray(jnp.linspace(*tfs2.PITCH_RANGE, 255)),
            "energy": np.asarray(jnp.linspace(*tfs2.ENERGY_RANGE, 255))}
    rng = np.random.default_rng(4)
    for name, want_bins in bins.items():
        got_bins = getattr(adaptor, f"{name}_bins")
        np.testing.assert_array_equal(got_bins.numpy().view(np.int32), want_bins.view(np.int32))
        # on every edge, one ulp either side, outside the range, and between
        values = np.concatenate([want_bins, np.nextafter(want_bins, np.inf),
                                 np.nextafter(want_bins, -np.inf), [-100.0, 100.0, 0.0],
                                 rng.uniform(want_bins[0] - 1, want_bins[-1] + 1, 500)])
        values = values.astype(np.float32).reshape(4, -1)
        want = jfs2.VarianceAdaptor._bucketize(None, jnp.asarray(values), jnp.asarray(want_bins))
        got = adaptor.bucketize(_t(values), got_bins)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.min() == 0 and got.max() == 255


# ------------------------------------------------------------ whole model


def _model_pair(rng, batch, seed=5):
    jm = jfs2.FastSpeech2(**TOY)
    params = _init(jm, batch["phonemes"], batch["src_lens"], seed=seed,
                   max_mel_len=batch["mel"].shape[1])
    tm = _port(tfs2.FastSpeech2(**TOY, device="cpu"), params)
    return jm, params, tm


def _compare_outputs(got, want):
    mel, log_d, p, e, mel_len, mel_mask = got
    jmel, jlog_d, jp, je, jmel_len, jmel_mask = want
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(jmel_len))
    np.testing.assert_array_equal(mel_mask.numpy(), np.asarray(jmel_mask))
    for a, b in ((mel, jmel), (log_d, jlog_d), (p, jp), (e, je)):
        assert torch.isfinite(a).all()
        _close(a.detach(), b)


def test_model_with_targets():
    rng = np.random.default_rng(6)
    batch = _batch(rng)
    jm, params, tm = _model_pair(rng, batch)
    t = batch["mel"].shape[1]
    keys = ("pitch", "energy", "duration")
    want = jm.apply({"params": params}, jnp.asarray(batch["phonemes"]),
                    jnp.asarray(batch["src_lens"]), t,
                    **{f"{k}_target": jnp.asarray(batch[k]) for k in keys})
    got = tm(_t(batch["phonemes"]).long(), _t(batch["src_lens"]).long(), t,
             **{f"{k}_target": _t(batch[k]) for k in keys})
    _compare_outputs(got, want)


@pytest.mark.parametrize("controls", [(1.0, 1.0, 1.0), (1.1, 0.9, 1.3)])
def test_model_infer(controls):
    rng = np.random.default_rng(7)
    batch = _batch(rng)
    jm, params, tm = _model_pair(rng, batch)
    p_c, e_c, d_c = controls
    want = jm.apply({"params": params}, jnp.asarray(batch["phonemes"]),
                    jnp.asarray(batch["src_lens"]), 60, p_control=p_c, e_control=e_c,
                    d_control=d_c, method=jm.infer)
    tm.train()  # infer runs without dropout whatever the mode, and keeps it
    got = tm.infer(_t(batch["phonemes"]).long(), _t(batch["src_lens"]).long(), 60,
                   p_control=p_c, e_control=e_c, d_control=d_c)
    assert tm.training
    _compare_outputs(got, want)
    assert 0 < int(got[4].max()) <= 60


def test_model_infer_with_zero_frames():
    """A collapsed duration predictor (every duration rounds to 0): mel_len 0,
    an all-False decoder mask, finite output equal to JAX's."""
    rng = np.random.default_rng(8)
    batch = _batch(rng)
    jm, params, tm = _model_pair(rng, batch)
    params["variance_adaptor"]["duration_predictor"]["linear"]["bias"] = np.full(
        (1,), -30.0, np.float32)
    tm = _port(tfs2.FastSpeech2(**TOY, device="cpu"), params)
    want = jm.apply({"params": params}, jnp.asarray(batch["phonemes"]),
                    jnp.asarray(batch["src_lens"]), 20, method=jm.infer)
    got = tm.infer(_t(batch["phonemes"]).long(), _t(batch["src_lens"]).long(), 20)
    assert not got[4].any()
    _compare_outputs(got, want)


def test_convert_rules():
    rng = np.random.default_rng(9)
    batch = _batch(rng)
    jm = jfs2.FastSpeech2WithLoss(model=jfs2.FastSpeech2(**TOY))
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a),
                            *map(jnp.asarray, (batch["phonemes"], batch["src_lens"],
                                               batch["mel"], batch["pitch"], batch["energy"],
                                               batch["duration"])))["params"]
    params = _draw(shapes, rng)
    fs2 = tfs2.FastSpeech2(**TOY, device="cpu")
    net = tfs2.FastSpeech2WithLoss(fs2)
    # the scoped tree names the loss module's parameters, the unwrapped one the model's
    net.load_state_dict(convert_params(params), strict=True)
    fs2.load_state_dict(convert_params(unwrap_model_scope(params)), strict=True)
    assert unwrap_model_scope(params["model"]) is params["model"]
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert n == sum(p.numel() for p in fs2.parameters())
    with pytest.raises(ValueError, match="no rule places"):
        convert_params({"enc_0": {"w_q": {"kernel_scale": np.ones(3, np.float32)}}})


def test_full_width_parameter_count():
    """``fastspeech2.yaml``'s width with the recipe's 288 symbols and 80 mels."""
    cfg, _, _ = ttrain.parse_args(["--device", "cpu"])
    with torch.device("meta"):
        fs2 = tfs2.FastSpeech2(vocab_size=288, n_mels=80, max_seq_len=1000, device="meta")
    assert (cfg.model.d_model, cfg.model.conv_filter) == (256, 1024)
    assert sum(p.numel() for p in fs2.parameters()) == 30_279_507


# --------------------------------------------------------------- the loss


def test_loss_and_gradient():
    rng = np.random.default_rng(10)
    b, lp, t = 3, 12, 40
    src_mask = np.arange(lp)[None] < np.array([12, 5, 0])[:, None]
    mel_mask = np.arange(t)[None] < np.array([40, 17, 0])[:, None]
    args = dict(mel_pred=rng.standard_normal((b, t, N_MELS)),
                mel_target=rng.standard_normal((b, t, N_MELS)),
                log_d_pred=rng.standard_normal((b, lp)),
                duration_target=rng.integers(0, 9, (b, lp)).astype(np.int32),
                p_pred=rng.standard_normal((b, lp)), p_target=rng.standard_normal((b, lp)),
                e_pred=rng.standard_normal((b, lp)), e_target=rng.standard_normal((b, lp)))
    args = {k: v if v.dtype == np.int32 else v.astype(np.float32) for k, v in args.items()}
    wrt = ("mel_pred", "log_d_pred", "p_pred", "e_pred")

    def jtotal(*diff):
        a = dict(args, **dict(zip(wrt, diff)))
        return jloss.fastspeech2_loss(**{k: jnp.asarray(v) for k, v in a.items()},
                                      src_mask=jnp.asarray(src_mask),
                                      mel_mask=jnp.asarray(mel_mask))[0]

    want = jloss.fastspeech2_loss(**{k: jnp.asarray(v) for k, v in args.items()},
                                  src_mask=jnp.asarray(src_mask), mel_mask=jnp.asarray(mel_mask))
    want_g = jax.grad(jtotal, argnums=tuple(range(4)))(*(jnp.asarray(args[k]) for k in wrt))
    targs = {k: _t(v).requires_grad_(k in wrt) for k, v in args.items()}
    got = tloss_pkg.FastSpeech2Loss(**targs, src_mask=_t(src_mask), mel_mask=_t(mel_mask))
    assert tloss_pkg.FastSpeech2Loss is tloss.fastspeech2_loss
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)
    got_g = torch.autograd.grad(got[0], [targs[k] for k in wrt])
    for g, w in zip(got_g, want_g):
        _close(g, w, 1e-6)
    # empty masks: the counts are floored at 1, the loss is finite
    empty = tloss.fastspeech2_loss(**{k: v.detach() for k, v in targs.items()},
                                   src_mask=torch.zeros(b, lp, dtype=torch.bool),
                                   mel_mask=torch.zeros(b, t, dtype=torch.bool))
    assert all(float(x) == 0.0 for x in empty)


# ------------------------------------------------------------- the schedule


@pytest.mark.parametrize("args,exact", [((1e-3, 0.96, 5000, True, 1000), True),
                                        ((5e-4, 0.96, 5000, True, 1000), True),
                                        ((1e-3, 0.96, 5000, True, 0), True),
                                        ((1e-3, 0.96, 500, False, 30), False)])
def test_exponential_decay_lr(args, exact):
    steps = np.arange(0, 12001, dtype=np.int32)
    lr, rate, decay, stair, warm = args
    want = np.asarray(jsched.exponential_decay_lr(lr, rate, decay, stair, warm)(
        jnp.asarray(steps)))
    got = tsched.exponential_decay_lr(lr, rate, decay, stair, warm)(_t(steps)).numpy()
    assert got.dtype == np.float32 and got[0] == want[0]
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tsched.exponential_decay_lr(lr, rate, decay, stair, warm)(3)) == pytest.approx(
        float(want[3]), rel=1e-6)


# ------------------------------------------------------------ the train step


def _running_adam(opt_state, rng):
    """Moments drawn with numpy, count 3 (Adam's and the schedule's, which
    advance together): an update smooth in the gradient."""
    adam, schedule = opt_state
    mu = jax.tree_util.tree_map(
        lambda m: jnp.asarray(1e-3 * rng.standard_normal(m.shape), jnp.float32), adam.mu)
    nu = jax.tree_util.tree_map(
        lambda v: jnp.asarray(1e-4 * (1.0 + rng.random(v.shape)), jnp.float32), adam.nu)
    count = jnp.asarray(3, jnp.int32)
    return (adam._replace(count=count, mu=mu, nu=nu), schedule._replace(count=count))


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


TOY_ARGS = ["--model.d_model", str(D), "--model.head_num", str(HEADS), "--model.conv_filter",
            str(FFN), "--model.encoder_layers", "2", "--model.decoder_layers", "2",
            "--data.n_mels", str(N_MELS), "--data.max_phoneme_len", "12",
            "--data.max_mel_len", "40", "--optim.warmup_steps", "6", "--optim.lr", "0.05"]


def test_train_step_matches_jax_and_a_nan_batch():
    """The JAX recipe's step (``examples/fastspeech2/train.py``: the loss of
    ``FastSpeech2WithLoss``, ``clip_by_global_norm(1.0)``, ``optax.adam`` at
    the warm-up schedule, ``skip_nonfinite_update``), deterministic, against
    the port's ``make_step`` with the model in eval mode. The learning rate
    is 0.05 (0.025 at count 3), so that an update is many float32 ulps of
    its parameter: against 1e-3 one ulp of a parameter is 1e-3 of a leaf's
    largest update, and either side may round the sum either way."""
    jcfg = jconfig.get_config(os.path.join(REPO, "examples", "fastspeech2", "fastspeech2.yaml"),
                              TOY_ARGS)
    tcfg, device, _ = ttrain.parse_args(TOY_ARGS + ["--device", "cpu"])
    assert tcfg.to_dict() == jcfg.to_dict()
    rng = np.random.default_rng(12)
    batch = _batch(rng)
    o = jcfg.optim
    schedule = jsched.exponential_decay_lr(float(o.lr), float(o.decay_rate),
                                           int(o.decay_steps), warmup_steps=int(o.warmup_steps))
    fs2 = jfs2.FastSpeech2(**dict(TOY, vocab_size=288, dropout_rate=0.2))
    jnet = jfs2.FastSpeech2WithLoss(model=fs2)
    keys = ("phonemes", "src_lens", "mel", "pitch", "energy", "duration")
    shapes = jax.eval_shape(lambda *a: jnet.init(jax.random.PRNGKey(0), *a),
                            *(jnp.asarray(batch[k]) for k in keys))["params"]
    params = _draw(shapes, rng)
    state = TrainState.create(apply_fn=jnet.apply, params=params, tx=optax.adam(schedule))
    state = state.replace(opt_state=_running_adam(state.opt_state, rng))

    def loss_fn(p, b):
        return jnet.apply({"params": p}, *(b[k] for k in keys))[0]

    @jax.jit
    def jstep(state, b):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, b)
        grads, gnorm = clip_by_global_norm(grads, float(o.grad_clip))
        new = skip_nonfinite_update(state, state.apply_gradients(grads=grads), loss, grads=grads)
        return new, {"loss": loss, "grad_norm": gnorm}

    tfs, tnet = ttrain.build_model(tcfg, device)
    tnet.load_state_dict(convert_params(params), strict=True)
    tnet.eval()
    opt = ttrain.make_optimizer(tcfg, tnet)
    opt.load_state_dict(convert_adamw_state(_host(state.opt_state)))
    tstep = ttrain.make_step(tcfg, tnet, opt)

    def run(b):
        nonlocal state
        before_j = convert_params(_host(state.params))
        state, want = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        after_j = convert_params(_host(state.params))
        before_t = {n: p.detach().clone() for n, p in tnet.named_parameters()}
        got = tstep({k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in b.items()})
        return (want, {n: after_j[n] - before_j[n] for n in before_j}, got,
                {n: p.detach() - before_t[n] for n, p in tnet.named_parameters()})

    for count in (4, 5):  # the second step runs on the moments the first left
        want, want_updates, got, updates = run(batch)
        assert set(updates) == set(want_updates)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
        params_now = dict(tnet.named_parameters())
        for name, w in want_updates.items():
            assert w.abs().max() > 0, name
            # an update is measured as a difference of float32 parameters,
            # so one ulp of the parameter is its resolution
            ulp = np.spacing(np.abs(params_now[name].detach().numpy()))
            tol = np.maximum(1e-4 * w.abs().max().item(), ulp)
            err = np.abs(updates[name].numpy() - w.numpy())
            assert (err <= tol).all(), (name, float((err / tol).max()))
        assert opt.count.item() == int(state.opt_state[0].count) == count
        assert int(state.opt_state[1].count) == count

    bad = dict(batch, pitch=batch["pitch"].copy())
    bad["pitch"][1, 2] = np.nan
    want, want_updates, got, updates = run(bad)
    assert np.isnan(got["loss"].item()) and np.isnan(float(want["loss"]))
    assert opt.count.item() == int(state.opt_state[0].count) == 5
    for name in updates:
        assert not updates[name].any() and not want_updates[name].any(), name


# ----------------------------------------------------------------- dropout


def test_dropout_rates_and_keep_share():
    fs2 = tfs2.FastSpeech2(**TOY, device="cpu")
    gen = torch.Generator().manual_seed(0)
    fs2.set_dropout_generator(gen)
    rates = {}
    for name, m in fs2.named_modules():
        if isinstance(m, FastDropout):
            assert m.generator is gen
            rates[name] = m.rate
    predictors = {n: r for n, r in rates.items() if "predictor" in n}
    assert len(predictors) == 6 and set(predictors.values()) == {0.5}
    assert set(r for n, r in rates.items() if n not in predictors) == {0.2}
    x = torch.ones(1 << 20)
    for rate in (0.2, 0.5):
        drop = FastDropout(rate, torch.Generator().manual_seed(1)).train()
        y = drop(x)
        p = (256 - round(256 * rate)) / 256
        share = (y != 0).float().mean().item()
        assert abs(share - p) < 5 * np.sqrt(p * (1 - p) / x.numel())
        assert torch.all((y == 0) | (y == 1 / p))

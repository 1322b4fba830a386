"""Port parity for the WaveGrad vocoder (``mindaudio_torch.models.wavegrad``
and ``convert.convert_params`` on its flax tree) against the JAX package on
the same numpy inputs, on the CPU at toy widths (channels 8-32, 4 frames x
hop 300, as ``tests/test_models.py`` builds it), float32 on both sides.

Tolerances:
- ``PositionalEncoding``, ``FiLM``, ``DBlock``, ``UBlock`` and the whole
  ``WaveGrad``: 1e-5 of the largest output (sums of a few hundred products
  in another order);
- the L1 loss and every gradient leaf: 1e-4 relative (the loss) and 1e-4 of
  the leaf's largest element (the gradients: the backward of the same sums);
- two Adam steps under the linear warm-up: the first is the identity
  exactly, the second within 1e-3 of each leaf's largest update (Adam's
  ``m / sqrt(v)`` divides the gradient's scale out, so an element whose two
  gradients nearly cancel carries their relative error into its update:
  3e-4 at worst here, in 2 of 73,728 elements);
- the sampler on JAX's own draws: 1e-4 of the largest sample over the
  6-step schedule and over the last 20 steps of the 1000-step one (each
  step feeds the last, so the forward's error compounds); its float32
  schedule table equal to JAX's bit for bit;
- the draws by their statistics: ``diffuse``'s scales inside their bounds,
  its noise of mean 0 and variance 1 within 5 standard errors; one step's
  ``s`` in [1, 999] and shared by the batch; the init orthogonal within
  1e-5 and its biases 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.models import wavegrad as jwg
from mindaudio_tpu.train.state import clip_by_global_norm as jclip
from mindaudio_torch.convert import convert_params
from mindaudio_torch.models import wavegrad as twg
from mindaudio_torch.recipes.wavegrad import train as ttrain
from mindaudio_torch.train.state import make_train_step

torch.set_num_threads(1)

TOY = dict(up_factors=(5, 5, 3, 2, 2), down_factors=(2, 2, 3, 5),
           down_channels=(8, 8, 16, 32), film_channels=(8, 8, 16, 32, 32),
           up_channels=(32, 32, 16, 8, 8))
FRAMES, HOP, N_MELS = 4, 300, 80


def _close(got, want, atol_of_peak=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_of_peak * np.abs(want).max())


def _draw(tree, rng, gain=1.0):
    """Parameters drawn with numpy for a ``jax.eval_shape`` tree: kernels
    with std ``gain / sqrt(fan in)``, biases 0.1 N(0, 1)."""
    def leaf(path, a):
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (gain * rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _init(module, *inputs, seed=1, gain=1.0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    return _draw(shapes["params"], np.random.default_rng(seed), gain)


def _port(module, params):
    module.load_state_dict(convert_params(params), strict=True)
    return module.eval()


def _cf(x):
    """``(B, T, C)`` numpy → the port's channels-first ``(B, C, T)`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    mel = rng.uniform(0, 1, (b, FRAMES, N_MELS)).astype(np.float32)
    audio = (0.5 * rng.standard_normal((b, FRAMES * HOP))).astype(np.float32)
    scale = rng.uniform(0.1, 0.99, b).astype(np.float32)
    return mel, audio, scale


# ------------------------------------------------------------ the modules


def test_positional_encoding():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 50, 32)).astype(np.float32)
    level = np.array([0.01, 0.5, 0.999], np.float32)
    want = jwg.PositionalEncoding(32).apply({}, jnp.asarray(x), jnp.asarray(level))
    got = twg.PositionalEncoding(32)(_cf(x), torch.from_numpy(level))
    _close(got.numpy().transpose(0, 2, 1), want)


def test_film():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 60, 8)).astype(np.float32)
    level = np.array([0.3, 0.8], np.float32)
    jm = jwg.FiLM(16)
    params = _init(jm, x, level)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(level))
    got = _port(twg.FiLM(8, 16), params)(_cf(x), torch.from_numpy(level))
    for g, w in zip(got, want):
        _close(g.detach().numpy().transpose(0, 2, 1), w)


@pytest.mark.parametrize("factor", [2, 3, 5])
def test_dblock(factor):
    x = np.random.default_rng(factor).standard_normal((2, 150, 8)).astype(np.float32)
    jm = jwg.DBlock(16, factor)
    params = _init(jm, x)
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = _port(twg.DBlock(8, 16, factor), params)(_cf(x))
    assert got.shape == (2, 16, 150 // factor)
    _close(got.detach().numpy().transpose(0, 2, 1), want)


@pytest.mark.parametrize("factor", [2, 3, 5])
def test_ublock(factor):
    rng = np.random.default_rng(10 + factor)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    shift = rng.standard_normal((2, 12 * factor, 8)).astype(np.float32)
    scale = rng.standard_normal((2, 12 * factor, 8)).astype(np.float32)
    jm = jwg.UBlock(8, factor)
    params = _init(jm, x, shift, scale)
    want = jm.apply({"params": params}, *map(jnp.asarray, (x, shift, scale)))
    got = _port(twg.UBlock(16, 8, factor), params)(_cf(x), _cf(shift), _cf(scale))
    _close(got.detach().numpy().transpose(0, 2, 1), want)


def _toy_pair(seed=1, gain=1.0):
    jm = jwg.WaveGrad(**TOY)
    params = _init(jm, *_inputs(), seed=seed, gain=gain)
    tm = _port(twg.WaveGrad(n_mels=N_MELS, device="cpu", **TOY), params)
    return jm, params, tm


def test_wavegrad_forward():
    jm, params, tm = _toy_pair()
    mel, audio, scale = _inputs(3)
    want = jax.jit(jm.apply)({"params": params}, *map(jnp.asarray, (mel, audio, scale)))
    got = tm(*map(torch.from_numpy, (mel, audio, scale)))
    assert got.shape == (2, FRAMES * HOP)
    _close(got.detach().numpy(), want)


def test_convert_full_width_tree():
    """The JAX model at its defaults converts with no new rule into the
    port's, 17,233,217 parameters in 118 tensors."""
    mel = jnp.zeros((1, 30, 128))
    shapes = jax.eval_shape(jwg.WaveGrad().init, jax.random.PRNGKey(0), mel,
                            jnp.zeros((1, 9000)), jnp.ones((1,)))["params"]
    state = convert_params(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                                  shapes))
    model = twg.WaveGrad(device="cpu")
    model.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in model.parameters()) == 17_233_217
    assert len(state) == 118
    # WaveGradWithLoss scopes the model as "model", as the JAX tree does
    net = twg.WaveGradWithLoss(model)
    assert all(k.startswith("model.") for k in net.state_dict())


# ---------------------------------------------------- the loss and a step


def _loss_inputs(seed=4):
    rng = np.random.default_rng(seed)
    mel, audio, scale = _inputs(seed)
    noise = rng.standard_normal(audio.shape).astype(np.float32)
    noisy = (scale[:, None] * audio + np.sqrt(1 - scale[:, None] ** 2) * noise).astype(np.float32)
    return {"mel": mel, "noisy": noisy, "scale": scale, "noise": noise}


def test_loss_and_gradients():
    jm, params, tm = _toy_pair()
    b = _loss_inputs()
    jnet = jwg.WaveGradWithLoss(model=jm)

    def jloss(p, *inputs):
        return jnet.apply({"params": {"model": p}}, *inputs)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params, *(jnp.asarray(b[k]) for k in (
        "mel", "noisy", "scale", "noise")))
    tnet = twg.WaveGradWithLoss(tm)
    got = tnet(*(torch.from_numpy(b[k]) for k in ("mel", "noisy", "scale", "noise")))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-4)
    want_grads = convert_params(jgrads)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want_grads[name], 1e-4)


def test_two_adam_steps_under_the_warmup():
    """The recipe's optimizer (``optax.adam(linear_schedule(0, lr, 3))``)
    and clipping at 1.0 over two steps on fixed diffusion draws: the first
    update has a learning rate of 0 and moves nothing, the second matches
    optax's."""
    jm, params, tm = _toy_pair()
    cfg = ttrain.parse_args(["--device", "cpu", "--optim.lr", "0.01",
                             "--optim.warmup_steps", "3"])[0]
    batches = [_loss_inputs(5), _loss_inputs(6)]
    jnet = jwg.WaveGradWithLoss(model=jm)
    tx = optax.adam(optax.linear_schedule(0.0, 0.01, 3))
    jparams = {"model": params}
    opt_state = tx.init(jparams)
    history = []

    @jax.jit
    def jstep(p, opt_state, *inputs):
        grads = jax.grad(lambda p: jnet.apply({"params": p}, *inputs))(p)
        grads, _ = jclip(grads, 1.0)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    for b in batches:
        jparams, opt_state = jstep(jparams, opt_state, *(jnp.asarray(b[k]) for k in (
            "mel", "noisy", "scale", "noise")))
        history.append({k: v.numpy() for k, v in convert_params(jparams).items()})

    net = twg.WaveGradWithLoss(tm).train()
    optimizer = ttrain.make_optimizer(cfg, net)
    step = make_train_step(net, optimizer, grad_clip_norm=1.0, loss_fn=lambda n, b: (n(
        b["mel"], b["noisy"], b["scale"], b["noise"]), {}))
    init = {n: p.detach().clone() for n, p in net.named_parameters()}
    for i, b in enumerate(batches):
        step({k: torch.from_numpy(v) for k, v in b.items()})
        got = {n: p.detach() for n, p in net.named_parameters()}
        if i == 0:
            for n in got:
                assert torch.equal(got[n], init[n]), n
                np.testing.assert_array_equal(history[0][n], init[n].numpy())
        else:
            worst = 0.0
            for n in got:
                update = history[1][n] - init[n].numpy()
                assert np.abs(update).max() > 0, n
                err = np.abs(got[n].numpy() - init[n].numpy() - update).max()
                worst = max(worst, err / np.abs(update).max())
            assert worst < 1e-3, worst
    assert int(optimizer.count) == 2


# ------------------------------------------------------------ the sampler


def _jax_draws(key, shape, steps):
    """The S + 1 normal draws of the JAX sampler, in its order: the start
    from ``key``, then ``key, k = split(key)`` and ``normal(k)`` a step."""
    draws = [jax.random.normal(key, shape)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    return np.stack([np.asarray(d) for d in draws])


@pytest.mark.parametrize("schedule", ["fast6", "last20"])
def test_sampler_on_jax_draws(schedule):
    # the weights scaled down, so that 20 steps of an untrained net do not
    # run away
    jm, params, tm = _toy_pair(gain=0.5)
    betas = (twg.fast_noise_schedule() if schedule == "fast6"
             else twg.default_noise_schedule()[:20])  # steps idx = 19 ... 0 of the 1000
    mel = _inputs(7)[0]
    key = jax.random.PRNGKey(3)

    def apply_fn(p, m, a, s):
        return jm.apply({"params": p}, m, a, s)

    want = np.asarray(jwg.reverse_diffusion(params, apply_fn, jnp.asarray(mel), key,
                                            betas=betas, hop=HOP))
    draws = _jax_draws(key, (2, FRAMES * HOP), len(betas))
    got = twg.reverse_diffusion(tm, torch.from_numpy(mel), betas=betas, hop=HOP,
                                noise=torch.from_numpy(draws)).numpy()
    assert (np.abs(want) < 1.0).mean() > 0.3  # most of it not saturated by the clip
    _close(got, want, 1e-4)


def test_sampler_schedule_table_equals_jax(monkeypatch):
    tables = []
    scan = jax.lax.scan

    def spy(f, init, xs, *a, **k):
        tables.append(np.asarray(xs))
        return scan(f, init, xs, *a, **k)

    monkeypatch.setattr(jax.lax, "scan", spy)
    mel = jnp.zeros((1, 1, 4))
    for betas in (twg.default_noise_schedule(), twg.fast_noise_schedule()):
        jwg.reverse_diffusion({}, lambda p, m, a, s: a, mel, jax.random.PRNGKey(0),
                              betas=betas, hop=2)
        mine = twg.sampler_schedule(betas)
        assert mine.dtype == np.float32 and mine.shape == (len(betas), 4)
        np.testing.assert_array_equal(mine, tables[-1])


def test_sampler_draws_from_its_generator():
    _, _, tm = _toy_pair(gain=0.5)
    mel = torch.from_numpy(_inputs(8)[0])
    runs = [twg.reverse_diffusion(tm, mel, torch.Generator().manual_seed(s),
                                  betas=twg.fast_noise_schedule()) for s in (0, 0, 1)]
    assert runs[0].shape == (2, FRAMES * HOP) and torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="Generator"):
        twg.reverse_diffusion(tm, mel, None, betas=twg.fast_noise_schedule())


# ------------------------------------------------------------ statistics


def test_diffuse_statistics():
    audio = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (64, 20000))
                             .astype(np.float32))
    noisy, noise, scale = twg.diffuse(torch.Generator().manual_seed(0), audio, (0.3, 0.6))
    assert noisy.shape == noise.shape == audio.shape and scale.shape == (64,)
    assert ((scale >= 0.3) & (scale <= 0.6)).all() and scale.std() > 0.05
    n = noise.numel()
    assert abs(float(noise.mean())) < 5 / np.sqrt(n)
    assert abs(float(noise.var()) - 1.0) < 5 * np.sqrt(2.0 / n)
    torch.testing.assert_close(
        noisy, scale[:, None] * audio + torch.sqrt(1 - scale[:, None] ** 2) * noise)


def test_one_step_draw_shares_its_noise_level():
    cfg = ttrain.parse_args(["--device", "cpu"])[0]
    levels = ttrain.schedule_levels(cfg, "cpu")
    np.testing.assert_array_equal(
        levels.numpy(), np.sqrt(np.cumprod(1.0 - np.linspace(1e-6, 0.01, 1000))).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    audio = torch.zeros(16, 300)
    seen = []
    for _ in range(200):
        _, _, scale, s = ttrain.draw_step(gen, audio, levels)
        s = int(s)
        assert 1 <= s <= 999
        # one s for the batch: every scale lies between its two levels
        assert ((scale >= levels[s]) & (scale <= levels[s - 1])).all()
        seen.append(s)
    assert min(seen) < 100 and max(seen) > 900


def test_init_is_orthogonal_with_zero_biases():
    model = twg.WaveGrad(n_mels=N_MELS, device="cpu", **TOY)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(1.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv1d)]
    assert len(convs) == 59
    for conv in convs:
        w = conv.weight.reshape(conv.weight.shape[0], -1).double()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        torch.testing.assert_close(gram, torch.eye(len(gram), dtype=torch.float64),
                                   rtol=0, atol=1e-5)
        assert torch.equal(conv.bias, torch.zeros_like(conv.bias))

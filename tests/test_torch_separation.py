"""Port parity for the separation modules (``mindaudio_torch.ops.spectral
.overlap_and_add``, ``loss.separation_loss``, ``models.conv_tasnet``,
``models.tasnet`` and ``convert.convert_params`` on their flax trees)
against the JAX package on the same numpy inputs, on the CPU at a toy size
(Conv-TasNet N 32, L 16, bottleneck 8, hidden 16, X 3, R 2; TasNet N 32,
L 40, hidden 32, 2 layers).

Tolerances, all float32 on both sides:
- ``overlap_and_add``: 1e-6 (a sum of at most three frames);
- SI-SNR values, the PIT loss and its gradient: 1e-5 relative, with a floor
  of 1e-5 of the largest gradient element (a log of sums over 400 samples
  taken in another order); the permutations equal;
- the layer norms, the depthwise-separable conv, the temporal block and
  both models' outputs: 1e-5 of the largest output (sums of a few hundred
  products, and the norms' statistics, in another order);
- ``frame_waveform``: exact (a gather).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.loss import separation_loss as jloss
from mindaudio_tpu.models import conv_tasnet as jct
from mindaudio_tpu.models import tasnet as jtas
from mindaudio_tpu.ops import spectral as jspectral
from mindaudio_torch import loss as tloss_pkg
from mindaudio_torch.convert import convert_params
from mindaudio_torch.loss import separation_loss as tloss
from mindaudio_torch.models import conv_tasnet as tct
from mindaudio_torch.models import tasnet as ttas
from mindaudio_torch.ops import spectral as tspectral

torch.set_num_threads(1)

TOY_CT = dict(enc_dim=32, win_len=16, bottleneck=8, hidden=16, num_blocks=3, num_repeats=2)
TOY_TAS = dict(enc_dim=32, frame_len=40, hidden=32, num_layers=2)


def _close(got, want, atol_of_peak=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_of_peak * np.abs(want).max())


def _draw(tree, rng):
    """Parameters drawn with numpy for a ``jax.eval_shape`` tree: kernels
    with std 1/sqrt(fan in), biases and norm shifts 0.1 N(0, 1), scales 1 +
    0.1 N(0, 1), PReLU slopes U(0, 0.3)."""
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


def _init(module, *inputs, seed=1):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    return _draw(shapes["params"], np.random.default_rng(seed))


def _port(module, params):
    module.load_state_dict(convert_params(params), strict=True)
    return module.eval()


def _cf(x):
    """``(B, K, C)`` numpy → the port's channels-first ``(B, C, K)`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


# ----------------------------------------------------------- overlap-add


@pytest.mark.parametrize("frame_length,frame_step", [(16, 8), (40, 20), (6, 4), (5, 5)])
def test_overlap_and_add(frame_length, frame_step):
    x = np.random.default_rng(0).standard_normal((3, 2, 37, frame_length)).astype(np.float32)
    want = jspectral.overlap_and_add(jnp.asarray(x), frame_step)
    got = tspectral.overlap_and_add(torch.from_numpy(x), frame_step)
    assert got.shape == want.shape == (3, 2, frame_step * 36 + frame_length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_overlap_and_add_gradient_is_framing():
    """The adjoint of overlap-add is framing: each frame's gradient is the
    output gradient over the samples it covered."""
    x = torch.zeros(2, 9, 6, requires_grad=True)
    g = torch.randn(2, 4 * 8 + 6)
    tspectral.overlap_and_add(x, 4).backward(g)
    torch.testing.assert_close(x.grad, g.unfold(-1, 6, 4), rtol=0, atol=0)


# ---------------------------------------------------------------- the loss


@pytest.mark.parametrize("c,with_lengths", list(itertools.product((2, 3), (False, True))))
def test_si_snr_and_pit_loss(c, with_lengths):
    rng = np.random.default_rng(c)
    target = rng.standard_normal((4, c, 400)).astype(np.float32)
    # estimates near a permutation of the targets, so the best one is clear
    perm = np.stack([rng.permutation(c) for _ in range(4)])
    est = (np.take_along_axis(target, perm[:, :, None], axis=1)
           + 0.5 * rng.standard_normal(target.shape)).astype(np.float32)
    lengths = np.array([400, 251, 37, 1], np.int32) if with_lengths else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)

    snr_want = jloss.cal_si_snr_jax(jnp.asarray(est), jnp.asarray(target), jl)
    snr_got = tloss.cal_si_snr(torch.from_numpy(est), torch.from_numpy(target), tl)
    np.testing.assert_allclose(snr_got.numpy(), np.asarray(snr_want), rtol=1e-5)

    (want, want_perm), want_grad = jax.jit(jax.value_and_grad(
        lambda e: jloss.pit_si_snr_loss(e, jnp.asarray(target), jl), has_aux=True))(
            jnp.asarray(est))
    x = torch.from_numpy(est).requires_grad_()
    got, got_perm = tloss.pit_si_snr_loss(x, torch.from_numpy(target), tl)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close(x.grad, want_grad)
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    # the best pairing undoes the permutation the estimates were made with,
    # on every row but one of a single sample (zero-mean, so all pairings tie)
    rows = slice(None) if lengths is None else lengths > 1
    np.testing.assert_array_equal(got_perm.numpy()[rows], perm[rows])


def test_reference_name_aliases():
    assert tloss_pkg.Separation_Loss is tloss.pit_si_snr_loss
    assert tloss_pkg.Convtasnet_Loss is tloss.pit_si_snr_loss


# ------------------------------------------------------------- Conv-TasNet


@pytest.mark.parametrize("norm", ["cLN", "gLN"])
def test_layer_norms(norm):
    x = (np.random.default_rng(2).standard_normal((2, 50, 12)) * 3 + 1).astype(np.float32)
    jmod = jct.ChannelwiseLayerNorm() if norm == "cLN" else jct.GlobalLayerNorm()
    params = _init(jmod, x)
    tmod = _port(tct.ChannelwiseLayerNorm(12) if norm == "cLN" else tct.GlobalLayerNorm(12),
                 params)
    _close(tmod(_cf(x)).detach().numpy().transpose(0, 2, 1), jmod.apply({"params": params},
                                                                         jnp.asarray(x)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dilation", [1, 4])
def test_depthwise_separable_conv(causal, dilation):
    x = np.random.default_rng(3).standard_normal((2, 40, 16)).astype(np.float32)
    jmod = jct.DepthwiseSeparableConv(8, 3, dilation, "gLN", causal)
    params = _init(jmod, x)
    tmod = _port(tct.DepthwiseSeparableConv(16, 8, 3, dilation, "gLN", causal), params)
    _close(tmod(_cf(x)).detach().numpy().transpose(0, 2, 1), jmod.apply({"params": params},
                                                                         jnp.asarray(x)))


def test_depthwise_conv_of_even_kernel_pads_unevenly():
    """P = 4, d = 1: three frames of padding, one left and two right."""
    x = np.random.default_rng(4).standard_normal((1, 20, 6)).astype(np.float32)
    jmod = jct.DepthwiseSeparableConv(5, 4, 1, "cLN", False)
    params = _init(jmod, x)
    tmod = _port(tct.DepthwiseSeparableConv(6, 5, 4, 1, "cLN", False), params)
    assert tmod.pad == (1, 2)
    _close(tmod(_cf(x)).detach().numpy().transpose(0, 2, 1), jmod.apply({"params": params},
                                                                         jnp.asarray(x)))


@pytest.mark.parametrize("causal", [False, True])
def test_temporal_block(causal):
    x = np.random.default_rng(5).standard_normal((2, 60, 8)).astype(np.float32)
    jmod = jct.TemporalBlock(8, 16, 3, dilation=2, causal=causal)
    params = _init(jmod, x)
    tmod = _port(tct.TemporalBlock(8, 16, 3, 2, causal=causal), params)
    _close(tmod(_cf(x)).detach().numpy().transpose(0, 2, 1), jmod.apply({"params": params},
                                                                         jnp.asarray(x)))


@pytest.mark.parametrize("kw", [dict(), dict(mask_nonlinear="softmax"),
                                dict(causal=True, norm_type="cLN")],
                         ids=["relu_gLN", "softmax_gLN", "causal_cLN"])
@pytest.mark.parametrize("t", [203, 8, 16])
def test_conv_tasnet(kw, t):
    """``t`` = 203 is no multiple of the hop (the tail frame is padded); 8
    and 16 are shorter than and equal to one frame."""
    mix = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    jmod = jct.ConvTasNet(**TOY_CT, **kw)
    params = _init(jmod, mix)
    tmod = _port(tct.ConvTasNet(**TOY_CT, **kw, device="cpu"), params)
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(mix))
    got = tmod(torch.from_numpy(mix))
    assert got.shape == want.shape == (2, 2, t)
    _close(got.detach().numpy(), want)
    assert tct.num_frames(t, 16) == max(-(-(t - 16) // 8) + 1, 1)


def test_conv_tasnet_full_width_parameters():
    """Every leaf of the full-width flax tree (3,445,808 parameters, the
    PReLU slopes included) lands on one port parameter of the same size."""
    shapes = jax.eval_shape(jct.ConvTasNet().init, jax.random.PRNGKey(0), jnp.zeros((1, 400)))
    state = convert_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes["params"]))
    model = tct.ConvTasNet(device="cpu")
    assert sum(t.numel() for t in state.values()) == 3_445_808
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(isinstance(m, tct.PReLU) for m in model.modules()) == 48


def test_conv_tasnet_init_follows_flax():
    model = tct.ConvTasNet(**TOY_CT, device="cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    blk = model.tcn_r1_x2
    assert blk.prelu.weight.item() == pytest.approx(0.01)
    assert torch.equal(blk.norm.gamma, torch.ones(16)) and torch.equal(blk.norm.beta,
                                                                      torch.zeros(16))
    # lecun-normal, truncated: std 1/sqrt(fan in) within sampling error
    w = tct.ConvTasNet(device="cpu").reset_parameters(
        torch.Generator().manual_seed(0)).mask_conv1x1.weight
    assert w.std().item() == pytest.approx(1 / np.sqrt(128), rel=0.02)


# ------------------------------------------------------------------ TasNet


@pytest.fixture(scope="module")
def tasnet_pair():
    jmod = jtas.TasNet(**TOY_TAS)
    frames = jmod.frame_waveform(jnp.zeros((1, 400)))
    params = _init(jmod, frames, seed=6)
    return jmod, params, _port(ttas.TasNet(**TOY_TAS, device="cpu"), params)


@pytest.mark.parametrize("t", [403, 40, 25])
def test_tasnet_frame_waveform(tasnet_pair, t):
    jmod, _, tmod = tasnet_pair
    audio = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    want = np.asarray(jmod.frame_waveform(jnp.asarray(audio)))
    got = tmod.frame_waveform(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_tasnet_forward_and_separate_full(tasnet_pair):
    from mindaudio_torch.recipes.tasnet.train import separate_full

    jmod, params, tmod = tasnet_pair
    audio = np.random.default_rng(7).standard_normal((2, 403)).astype(np.float32)
    frames = jmod.frame_waveform(jnp.asarray(audio))
    want = jax.jit(jmod.apply)({"params": params}, frames)
    got = tmod(torch.from_numpy(np.array(frames)))
    assert got.shape == want.shape == (2, 2, 20, 40)
    _close(got.detach().numpy(), want)

    want_full = jmod.reconstruct(want)[..., :403]
    got_full = separate_full(tmod, torch.from_numpy(audio))
    assert got_full.shape == (2, 2, 403)
    _close(got_full.detach().numpy(), want_full)


def test_tasnet_layer_norm_is_flax():
    """eps 1e-6 and the variance as E[x^2] - E[x]^2, on non-negative rows
    as the gated encoder gives them."""
    import flax.linen as fnn

    x = (2.0 * np.random.default_rng(8).random((3, 64))).astype(np.float32)
    x[0] *= 1e-3  # a row whose variance is near eps
    jmod = fnn.LayerNorm()
    params = _init(jmod, x)
    tmod = ttas.LayerNorm(64)
    assert tmod.eps == 1e-6
    tmod.load_state_dict({"weight": torch.from_numpy(np.asarray(params["scale"])),
                          "bias": torch.from_numpy(np.asarray(params["bias"]))})
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    _close(tmod(torch.from_numpy(x)).detach().numpy(), want)


def test_tasnet_cells_become_bidirectional_layers(tasnet_pair):
    """flax cell ``2i`` is layer ``i``'s forward direction, ``2i + 1`` its
    backward one: the converted tensors are the cells' gates stacked i, f,
    g, o, and the outputs above agree only in this order (swapping the two
    cells of a layer changes them)."""
    jmod, params, tmod = tasnet_pair
    state = convert_params(params)
    h = TOY_TAS["hidden"]
    for n in range(4):
        layer, d = divmod(n, 2)
        cell = params[f"OptimizedLSTMCell_{n}"]
        for g, gate in enumerate("ifgo"):
            rows = slice(g * h, (g + 1) * h)
            np.testing.assert_array_equal(state[f"lstm_{layer}.weight_ih"][d, rows].numpy(),
                                          np.asarray(cell[f"i{gate}"]["kernel"]).T)
            np.testing.assert_array_equal(state[f"lstm_{layer}.weight_hh"][d, rows].numpy(),
                                          np.asarray(cell[f"h{gate}"]["kernel"]).T)
            np.testing.assert_array_equal(state[f"lstm_{layer}.bias"][d, rows].numpy(),
                                          np.asarray(cell[f"h{gate}"]["bias"]))
    swapped = dict(params, OptimizedLSTMCell_0=params["OptimizedLSTMCell_1"],
                   OptimizedLSTMCell_1=params["OptimizedLSTMCell_0"])
    frames = jmod.frame_waveform(jnp.asarray(
        np.random.default_rng(9).standard_normal((1, 403)).astype(np.float32)))
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, frames))
    other = _port(ttas.TasNet(**TOY_TAS, device="cpu"), swapped)
    assert np.abs(other(torch.from_numpy(np.array(frames))).detach().numpy()
                  - want).max() > 1e-3


def test_tasnet_conversion_refuses_incomplete_cells(tasnet_pair):
    _, params, _ = tasnet_pair
    cell = dict(params["OptimizedLSTMCell_3"])
    del cell["hf"]
    with pytest.raises(ValueError, match="OptimizedLSTMCell_3"):
        convert_params(dict(params, OptimizedLSTMCell_3=cell))
    one_way = {k: v for k, v in params.items() if k != "OptimizedLSTMCell_3"}
    with pytest.raises(ValueError, match="directions"):
        convert_params(one_way)


def test_tasnet_full_width_parameters():
    """The full-width flax tree (16,578,000 parameters, cells 0-7) fills
    the port's TasNet exactly."""
    jmod = jtas.TasNet()
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 5, 40)))
    assert sorted(k for k in shapes["params"] if k.startswith("OptimizedLSTMCell")) == [
        f"OptimizedLSTMCell_{n}" for n in range(8)]
    state = convert_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes["params"]))
    model = ttas.TasNet(device="cpu")
    assert sum(t.numel() for t in state.values()) == 16_578_000
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}

"""Port parity for DeepSpeech2's modules (``mindaudio_torch.models.deepspeech2``,
``models.layers.BatchNorm``, ``models.greedy_decoder``, the STFT front end of
``ops.spectral`` and ``convert.convert_params`` with ``batch_stats``) against
the JAX package on the same numpy inputs, on the CPU at a toy size (hidden
32, 2 layers, 33 frequency bins, T <= 60).

Tolerances, all float32 on both sides:
- the spectrogram and ``_power_frames``: 1e-5 relative (a DFT of 320 terms
  summed in another order), with an absolute floor of 1e-5 of the largest
  magnitude for bins near zero;
- ``flip_valid``: exact (an index map);
- ``BiLSTM``: 1e-5, padded positions included;
- ``MaskConv`` and ``DeepSpeechModel`` in eval: 1e-4 on the logits (two
  convs and two LSTM layers of float32 sums in another order), lengths exact;
- one training-mode forward: logits 1e-4 and the new running statistics
  1e-5 relative;
- batch norm alone: 1e-6 relative;
- the bf16 compute dtype against the JAX model built with
  ``dtype=jnp.bfloat16``: a BiLSTM within 2e-2 of its peak output and the
  model's logits within 3e-2 of their peak (a few bf16 steps of 2^-8: the
  two sides round the same products but sum and take ``tanh`` in another
  order, and in training the batch statistics come from bf16 values),
  running statistics 1e-3 relative; a BiLSTM whose cell state grows by less
  than a bf16 step each frame within one bf16 step (2^-8) of JAX, which
  keeps that state in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.models import deepspeech2 as jds2
from mindaudio_tpu.models import greedy_decoder as jgreedy
from mindaudio_tpu.ops import spectral as jspectral
from mindaudio_torch.convert import convert_params
from mindaudio_torch.models import deepspeech2 as tds2
from mindaudio_torch.models import greedy_decoder as tgreedy
from mindaudio_torch.models.layers import BatchNorm, running_stats
from mindaudio_torch.ops import spectral as tspectral

torch.set_num_threads(1)

B, T, F_BINS, H, V = 3, 60, 33, 32, 29
LENS = np.array([60, 43, 17], np.int32)


def _close(got, want, rtol, atol_of_peak=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_of_peak * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _draw(tree, rng):
    """Parameters drawn with numpy for a ``jax.eval_shape`` tree: weights
    with std 1/sqrt(fan in), biases and batch-norm shifts 0.1, scales 1 +
    0.1 N(0, 1)."""
    def leaf(path, a):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "bias" or len(a.shape) == 1:
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) if name == "kernel" else a.shape[-2]
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _stats(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def spect():
    return np.random.default_rng(0).standard_normal((B, T, F_BINS)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model_vars(spect):
    model = jds2.DeepSpeechModel(vocab_size=V, hidden_size=H, num_rnn_layers=2)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(spect),
                            jnp.asarray(LENS))
    rng = np.random.default_rng(1)
    return model, _draw(shapes["params"], rng), _stats(shapes["batch_stats"], rng)


def _port_model(params, batch_stats):
    model = tds2.DeepSpeechModel(vocab_size=V, hidden_size=H, num_rnn_layers=2,
                                 n_freq=F_BINS, device="cpu")
    model.load_state_dict(convert_params(params, batch_stats), strict=True)
    return model


# ---------------------------------------------------------------- front end


@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_power_frames(power):
    wav = np.random.default_rng(2).standard_normal((2, 4000)).astype(np.float32)
    want = jspectral._power_frames(jnp.asarray(wav), 320, 320, 160, "hann", True, "constant",
                                   power, None)
    got = tspectral._power_frames(torch.from_numpy(wav), 320, 320, 160, "hann", True,
                                  "constant", power)
    assert got.shape == want.shape == (2, 26, 161)
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_fft=320, hop_length=160, power=1.0, pad_mode="constant"),
    dict(n_fft=512, win_length=400, hop_length=100, window="hamming", normalized=True, pad=7),
    dict(n_fft=256, hop_length=64, center=False),
], ids=["defaults", "deepspeech2", "window_in_fft_normalized_padded", "uncentred"])
def test_spectrogram(kw):
    wav = np.random.default_rng(3).standard_normal((2, 3001)).astype(np.float32)
    want = jspectral.spectrogram(jnp.asarray(wav), **kw)
    got = tspectral.spectrogram(wav, device="cpu", **kw)
    assert got.shape == want.shape
    _close(got, want, 1e-5, 1e-5)


def test_stft_and_dft_matrices():
    wav = np.random.default_rng(4).standard_normal(2500).astype(np.float32)
    want = jspectral.stft(jnp.asarray(wav), n_fft=400, hop_length=120, window="hann")
    got = tspectral.stft(wav, n_fft=400, hop_length=120, device="cpu")
    assert got.shape == want.shape
    _close(got, want, 1e-5, 1e-5)
    for args in ((320, 320, "hann", 160), (400, 300, "hamming", 160)):
        for mine, theirs in zip(tspectral.dft_matrices(*args), jspectral.dft_matrices(*args)):
            np.testing.assert_array_equal(mine, theirs)


# ---------------------------------------------------------------- layers


def test_flip_valid_is_the_jax_index_map():
    x = np.random.default_rng(5).standard_normal((3, 11, 4)).astype(np.float32)
    lens = np.array([11, 6, 0], np.int32)
    for lengths in (lens, None):
        want = jds2.flip_valid(jnp.asarray(x), None if lengths is None else jnp.asarray(lengths))
        got = tds2.flip_valid(torch.from_numpy(x),
                              None if lengths is None else torch.from_numpy(lengths))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    twice = tds2.flip_valid(tds2.flip_valid(torch.from_numpy(x), torch.from_numpy(lens)),
                            torch.from_numpy(lens))
    np.testing.assert_array_equal(twice.numpy(), x)


@pytest.mark.parametrize("with_lengths", [True, False])
def test_bilstm(with_lengths):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 23, 12)).astype(np.float32)
    lens = np.array([23, 14, 1], np.int32) if with_lengths else None
    jmod = jds2.BiLSTM(16)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = _draw(shapes["params"], rng)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      lengths=None if lens is None else jnp.asarray(lens))
    tmod = tds2.BiLSTM(12, 16)
    tmod.load_state_dict(convert_params(params), strict=True)
    got = tmod(torch.from_numpy(x), None if lens is None else torch.from_numpy(lens))
    assert got.shape == want.shape == (B, 23, 16)
    _close(got.detach(), want, 1e-5, 1e-5)  # padded positions included
    if with_lengths:  # the padding carries state: its outputs are not zero
        assert np.abs(np.asarray(want)[2, 1:]).min() > 0


@pytest.mark.parametrize("shape", [(4, 9, 5), (6, 7)])
def test_batch_norm_as_flax(shape):
    import flax.linen as nn

    rng = np.random.default_rng(7)
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    feats = shape[-1]
    params = {"scale": (1 + 0.1 * rng.standard_normal(feats)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(feats)).astype(np.float32)}
    stats = {"mean": rng.standard_normal(feats).astype(np.float32),
             "var": (0.5 + rng.random(feats)).astype(np.float32)}
    want, mutated = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              mutable=["batch_stats"])
    bn = BatchNorm(feats)
    bn.load_state_dict(convert_params(params, stats))
    got = bn.train()(torch.from_numpy(x))
    _close(got.detach(), want, 1e-6, 1e-6)
    _close(bn.running_mean, mutated["batch_stats"]["mean"], 1e-6, 1e-7)
    _close(bn.running_var, mutated["batch_stats"]["var"], 1e-6, 1e-7)
    # the biased batch variance, not torch's unbiased one
    biased = x.reshape(-1, feats).var(0)
    _close(bn.running_var, 0.9 * stats["var"] + 0.1 * biased, 1e-5)
    want_eval = nn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": mutated["batch_stats"]}, jnp.asarray(x))
    _close(bn.eval()(torch.from_numpy(x)).detach(), want_eval, 1e-6, 1e-6)
    assert [t.data_ptr() for t in running_stats(bn)] == [bn.running_mean.data_ptr(),
                                                         bn.running_var.data_ptr()]
    assert "num_batches_tracked" not in bn.state_dict()


# ---------------------------------------------------------------- the model


def test_convert_params_with_batch_stats(jax_model_vars):
    _, params, stats = jax_model_vars
    state = convert_params(params, stats)
    model = tds2.DeepSpeechModel(vocab_size=V, hidden_size=H, num_rnn_layers=2, n_freq=F_BINS,
                                 device="cpu")
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name
    kernel = np.asarray(params["conv"]["conv1"]["kernel"])  # HWIO
    np.testing.assert_array_equal(state["conv.conv1.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["rnn_1.bilstm.weight_ih"].numpy(),
                                  np.asarray(params["rnn_1"]["bilstm"]["wx"]).transpose(0, 2, 1))
    np.testing.assert_array_equal(state["rnn_1.bn.running_var"].numpy(),
                                  np.asarray(stats["rnn_1"]["bn"]["var"]))
    assert sum(1 for k in state if k.endswith("running_mean")) == 4  # bn1, bn2, rnn_1, head


def test_mask_conv_eval(jax_model_vars, spect):
    _, params, stats = jax_model_vars
    jmod = jds2.MaskConv()
    want, want_lens = jmod.apply({"params": params["conv"], "batch_stats": stats["conv"]},
                                 jnp.asarray(spect)[..., None], jnp.asarray(LENS))
    model = _port_model(params, stats).eval()
    got, got_lens = model.conv(torch.from_numpy(spect), torch.from_numpy(LENS).long())
    assert got.shape == want.shape == (B, 30, 9, 32)
    _close(got.detach(), want, 1e-4, 1e-5)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


def test_model_eval(jax_model_vars, spect):
    jmodel, params, stats = jax_model_vars
    want, want_lens = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(spect),
                                   jnp.asarray(LENS), deterministic=True)
    got, got_lens = _port_model(params, stats).eval()(torch.from_numpy(spect),
                                                      torch.from_numpy(LENS).long())
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, 30, V)
    _close(got.detach(), want, 1e-4, 1e-5)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


def test_model_train_forward_and_batch_stats(jax_model_vars, spect):
    jmodel, params, stats = jax_model_vars
    (want, _), mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(spect), jnp.asarray(LENS),
                                      deterministic=False, mutable=["batch_stats"])
    model = _port_model(params, stats).train()
    got, _ = model(torch.from_numpy(spect), torch.from_numpy(LENS).long())
    _close(got.detach(), want, 1e-4, 1e-5)
    want_state = convert_params(params, mutated["batch_stats"])
    moved = 0.0
    for name, t in model.state_dict().items():
        if "running" in name:
            _close(t, want_state[name], 1e-5, 1e-6)
            moved = max(moved, (t - convert_params(params, stats)[name]).abs().max().item())
    assert moved > 1e-3  # the statistics did move


def test_model_bf16_compute_stays_near_float32(jax_model_vars, spect):
    _, params, stats = jax_model_vars
    f32 = _port_model(params, stats).eval()
    bf16 = tds2.DeepSpeechModel(vocab_size=V, hidden_size=H, num_rnn_layers=2, n_freq=F_BINS,
                                dtype=torch.bfloat16, device="cpu")
    bf16.load_state_dict(f32.state_dict())
    bf16.eval()
    args = (torch.from_numpy(spect), torch.from_numpy(LENS).long())
    want, got = f32(*args)[0].detach(), bf16(*args)[0].detach()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # bf16 keeps 8 bits: a few percent of the logits' spread after 2 layers
    assert (got - want).abs().max().item() <= 0.05 * want.abs().max().item()


def test_bilstm_bf16_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 23, 12)).astype(np.float32)
    lens = np.array([23, 14, 1], np.int32)
    jmod = jds2.BiLSTM(16, dtype=jnp.bfloat16)
    params = _draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                   rng)
    want = jmod.apply({"params": params}, jnp.asarray(x), lengths=jnp.asarray(lens))
    tmod = tds2.BiLSTM(12, 16, dtype=torch.bfloat16)
    tmod.load_state_dict(convert_params(params), strict=True)
    got = tmod(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float().detach(), want.astype(jnp.float32), 0.0, 2e-2)  # padding included


def test_bilstm_bf16_keeps_the_cell_state_in_float32():
    """Saturated input, forget and output gates and a constant cell input
    ``tanh(0.01)``: ``c`` grows by 0.01 a frame to 1.5, where a bf16 ``c``
    (steps of 2^-7 above 1) would fall behind by more than 0.1."""
    t, h = 150, 4
    jmod = jds2.BiLSTM(h, dtype=jnp.bfloat16)
    bias = np.full((2, 4 * h), 30.0, np.float32)
    bias[:, 2 * h:3 * h] = 0.01  # the cell input g
    params = {"wx": np.zeros((2, 3, 4 * h), np.float32),
              "wh": np.zeros((2, h, 4 * h), np.float32), "bias": bias}
    x = np.zeros((2, t, 3), np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32)
    tmod = tds2.BiLSTM(3, h, dtype=torch.bfloat16)
    tmod.load_state_dict(convert_params(params), strict=True)
    got = tmod(torch.from_numpy(x)).float().detach()
    assert np.asarray(want)[0, 0, 0] > 0.9  # tanh(0.01) + tanh(1.5)
    _close(got, want, 0.0, 2.0 ** -8 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_model_bf16_matches_jax(jax_model_vars, spect, train):
    _, params, stats = jax_model_vars
    jmodel = jds2.DeepSpeechModel(vocab_size=V, hidden_size=H, num_rnn_layers=2,
                                  dtype=jnp.bfloat16)
    (want, want_lens), mutated = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(spect), jnp.asarray(LENS),
        deterministic=not train, mutable=["batch_stats"])
    model = tds2.DeepSpeechModel(vocab_size=V, hidden_size=H, num_rnn_layers=2, n_freq=F_BINS,
                                 dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(convert_params(params, stats), strict=True)
    got, got_lens = model.train(train)(torch.from_numpy(spect), torch.from_numpy(LENS).long())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got.detach(), want, 0.0, 3e-2)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want_state = convert_params(params, mutated["batch_stats"])
    for name, t in model.state_dict().items():
        if "running" in name:
            _close(t, want_state[name], 1e-3)


def test_reset_parameters_draws_the_jax_init():
    """The port's init has the JAX init's distributions: per-leaf standard
    deviations within 10% (thousands of draws each), truncation at two
    standard deviations, orthogonal recurrent gate blocks, zero biases."""
    hidden, n_freq = 64, 161
    jmodel = jds2.DeepSpeechModel(vocab_size=V, hidden_size=hidden, num_rnn_layers=2)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 20, n_freq)),
                                 jnp.array([20]))
    want = convert_params(jvars["params"], jvars["batch_stats"])
    model = tds2.DeepSpeechModel(vocab_size=V, hidden_size=hidden, num_rnn_layers=2,
                                 n_freq=n_freq, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        w = want[name]
        if w.std() == 0:
            np.testing.assert_array_equal(t.numpy(), w.numpy(), err_msg=name)
            continue
        assert abs(t.std().item() / w.std().item() - 1) < 0.1, name
        assert t.abs().max() <= 2.0 * t.std().item() / 0.87 * 1.01 or "weight_hh" in name, name
    for d in range(2):
        for g in range(4):
            block = got["rnn_1.bilstm.weight_hh"][d, g * hidden:(g + 1) * hidden].double()
            np.testing.assert_allclose((block @ block.T).numpy(), np.eye(hidden), atol=1e-5)


# ---------------------------------------------------------------- decoding


def test_greedy_decoder_and_scores():
    labels = ["_", "A", "B", "C", " ", "'"]
    rng = np.random.default_rng(8)
    probs = rng.standard_normal((3, 12, len(labels))).astype(np.float32)
    probs[0, 3:6, 4] += 5.0  # a run of spaces
    sizes = np.array([12, 7, 0])
    mine = tgreedy.GreedyCTCDecoder(labels, blank_index=0)
    theirs = jgreedy.GreedyCTCDecoder(labels, blank_index=0)
    assert mine.decode(probs, sizes) == theirs.decode(probs, sizes)
    assert mine.decode(torch.from_numpy(probs)) == theirs.decode(probs)
    best = probs.argmax(-1)
    assert mine.convert_to_strings(best, sizes) == theirs.convert_to_strings(best, sizes)
    for a, b in (("AB C", "AB  CC"), ("", "A"), ("A'B", "AB")):
        assert mine.wer(a, b) == theirs.wer(a, b) and mine.cer(a, b) == theirs.cer(a, b)
    no_space = tgreedy.MSGreedyDecoder(["_", "A"], blank_index=0)
    assert no_space.space_index == jgreedy.MSGreedyDecoder(["_", "A"], 0).space_index == 2

"""Port parity for ECAPA-TDNN's front end, model, loss, metric and schedule
(``mindaudio_torch.ops``, ``models.ecapa_tdnn``, ``loss.aam_softmax``,
``metric.eer``, ``scheduler.schedules``) against the JAX package, on the CPU
at a toy width (channels 32 x 4 and 96, embedding 24), with the same numpy
inputs on both sides.

Tolerances, each where it is used:

- the NumPy copies (mel scales, filterbanks, the EER) equal the originals
  bit for bit;
- the mel products in float32, sums in another order: 1e-5 relative, with
  a floor of 1e-5 of the peak;
- the dB fbank 1e-3 dB (the floor's maximum and the log of float32 power);
- each block, the network and ``SpeakerNet`` 1e-5 relative, floor 1e-5 of
  the peak (float32 convolutions and batch norms, sums in another order);
  the running statistics likewise;
- the AAM-softmax loss and its gradient 1e-6; the schedule 1e-7 relative.
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.loss import aam_softmax as jaam
from mindaudio_tpu.metric import eer as jeer
from mindaudio_tpu.models import ecapa_tdnn as jecapa
from mindaudio_tpu.ops import filterbanks as jfb
from mindaudio_tpu.ops import spectral as jspec
from mindaudio_tpu.scheduler import schedules as jsched
from mindaudio_torch.convert import convert_params
from mindaudio_torch.loss import aam_softmax as taam
from mindaudio_torch.metric import eer as teer
from mindaudio_torch.models import ecapa_tdnn as tecapa
from mindaudio_torch.ops import filterbanks as tfb
from mindaudio_torch.ops import spectral as tspec
from mindaudio_torch.recipes.ecapa_tdnn import train_speaker_embeddings as ttse
from mindaudio_torch.scheduler import schedules as tsched

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_RECIPE = os.path.join(REPO, "examples", "ECAPA-TDNN")
TOY = dict(channels=(32, 32, 32, 32, 96), emb_dim=24)


@pytest.fixture(scope="module")
def jax_recipe():
    """``examples/ECAPA-TDNN``'s ``dataset`` and ``train_speaker_embeddings``,
    loaded by path (they import each other by their bare names);
    ``sys.modules`` and ``sys.path`` are put back afterwards."""
    names = ("dataset", "train_speaker_embeddings")
    saved_path = list(sys.path)
    saved = {n: sys.modules.get(n) for n in names}
    try:
        mods = {}
        for name in names:
            spec = importlib.util.spec_from_file_location(name, os.path.join(JAX_RECIPE,
                                                                             f"{name}.py"))
            mods[name] = sys.modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
        yield SimpleNamespace(**mods)
    finally:
        sys.path[:] = saved_path
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def close(got, want, rtol=1e-5, floor=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=floor * np.abs(want).max(), err_msg=err_msg)


class TestFilterbankCopies:
    """Bit for bit."""

    @pytest.mark.parametrize("htk", [False, True])
    def test_mel_scales(self, htk):
        f = np.array([0.0, 300.0, 999.9, 1000.0, 4000.0, 7999.0])
        np.testing.assert_array_equal(tfb.hz_to_mel(f, htk), jfb.hz_to_mel(f, htk))
        for scalar in (440.0, 1500.0):
            assert tfb.hz_to_mel(scalar, htk) == jfb.hz_to_mel(scalar, htk)
        m = jfb.hz_to_mel(f, htk)
        np.testing.assert_array_equal(tfb.mel_to_hz(m, htk), jfb.mel_to_hz(m, htk))
        assert tfb.mel_to_hz(20.0, htk) == jfb.mel_to_hz(20.0, htk)
        np.testing.assert_array_equal(tfb.mel_frequencies(40, 20.0, 7600.0, htk),
                                      jfb.mel_frequencies(40, 20.0, 7600.0, htk))

    @pytest.mark.parametrize("norm", [None, "slaney"])
    @pytest.mark.parametrize("mel_scale", ["htk", "slaney"])
    def test_melscale_fbanks(self, norm, mel_scale):
        args = (201, 0.0, 8000, 80, 16000)
        got = tfb.melscale_fbanks(*args, norm=norm, mel_scale=mel_scale)
        want = jfb.melscale_fbanks(*args, norm=norm, mel_scale=mel_scale)
        assert got.dtype == want.dtype and got.shape == (201, 80)
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError):
            tfb.melscale_fbanks(*args, norm="area")


def _waves(shape, amplitudes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return (x * np.asarray(amplitudes, np.float32)[:, None]).astype(np.float32)


class TestFrontEnd:
    @pytest.mark.parametrize("kw", [
        {}, {"norm": "slaney", "mel_type": "slaney", "n_mels": 40},
        {"power": 1.0, "center": False, "n_fft": 512, "win_length": 400, "hop_length": 160},
        {"pad_mode": "constant", "f_min": 20.0, "f_max": 7600.0, "window": "hamming"}])
    def test_melspectrogram(self, kw):
        wav = _waves((2, 8000 + 37), [1.0, 0.05])
        want = np.asarray(jspec.melspectrogram(jnp.asarray(wav), **kw))
        got = tspec.melspectrogram(wav, device="cpu", **kw).numpy()
        assert got.shape == want.shape
        close(got, want)

    def test_melscale(self):
        spec = np.abs(_waves((2, 201 * 30), [1.0, 3.0])).reshape(2, 201, 30)
        for kw in ({}, {"n_mels": 23, "norm": "slaney", "mel_type": "slaney", "f_min": 60.0}):
            want = np.asarray(jspec.melscale(jnp.asarray(spec), **kw))
            close(tspec.melscale(spec, device="cpu", **kw).numpy(), want)

    @pytest.mark.parametrize("shape", [(7,), (5, 9), (2, 5, 9), (3, 2, 5, 9)])
    def test_amplitude_to_db_floor_axes(self, shape):
        rng = np.random.default_rng(1)
        spec = (10.0 ** rng.uniform(-14, 2, shape)).astype(np.float32)
        for kw in ({}, {"stype": "magnitude", "top_db": 40.0}, {"top_db": None, "ref": 2.0}):
            want = np.asarray(jspec.amplitude_to_db(jnp.asarray(spec), **kw))
            got = tspec.amplitude_to_db(torch.from_numpy(spec), **kw).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)

    def test_fbank_batch_wide_floor(self):
        """A quiet row's features depend on the loud rows beside it: the 80 dB
        floor is one maximum over the whole batch, in both packages."""
        wav = _waves((4, 48000), [1.0, 0.01, 0.3, 1e-3])
        want = np.asarray(jspec.fbank(jnp.asarray(wav), n_mels=80))
        got = tspec.fbank(wav, n_mels=80, device="cpu").numpy()
        assert got.shape == want.shape == (4, 80, 241)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)  # dB
        alone = tspec.fbank(wav[3:], n_mels=80, device="cpu").numpy()[0]
        want_alone = np.asarray(jspec.fbank(jnp.asarray(wav[3:]), n_mels=80))[0]
        np.testing.assert_allclose(alone, want_alone, rtol=0, atol=1e-3)
        assert np.abs(alone - got[3]).max() > 10.0  # the floor of fault (a)

    def test_fbank_deltas_and_context(self):
        wav = _waves((2, 8000), [0.5, 0.2], seed=2)
        for kw in ({"deltas": True}, {"context": True, "left_frames": 2, "right_frames": 3},
                   {"deltas": True, "context": True, "n_mels": 24}):
            want = np.asarray(jspec.fbank(jnp.asarray(wav), **kw))
            got = tspec.fbank(wav, device="cpu", **kw).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)

    def test_compute_deltas(self):
        x = _waves((3, 40 * 17), [1.0, 2.0, 3.0], seed=3).reshape(3, 40, 17)
        for win in (3, 5, 9):
            close(tspec.compute_deltas(torch.from_numpy(x), win).numpy(),
                  jspec.compute_deltas(jnp.asarray(x), win))

    def test_extract_features_both_paths(self, jax_recipe):
        wav = _waves((3, 16000), [0.8, 0.02, 0.3], seed=4)
        want = np.asarray(jax_recipe.train_speaker_embeddings.extract_features(jnp.asarray(wav)))
        got = ttse.extract_features(torch.from_numpy(wav)).numpy()
        assert got.shape == want.shape == (3, 81, 80)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)

        lens = np.array([16000, 9999, 401], np.int32)
        wav[1, 9999:] = 0.0
        wav[2, 401:] = 0.0
        jf, jl = jax_recipe.train_speaker_embeddings.extract_features(
            jnp.asarray(wav), wav_lens=jnp.asarray(lens))
        tf, tl = ttse.extract_features(torch.from_numpy(wav), wav_lens=torch.from_numpy(lens))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tl.tolist() == [81, 50, 3]
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-3)
        for row, n in enumerate(tl.tolist()):
            assert not tf[row, n:].any()


def _draw(tree, rng):
    """Parameters drawn with numpy on a flax shape tree: kernels with the
    fan-in's variance, non-zero biases, batch-norm scales near 1."""
    def leaf(path, a):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _stats(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32), tree)


def _pair(jmodel, tmodel, x, seed, **init_kw):
    """Draw the flax variables of ``jmodel`` on ``x`` and load them into
    ``tmodel`` (``convert_params``, strict)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x), **init_kw)
    variables = {"params": _draw(shapes["params"], rng)}
    if "batch_stats" in shapes:
        variables["batch_stats"] = _stats(shapes["batch_stats"], rng)
    tmodel.load_state_dict(convert_params(variables["params"], variables.get("batch_stats")),
                           strict=True)
    return variables


def _run_both(jmodel, tmodel, variables, x, train, channels_first=True, **kw):
    """Outputs of both (the port's channels-first tensors brought back to the
    flax layout), from ``variables`` loaded afresh into ``tmodel``; in
    training, the running statistics the port's forward wrote are held
    against flax's new ``batch_stats``."""
    tmodel.load_state_dict(convert_params(variables["params"], variables.get("batch_stats")),
                           strict=True)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    new_stats = None
    if train and "batch_stats" in variables:
        want, mutated = jmodel.apply(variables, jnp.asarray(x), deterministic=False,
                                     mutable=["batch_stats"], **jkw)
        new_stats = mutated["batch_stats"]
    else:
        want = jmodel.apply(variables, jnp.asarray(x), deterministic=not train, **jkw)
    tmodel.train(train)
    xt = torch.from_numpy(np.asarray(x))
    with torch.no_grad():
        got = tmodel(xt.transpose(1, 2) if channels_first else xt, **tkw)
    if channels_first:
        got = got.transpose(1, 2)
    if new_stats is not None:
        want_stats = convert_params({}, new_stats)
        buffers = dict(tmodel.named_buffers())
        assert set(buffers) == set(want_stats) and buffers
        for name, buf in buffers.items():
            close(buf.numpy(), want_stats[name].numpy(), err_msg=name)
    return got.numpy(), np.asarray(want)


def _padded_batch(b=4, t=37, c=32, seed=5):
    x = np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)
    lengths = np.array([t, 30, 19, 7], np.int32)[:b]
    return x, lengths


class TestBlocks:
    """Each flax block against the port's, in training mode (outputs and the
    running statistics the forward wrote) and in eval mode with lengths."""

    @pytest.mark.parametrize("kernel,dilation", [(5, 1), (3, 3), (1, 1), (4, 2)])
    def test_tdnn_block(self, kernel, dilation):
        x, _ = _padded_batch()
        jm = jecapa.TDNNBlock(24, kernel, dilation)
        tm = tecapa.TDNNBlock(32, 24, kernel, dilation)
        variables = _pair(jm, tm, x, 0)
        for train in (True, False):
            got, want = _run_both(jm, tm, variables, x, train)
            close(got, want)

    def test_res2net_block(self):
        x, _ = _padded_batch()
        jm = jecapa.Res2NetBlock(32, scale=4, kernel_size=3, dilation=2)
        tm = tecapa.Res2NetBlock(32, scale=4, kernel_size=3, dilation=2)
        variables = _pair(jm, tm, x, 1)
        got, want = _run_both(jm, tm, variables, x, True)
        close(got, want)
        np.testing.assert_array_equal(got[..., :8], x[..., :8])  # chunk 0 passes through
        got, want = _run_both(jm, tm, variables, x, False)
        close(got, want)

    def test_se_block(self):
        x, lengths = _padded_batch()
        jm = jecapa.SEBlock(8, 32)
        tm = tecapa.SEBlock(32, 8, 32)
        variables = _pair(jm, tm, x, 2)
        for kw in ({}, {"lengths": lengths}):
            got, want = _run_both(jm, tm, variables, x, False, **kw)
            close(got, want)

    def test_se_res2net_block_with_shortcut(self):
        x, lengths = _padded_batch()
        jm = jecapa.SERes2NetBlock(48, res2net_scale=4, se_channels=8, kernel_size=3,
                                   dilation=2)
        tm = tecapa.SERes2NetBlock(32, 48, res2net_scale=4, se_channels=8, kernel_size=3,
                                   dilation=2)
        variables = _pair(jm, tm, x, 3)
        assert "shortcut" in variables["params"]
        got, want = _run_both(jm, tm, variables, x, True, lengths=lengths)
        close(got, want)
        got, want = _run_both(jm, tm, variables, x, False, lengths=lengths)
        close(got, want)

    @pytest.mark.parametrize("global_context", [True, False])
    def test_attentive_statistics_pooling(self, global_context):
        x, lengths = _padded_batch()
        jm = jecapa.AttentiveStatisticsPooling(16, global_context)
        tm = tecapa.AttentiveStatisticsPooling(32, 16, global_context)
        variables = _pair(jm, tm, x, 4)
        for train in (True, False):
            for kw in ({}, {"lengths": lengths}):
                got, want = _run_both(jm, tm, variables, x, train, **kw)
                assert got.shape == want.shape == (4, 1, 64)
                close(got, want)
        # frames past a length do not reach the pooled statistics
        junk = x.copy()
        junk[3, 7:] = 100.0
        tm.eval()
        with torch.no_grad():
            a = tm(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(lengths))
            b = tm(torch.from_numpy(junk).transpose(1, 2), torch.from_numpy(lengths))
        torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)

    def test_classifier(self):
        emb = np.random.default_rng(6).standard_normal((4, 1, 24)).astype(np.float32)
        emb[2] = 0.0  # the norm's floor
        for blocks in (0, 1):
            jm = jecapa.Classifier(7, lin_blocks=blocks, lin_neurons=24)
            tm = tecapa.Classifier(7, lin_blocks=blocks, lin_neurons=24)
            variables = _pair(jm, tm, emb, 7)
            for train in (True, False):
                got, want = _run_both(jm, tm, variables, emb, train,
                                             channels_first=False)
                assert got.shape == (4, 7)
                close(got, want)


def _toy_speakernet(jax_recipe, n_classes=5):
    jm = jax_recipe.train_speaker_embeddings.SpeakerNet(n_classes=n_classes,
                                                        emb_dim=TOY["emb_dim"],
                                                        channels=TOY["channels"])
    tm = ttse.SpeakerNet(n_classes, emb_dim=TOY["emb_dim"], channels=TOY["channels"],
                         device="cpu")
    return jm, tm


class TestNetwork:
    def test_ecapa_tdnn(self):
        x, lengths = _padded_batch(c=80, t=41)
        jm = jecapa.EcapaTDNN(channels=TOY["channels"], lin_neurons=TOY["emb_dim"])
        tm = tecapa.EcapaTDNN(80, channels=TOY["channels"], lin_neurons=TOY["emb_dim"])
        variables = _pair(jm, tm, x, 8)
        for train, kw in ((True, {}), (True, {"lengths": lengths}), (False, {"lengths": lengths})):
            got, want = _run_both(jm, tm, variables, x, train, channels_first=False, **kw)
            assert got.shape == want.shape == (4, 1, TOY["emb_dim"])
            close(got, want)

    def test_speakernet_train_and_padded_eval(self, jax_recipe):
        """A bucket batch of mixed lengths, zero past each length as
        ``extract_features`` leaves it: the convolutions run over the padding
        (the batch norms' bias makes it non-zero past the first layer) in
        both, and the pooling masks it."""
        jm, tm = _toy_speakernet(jax_recipe)
        x, lengths = _padded_batch(c=80, t=41, seed=9)
        for row, n in enumerate(lengths):
            x[row, n:] = 0.0
        variables = _pair(jm, tm, x, 9)
        want, mutated = jm.apply(variables, jnp.asarray(x), deterministic=False,
                                 mutable=["batch_stats"])
        tm.train()
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        for g, w in zip(got, want):
            close(g.numpy(), w)
        want_stats = convert_params({}, mutated["batch_stats"])
        for name, buf in tm.named_buffers():
            close(buf.numpy(), want_stats[name].numpy(), err_msg=name)
        tm.eval()
        eval_vars = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        want = jm.apply(eval_vars, jnp.asarray(x), lengths=jnp.asarray(lengths),
                        deterministic=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
        for g, w in zip(got, want):
            close(g.numpy(), w)

    @pytest.mark.parametrize("channels,emb_dim,n_classes,n_params", [
        ((512, 512, 512, 512, 1536), 192, 64, 6_206_336),
        ((512, 512, 512, 512, 1536), 192, 5994, 7_344_896),
        (TOY["channels"], TOY["emb_dim"], 4, 110_180)])
    def test_convert_params_maps_every_leaf(self, jax_recipe, channels, emb_dim, n_classes,
                                            n_params):
        jm = jax_recipe.train_speaker_embeddings.SpeakerNet(n_classes=n_classes, emb_dim=emb_dim,
                                                            channels=channels)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 50, 80)))
        zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
        state = convert_params(zeros["params"], zeros["batch_stats"])
        tm = ttse.SpeakerNet(n_classes, emb_dim=emb_dim, channels=channels, device="cpu")
        mine = tm.state_dict()
        assert set(state) == set(mine)
        assert all(state[k].shape == mine[k].shape for k in state)
        assert sum(p.numel() for p in tm.parameters()) == n_params
        assert len(jax.tree_util.tree_leaves(shapes["batch_stats"])) == 2 * 31
        assert state["classifier.weight"].shape == (emb_dim, n_classes)  # flax's (lin, out)

    def test_reset_parameters_draws_flax_distributions(self):
        tm = ttse.SpeakerNet(300, emb_dim=192, channels=(256, 256, 256, 256, 768), device="cpu")
        tm.reset_parameters(torch.Generator().manual_seed(0))
        conv = tm.embedding_model.mfa.conv.weight  # fan-in 768
        assert abs(conv.std().item() * np.sqrt(768) - 1.0) < 0.02
        assert conv.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(768) + 1e-6
        limit = np.sqrt(6.0 / (192 + 300))
        w = tm.classifier.weight
        assert w.abs().max().item() <= limit and w.abs().max().item() > 0.99 * limit
        assert all(not m.bias.any() for m in tm.modules() if isinstance(m, torch.nn.Conv1d))
        bn = tm.embedding_model.asp_bn
        assert bn.weight.eq(1).all() and bn.running_var.eq(1).all()


class TestLoss:
    def _cosines(self):
        rng = np.random.default_rng(10)
        cos = rng.uniform(-1, 1, (6, 5)).astype(np.float32)
        th = np.cos(np.pi - 0.2)
        cos[0, 1], cos[1, 2], cos[2, 0] = 1.0, -1.0, th - 0.05  # edges, below cos(pi - m)
        cos[3, 3], cos[4, 4] = 1.0 - 1e-5, -0.999
        return cos, np.array([1, 2, 0, 3, 4, 2], np.int32)

    @pytest.mark.parametrize("easy_margin", [False, True])
    def test_value_and_gradient(self, easy_margin):
        cos, targets = self._cosines()
        kw = dict(margin=0.2, scale=30.0, easy_margin=easy_margin)
        want, want_grad = jax.value_and_grad(
            lambda c: jaam.aam_softmax_loss(c, jnp.asarray(targets), **kw))(jnp.asarray(cos))
        c = torch.from_numpy(cos).requires_grad_()
        got = taam.aam_softmax_loss(c, torch.from_numpy(targets), **kw)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
        assert np.isfinite(c.grad.numpy()).all()

    def test_margined_logits(self):
        cos, targets = self._cosines()
        onehot = np.eye(5, dtype=np.float32)[targets]
        want = jaam.additive_angular_margin(jnp.asarray(cos), jnp.asarray(onehot))
        got = taam.additive_angular_margin(torch.from_numpy(cos), torch.from_numpy(onehot))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


class TestMetricAndSchedule:
    @pytest.mark.parametrize("folder", [
        os.path.join(JAX_RECIPE, "convergence"),
        os.path.join(REPO, "mindaudio_torch", "recipes", "ecapa_tdnn", "convergence_artifacts")])
    def test_eer_on_the_committed_scores(self, folder):
        """The JAX run's and the port's committed trial scores give their
        recorded ``eer_cosine`` through both packages' ``get_eer``."""
        scores = np.load(os.path.join(folder, "scores.npz"))
        with open(os.path.join(folder, "results.json")) as f:
            committed = json.load(f)
        got = teer.get_eer(scores["pos"], scores["neg"])
        assert got == jeer.get_eer(scores["pos"], scores["neg"])
        assert got[0] == committed["eer_cosine"]
        assert (len(scores["pos"]), len(scores["neg"])) == (committed["n_pos"], committed["n_neg"])

    def test_eer_from_scores_and_fa_miss(self):
        rng = np.random.default_rng(11)
        scores = np.round(rng.standard_normal(300), 2)  # ties
        labels = (rng.random(300) < 0.3).astype(np.int64)
        scores[labels == 1] += 1.0
        assert teer.get_eer_from_scores(scores, labels) == jeer.get_eer_from_scores(scores,
                                                                                    labels)
        for rt in (True, False):
            for a, b in zip(teer.compute_fa_miss(scores, labels, return_thresholds=rt),
                            jeer.compute_fa_miss(scores, labels, return_thresholds=rt)):
                np.testing.assert_array_equal(a, b)
        assert teer.get_eer([0.9, 0.8], [0.1, 0.2]) == jeer.get_eer([0.9, 0.8], [0.1, 0.2])

    def test_cyclic_triangular_lr(self):
        jsch = jsched.cyclic_triangular_lr(1e-6, 1e-4, 7)
        tsch = tsched.cyclic_triangular_lr(1e-6, 1e-4, 7)
        steps = np.arange(0, 3 * 14 + 1, dtype=np.int32)  # three cycles
        want = np.array([float(jsch(jnp.int32(s))) for s in steps])
        got = np.array([tsch(torch.tensor(s, dtype=torch.int32)).item() for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-7)
        assert got[0] == pytest.approx(1e-6) and got[7] == pytest.approx(1e-4)
        assert tsch(14).item() == pytest.approx(1e-6)

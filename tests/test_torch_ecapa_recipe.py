"""Port parity for the ECAPA-TDNN host layer and recipe
(``mindaudio_torch/data/{augment,filters,spectrum,processing,voxceleb}`` and
``mindaudio_torch/recipes/ecapa_tdnn``) against the JAX package and its
recipe (``examples/ECAPA-TDNN``), on the CPU at a toy width (channels 32 x 4
and 96, embedding 24).

The JAX recipe's files are top-level modules (``dataset``,
``train_speaker_embeddings``, ``speaker_verification_cosine``,
``convergence_run``); they are loaded by path and removed from
``sys.modules`` (and their directory from ``sys.path``) afterwards.

- the NumPy copies of the host layer and the recipe's data functions give
  the same arrays, bit for bit, from the same seeds; ``make_corpus`` writes
  the same bytes;
- the scoring (``score_trials``, ``subtract_mean``, ``training_cohort``,
  ``embed_rows`` through one stub embedding function) is exact;
- one step of the port's recipe against the JAX recipe's step (restated
  from ``train_speaker_embeddings.py:123-150``, where it is nested in
  ``main``) from the same parameters, statistics, features and a running
  AdamW state: the loss, each parameter's update (of the leaf's largest)
  and the running statistics within 1e-5, the gradient norm within 1e-4,
  or four times the port's own float32 spread where that is larger (see
  the test), AdamW's count equal; then a batch holding a NaN waveform,
  after which both have advanced the count, applied the same decay-only
  update and hold NaN running statistics at the same places;
- ``train_speaker_embeddings.main()`` and ``speaker_verification_cosine
  .main()`` run end to end on ``--device cpu``.
"""

import csv
import glob
import hashlib
import importlib.util
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.data import augment as jaug
from mindaudio_tpu.data import filters as jfilters
from mindaudio_tpu.data import io as jio
from mindaudio_tpu.data import processing as jproc
from mindaudio_tpu.data import spectrum as jspectrum
from mindaudio_tpu.data import voxceleb as jvox
from mindaudio_tpu.loss.aam_softmax import aam_softmax_loss as jaam_loss
from mindaudio_tpu.train import config as jconfig
from mindaudio_tpu.train.state import TrainState
from mindaudio_torch.convert import convert_adamw_state, convert_params
from mindaudio_torch.data import augment as taug
from mindaudio_torch.data import filters as tfilters
from mindaudio_torch.data import io as tio
from mindaudio_torch.data import processing as tproc
from mindaudio_torch.data import spectrum as tspectrum
from mindaudio_torch.data import voxceleb as tvox
from mindaudio_torch.models.layers import running_stats
from mindaudio_torch.recipes.ecapa_tdnn import convergence_run as tconv
from mindaudio_torch.recipes.ecapa_tdnn import dataset as tds
from mindaudio_torch.recipes.ecapa_tdnn import speaker_verification_cosine as tsv
from mindaudio_torch.recipes.ecapa_tdnn import train_speaker_embeddings as ttse
from mindaudio_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_RECIPE = os.path.join(REPO, "examples", "ECAPA-TDNN")
TOY = ["--model.channels", "[32,32,32,32,96]", "--model.emb_dim", "24"]


@pytest.fixture(scope="module")
def jax_recipe():
    names = ("dataset", "train_speaker_embeddings", "speaker_verification_cosine",
             "convergence_run")
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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 speakers x (4 train + 1 enrol + 1 test) utterances of 4-8 s."""
    root = str(tmp_path_factory.mktemp("ecapa"))
    tconv.make_corpus(root, 4, n_train=4, n_enrol=1, n_test=1, seed=3)
    return root


def _argv(root, *extra):
    return ["--data.train_csv", f"{root}/train.csv", "--data.enrol_csv", f"{root}/enrol.csv",
            "--data.test_csv", f"{root}/test.csv", "--data.veri_pairs",
            f"{root}/veri_pairs.txt", *TOY, *extra]


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_config_matches_the_jax_recipe():
    argv = TOY + ["--optim.max_lr", "0.002", "--augment.drop_freq", "false"]
    tcfg, device = ttse.parse_args(argv + ["--device", "cpu"])
    jcfg = jconfig.get_config(os.path.join(JAX_RECIPE, "ecapatdnn.yaml"), argv)
    assert tcfg.to_dict() == jcfg.to_dict() and device == torch.device("cpu")
    assert tcfg.model.channels == [32, 32, 32, 32, 96] and tcfg.augment.drop_freq is False
    assert (ttse.FBANK_N_FFT, ttse.FBANK_HOP, tds.SAMPLE_RATE) == (400, 200, 16000)


class TestHostCopies:
    """The port's NumPy copies against the originals, bit for bit."""

    def test_filters_levels_and_rescale(self):
        for f in (1e-3, 0.2, 0.77, 1.0):
            for width in (101, 31):
                _same(tfilters.notch_filter(f, width, 0.05), jfilters.notch_filter(f, width, 0.05))
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 50, 2)).astype(np.float32)
        lengths = np.array([[50.0], [31.0], [7.0]])
        for args in ((x,), (x, lengths[..., None]), (x[:, :, 0], lengths, "peak"),
                     (x[0, :, 0], None, "avg", True)):
            _same(tspectrum.compute_amplitude(*args), jspectrum.compute_amplitude(*args))
        _same(tspectrum.dB_to_amplitude(x, 1.0, 0.5), jspectrum.dB_to_amplitude(x, 1.0, 0.5))
        _same(tspectrum.dB_to_amplitude(x, np.max, 1), jspectrum.dB_to_amplitude(x, np.max, 1))
        y = x[:, :, 0]
        for kw in ({}, {"amp_type": "peak"}, {"amp_type": "max"}, {"dB": True}):
            _same(tproc.rescale(y, 0.3, **kw), jproc.rescale(y, 0.3, **kw))
            _same(tproc.rescale(y[1], -20.0, **kw), jproc.rescale(y[1], -20.0, **kw))
        _same(tproc.rescale(y, 0.3, lengths=lengths), jproc.rescale(y, 0.3, lengths=lengths))
        _same(tproc.unitarize(y, amp_type="peak"), jproc.unitarize(y, amp_type="peak"))

    def test_convolution_and_rms(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 300)).astype(np.float32)
        k = rng.standard_normal(21)
        for kw in ({}, {"padding": 10}, {"padding": (4, 6)}, {"rotation_index": 5},
                   {"use_fft": False}, {"use_fft": False, "stride": 2}):
            _same(taug.convolve1d(x, k, **kw), jaug.convolve1d(x, k, **kw))
        _same(taug.convolve1d(x[0], k[:7]), jaug.convolve1d(x[0], k[:7]))
        rir = np.exp(-np.arange(60) / 9.0) * rng.standard_normal(60)
        for wave in (x[0], x, x[..., None]):
            _same(taug.reverberate(wave, rir), jaug.reverberate(wave, rir))
        _same(taug.rms_normalize(x), jaug.rms_normalize(x))
        _same(taug.caculate_rms(x), jaug.caculate_rms(x))

    @pytest.mark.parametrize("seed", [0, 5])
    def test_drop_freq_chunk_and_speed(self, seed):
        x = np.random.default_rng(2).standard_normal((4, 3000)).astype(np.float32)
        lengths = np.array([1.0, 1.0, 0.6, 0.3])
        for kw in ({}, {"drop_count_low": 2, "drop_count_high": 3, "drop_width": 0.1}):
            _same(taug.drop_freq(x, rng=np.random.default_rng(seed), **kw),
                  jaug.drop_freq(x, rng=np.random.default_rng(seed), **kw))
        _same(taug.drop_freq(x[0], rng=np.random.default_rng(seed)),
              jaug.drop_freq(x[0], rng=np.random.default_rng(seed)))
        for kw in ({}, {"noise_factor": 0.5}, {"drop_start": 100, "drop_end": 900},
                   {"drop_start": -500, "drop_end": -10, "drop_length_high": 300},
                   {"drop_prob": 0.5}):
            _same(taug.drop_chunk(x, lengths, rng=np.random.default_rng(seed), **kw),
                  jaug.drop_chunk(x, lengths, rng=np.random.default_rng(seed), **kw))
        for speeds in ((95,), (105,), (90, 100, 110)):
            _same(taug.speed_perturb(x, 16000, speeds, rng=np.random.default_rng(seed)),
                  jaug.speed_perturb(x, 16000, speeds, rng=np.random.default_rng(seed)))

    def test_noise_and_reverb_from_wavs(self, tmp_path):
        rng = np.random.default_rng(3)
        noises, rirs = [], []
        for i, n in enumerate((700, 2500, 90)):
            noises.append(str(tmp_path / f"noise{i}.wav"))
            tio.write(noises[-1], (0.2 * rng.standard_normal(n)).astype(np.float32), 16000)
        for i in range(2):
            rirs.append(str(tmp_path / f"rir{i}.wav"))
            rir = np.exp(-np.arange(400) / 60.0) * rng.standard_normal(400)
            tio.write(rirs[-1], rir.astype(np.float32), 16000)
        x = rng.standard_normal((3, 4000)).astype(np.float32)
        for seed in (0, 1):
            for wave in (x, x[0], x[:, None, :]):
                _same(taug.add_noise(wave, noises, 0, 15, rng=np.random.default_rng(seed)),
                      jaug.add_noise(wave, noises, 0, 15, rng=np.random.default_rng(seed)))
                _same(taug.add_reverb(wave, rirs, rng=np.random.default_rng(seed)),
                      jaug.add_reverb(wave, rirs, rng=np.random.default_rng(seed)))
        _same(taug.add_noise(x, noises, 5, 5, mix_prob=0.3, rng=np.random.default_rng(4)),
              jaug.add_noise(x, noises, 5, 5, mix_prob=0.3, rng=np.random.default_rng(4)))


def _read_tree(folder):
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, "*.csv"))):
        with open(path, encoding="utf-8") as f:
            out[os.path.basename(path)] = f.read()
    return out


def test_voxceleb_csvs_match(tmp_path):
    rng = np.random.default_rng(4)
    data = tmp_path / "vox"
    for spk in ("id10001", "id10002", "id10003", "id10004"):
        for sess in ("s1", "s2"):
            os.makedirs(data / "wav" / spk / sess)
            for utt in range(2):
                n = int(rng.integers(3 * 16000, 10 * 16000))
                x = (0.1 * rng.standard_normal(n)).astype(np.float32)
                if utt == 1:
                    x[: 3 * 16000] = 0.0  # a silent chunk, dropped by amp_th
                jio.write(str(data / "wav" / spk / sess / f"{utt:05d}.wav"), x, 16000)
    pairs = tmp_path / "veri.txt"
    pairs.write_text("1 id10001/s1/00000.wav id10001/s2/00001.wav\n"
                     "0 id10001/s1/00000.wav id10002/s1/00000.wav\n")
    for split_speaker in (False, True):
        ours, theirs = tmp_path / f"t{split_speaker}", tmp_path / f"j{split_speaker}"
        tvox.prepare_voxceleb(str(data), str(ours), str(pairs), split_ratio=(50, 50),
                              split_speaker=split_speaker)
        jvox.prepare_voxceleb(str(data), str(theirs), str(pairs), split_ratio=(50, 50),
                              split_speaker=split_speaker)
        got, want = _read_tree(str(ours)), _read_tree(str(theirs))
        assert set(got) == {"train.csv", "dev.csv", "enrol.csv", "test.csv"}
        assert got == want
    assert tvox.get_chunks(3.0, "a", 10.5) == jvox.get_chunks(3.0, "a", 10.5)


class TestRecipeData:
    def test_make_corpus_writes_the_same_bytes(self, jax_recipe, tmp_path):
        ours, theirs = tmp_path / "t", tmp_path / "j"
        tconv.make_corpus(str(ours), 3, n_train=2, n_enrol=1, n_test=1, seed=7)
        jax_recipe.convergence_run.make_corpus(str(theirs), 3, n_train=2, n_enrol=1, n_test=1,
                                               seed=7)

        def digest(root):
            out = {}
            for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
                if os.path.isfile(path):
                    data = open(path, "rb").read().replace(str(root).encode(), b"ROOT")
                    out[os.path.relpath(path, root)] = hashlib.sha256(data).hexdigest()
            return out

        got = digest(str(ours))
        assert got == digest(str(theirs)) and len(got) == 3 * 4 + 4

    def test_segments_and_loading(self, jax_recipe, corpus, tmp_path):
        assert tds.read_segments(f"{corpus}/train.csv") == \
            jax_recipe.dataset.read_segments(f"{corpus}/train.csv")
        assert tds.n_speakers(f"{corpus}/train.csv") == 4
        rows, _ = tds.read_segments(f"{corpus}/train.csv")
        span = dict(rows[0], start="1600", stop="40000")
        for row in (rows[0], rows[1], span):
            for seg_len, seed in ((48000, 0), (48000, None), (200000, 1), (16000, 2)):
                rng = None if seed is None else np.random.default_rng(seed)
                jrng = None if seed is None else np.random.default_rng(seed)
                _same(tds.load_segment(row, seg_len, rng=rng),
                      jax_recipe.dataset.load_segment(row, seg_len, rng=jrng))
        # a file at another rate is resampled, the span rescaled with it
        x, _ = tio.read(rows[2]["wav"])
        other = str(tmp_path / "8k.wav")
        tio.write(other, np.asarray(x[::2], np.float32), 8000)
        for row in (dict(rows[2], wav=other), dict(rows[2], wav=other, start="800",
                                                   stop="20000"), span):
            _same(tsv._read_full(row), jax_recipe.speaker_verification_cosine._read_full(row))

    def test_augmenter_and_batch_iterator(self, jax_recipe, corpus, tmp_path):
        noise_dir, rir_dir = tmp_path / "noise", tmp_path / "rir"
        os.makedirs(noise_dir)
        os.makedirs(rir_dir)
        rng = np.random.default_rng(5)
        tio.write(str(noise_dir / "n.wav"), (0.1 * rng.standard_normal(9000)).astype(np.float32),
                  16000)
        tio.write(str(rir_dir / "r.wav"), (np.exp(-np.arange(300) / 40.0)
                                           * rng.standard_normal(300)).astype(np.float32), 16000)
        for extra in ([], ["--data.noise_folder", str(noise_dir), "--data.rir_folder",
                           str(rir_dir)], ["--augment.speed_perturb", "false"]):
            argv = _argv(corpus, *extra)
            tcfg, _ = ttse.parse_args(argv + ["--device", "cpu"])
            jcfg = jconfig.get_config(os.path.join(JAX_RECIPE, "ecapatdnn.yaml"), argv)
            kw = dict(seg_dur=1.0, epochs=2, seed=3)
            ours = list(tds.batch_iterator(tcfg.data.train_csv, 4, augmenter=tds.Augmenter(
                tcfg, np.random.default_rng(0)), **kw))
            theirs = list(jax_recipe.dataset.batch_iterator(
                jcfg.data.train_csv, 4, augmenter=jax_recipe.dataset.Augmenter(
                    jcfg, np.random.default_rng(0)), **kw))
            assert len(ours) == len(theirs) == 8  # 16 rows, B = 4, two epochs
            for (e, got), (je, want) in zip(ours, theirs):
                assert e == je and got.keys() == want.keys() == {"wavs", "labels"}
                _same(got["wavs"], want["wavs"])
                _same(got["labels"], want["labels"])
        plain = list(tds.batch_iterator(f"{corpus}/train.csv", 3, seg_dur=0.5, shuffle=False))
        want = list(jax_recipe.dataset.batch_iterator(f"{corpus}/train.csv", 3, seg_dur=0.5,
                                                      shuffle=False))
        assert len(plain) == len(want) == 5
        for (_, got), (_, w) in zip(plain, want):
            _same(got["wavs"], w["wavs"])
            _same(got["labels"], w["labels"])


def _stub_embed(wavs, lens):
    """An embedding function both recipes can call: numpy in and out."""
    w, n = np.asarray(wavs), np.asarray(lens)
    return np.stack([w.sum(1), np.abs(w).max(1), n.astype(np.float32), w[:, :5].sum(1)], 1)


class TestScoring:
    def test_bucketing_cohort_and_scores(self, jax_recipe, corpus):
        jsv = jax_recipe.speaker_verification_cosine
        for n in (0, 1, 31999, 32000, 32001, 700000):
            assert tsv._bucket_len(n) == jsv._bucket_len(n)
        rows = tds.read_segments(f"{corpus}/train.csv")[0]
        got = tsv.embed_rows(_stub_embed, rows)
        want = jsv.embed_rows(_stub_embed, rows)
        assert list(got) == list(want) and len(got) == 16
        for k in want:
            _same(got[k], want[k])
        for pool in (0, 5, 11):
            _same(tsv.training_cohort(_stub_embed, f"{corpus}/train.csv", pool),
                  jsv.training_cohort(_stub_embed, f"{corpus}/train.csv", pool))

        rng = np.random.default_rng(6)
        embs = {f"u{i}": rng.standard_normal(8) for i in range(10)}
        mean = rng.standard_normal(8)
        sub_t, sub_j = tsv.subtract_mean(embs, mean), jsv.subtract_mean(embs, mean)
        for k in embs:
            _same(sub_t[k], sub_j[k])
        pairs = [(int(rng.random() < 0.3), f"u{rng.integers(10)}", f"u{rng.integers(12)}")
                 for _ in range(40)]
        cohort = rng.standard_normal((20, 8))
        for kw in ({}, {"cohort": cohort}, {"cohort": cohort, "cohort_size": 5},
                   {"cohort": cohort, "cohort_size": 50}):
            assert tsv.score_trials(sub_t, pairs, **kw) == jsv.score_trials(sub_j, pairs, **kw)
        path = f"{corpus}/veri_pairs.txt"
        with open(path) as f:
            keys = [(int(lab), *(p.replace("/", "--").rsplit(".", 1)[0] for p in (e, t)))
                    for lab, e, t in (line.split() for line in f)]
        assert tsv.read_pairs(path) == keys and len(keys) == 16


def _jax_step(jrecipe, cfg, model):
    """The JAX recipe's train step, restated from
    ``examples/ECAPA-TDNN/train_speaker_embeddings.py:123-150`` (it is
    nested in ``main`` there)."""
    n_mels = int(cfg.features.n_mels)

    def loss_fn(params, batch_stats, batch):
        feats = jrecipe.extract_features(batch["wavs"], n_mels=n_mels)
        (emb, cosine), mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, feats,
            deterministic=False, mutable=["batch_stats"],
        )
        loss = jaam_loss(cosine, batch["labels"], margin=float(cfg.optim.margin),
                         scale=float(cfg.optim.scale))
        acc = (cosine.argmax(-1) == batch["labels"]).mean()
        return loss, (mutated["batch_stats"], acc)

    def step(state, batch):
        (loss, (new_stats, acc)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.batch_stats, batch)
        gnorm = optax.global_norm(grads)
        scale = jnp.where(jnp.isfinite(gnorm),
                          jnp.minimum(1.0, cfg.optim.grad_clip / (gnorm + 1e-6)), 0.0)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(jnp.isfinite(g), g * scale, 0.0), grads)
        state = state.apply_gradients(grads=grads).replace(batch_stats=new_stats)
        return state, {"loss": loss, "acc": acc, "grad_norm": gnorm}

    return jax.jit(step)


def _draw(tree, rng):
    def leaf(path, a):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _running_adam(opt_state, rng):
    """Moments drawn with numpy, count 3: a running optimizer whose update is
    smooth in the gradient (the second moment well above the squared
    gradients' rounding) and moves with it (the first moment about as large
    as the gradient's contribution)."""
    adam = opt_state[0]
    mu = jax.tree_util.tree_map(
        lambda m: jnp.asarray(1e-3 * rng.standard_normal(m.shape), jnp.float32), adam.mu)
    nu = jax.tree_util.tree_map(
        lambda v: jnp.asarray(1e-4 * (1.0 + rng.random(v.shape)), jnp.float32), adam.nu)
    count = jnp.asarray(3, jnp.int32)
    rest = tuple(s._replace(count=count) if "count" in s._fields else s for s in opt_state[1:])
    return (adam._replace(count=count, mu=mu, nu=nu), *rest)


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _port_step(tcfg, variables, opt_host, batch, model=None, opt=None):
    """One step of the port's recipe: from ``variables`` and ``opt_host``
    (flax/optax trees) unless ``model``/``opt`` carry on from a step before.
    Returns ``(metrics, {name: update}, {name: buffer}, model, opt)``."""
    if model is None:
        model = ttse.build_model(tcfg, torch.device("cpu"), 4)
        model.load_state_dict(convert_params(variables["params"], variables["batch_stats"]),
                              strict=True)
        model.train()
        opt = ttse.make_optimizer(tcfg, model)
        opt.load_state_dict(convert_adamw_state(opt_host))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = ttse.make_step(tcfg, model, opt)({"wavs": torch.from_numpy(batch["wavs"]),
                                            "labels": torch.from_numpy(batch["labels"]).long()})
    updates = {n: p.detach() - before[n] for n, p in model.named_parameters()}
    return got, updates, {n: b.clone() for n, b in model.named_buffers()}, model, opt


def _errors(got, updates, buffers, want, want_updates, want_buffers):
    """Relative errors: the loss and gradient norm; the worst parameter's
    update against its largest element; the worst running statistic
    against its largest element."""
    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()
    return {"loss": abs(got["loss"].item() / float(want["loss"]) - 1),
            "grad_norm": abs(got["grad_norm"].item() / float(want["grad_norm"]) - 1),
            "update": max(rel(updates[n], want_updates[n]) for n in want_updates),
            "stats": max(rel(buffers[n], want_buffers[n]) for n in buffers)}


def test_one_step_matches_the_jax_recipe_and_a_nan_batch(jax_recipe, corpus, monkeypatch):
    """The tolerances: 1e-5 on the loss, on each parameter's update (of its
    leaf's largest) and on the running statistics, 1e-4 on the gradient
    norm, or four times the port's own spread, the larger. The spread is how
    far the port's step moves when every feature is moved by one float32
    ulp (two draws): the batch norms and the AAM scale make this step
    ill-conditioned (at this width a one-ulp move of the features moves an
    update by up to about 1e-4 of its leaf). The features are pinned to the
    JAX recipe's on both sides, so the step is compared alone: a one-ulp
    move of the waveform moves the dB features of quiet mel bands by much
    more, and the front end is held on its own in
    ``test_torch_ecapa.py``."""
    # a learning rate of 0.8 at count 3 (0.2 up to 1.0 over 4 steps), so that
    # an update is large against its parameter's float32 rounding
    argv = _argv(corpus, "--optim.min_lr", "0.2", "--optim.max_lr", "1.0",
                 "--optim.cycle_steps", "4")
    jcfg = jconfig.get_config(os.path.join(JAX_RECIPE, "ecapatdnn.yaml"), argv)
    tcfg, _ = ttse.parse_args(argv + ["--device", "cpu"])
    jtse = jax_recipe.train_speaker_embeddings
    _, batch = next(tds.batch_iterator(tcfg.data.train_csv, 4, seg_dur=1.0,
                                       augmenter=tds.Augmenter(tcfg, np.random.default_rng(1))))
    feats = np.array(jtse.extract_features(jnp.asarray(batch["wavs"])))
    jmodel = jtse.SpeakerNet(n_classes=4, emb_dim=24, channels=(32, 32, 32, 32, 96))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(feats))
    rng = np.random.default_rng(7)
    variables = {"params": _draw(shapes["params"], rng),
                 "batch_stats": jax.tree_util.tree_map(
                     lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
                     shapes["batch_stats"])}
    tx = optax.adamw(jtse.cyclic_triangular_lr(0.2, 1.0, 4),
                     weight_decay=float(jcfg.optim.weight_decay))
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    state = state.replace(step=3, opt_state=_running_adam(state.opt_state, rng))
    opt_host = _host(state.opt_state)

    def jax_run(step, b):
        nonlocal state
        before = convert_params(_host(state.params))
        state, want = step(state, {"wavs": jnp.asarray(b["wavs"]),
                                   "labels": jnp.asarray(b["labels"])})
        after = convert_params(_host(state.params), _host(state.batch_stats))
        return want, {n: after[n] - before[n] for n in before}, after

    pinned = SimpleNamespace(extract_features=lambda wavs, n_mels=80: jnp.asarray(feats))
    want, want_updates, after = jax_run(_jax_step(pinned, jcfg, jmodel), batch)
    want_buffers = {n: after[n] for n in after if "running_" in n}

    def pin(f):
        monkeypatch.setattr(ttse, "extract_features",
                            lambda wavs, n_mels=80, wav_lens=None: torch.from_numpy(f))

    pin(feats)
    got, updates, buffers, model, opt = _port_step(tcfg, variables, opt_host, batch)
    spread = {}
    for seed in (1, 2):
        sign = np.random.default_rng(seed).choice([-1.0, 1.0], feats.shape).astype(np.float32)
        pin(feats + np.spacing(np.abs(feats)) * sign)
        moved = _port_step(tcfg, variables, opt_host, batch)[:3]
        for k, v in _errors(*moved, got, updates, buffers).items():
            spread[k] = max(spread.get(k, 0.0), v)
    stated = {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-5, "stats": 1e-5}
    tols = {k: max(stated[k], 4 * spread[k]) for k in stated}
    errs = _errors(got, updates, buffers, want, want_updates, want_buffers)
    print("errors", errs, "spread", spread, "tolerances", tols)
    assert all(errs[k] <= tols[k] for k in tols), (errs, tols, spread)
    assert tols["stats"] == 1e-5 and tols["update"] < 1e-2, tols  # a bound on the spread
    assert float(want["grad_norm"]) > float(jcfg.optim.grad_clip)  # the clip is active
    assert opt.count.item() == int(state.opt_state[0].count) == 4

    # a NaN waveform, through the real front end: the batch-wide fbank floor
    # spreads it to every row; both zero the gradients, still apply AdamW
    # (the count, the moments' decay, the weight decay) and keep the NaN
    # statistics
    monkeypatch.undo()
    bad = dict(batch, wavs=batch["wavs"].copy())
    bad["wavs"][1] = np.nan
    want, want_updates, after = jax_run(_jax_step(jtse, jcfg, jmodel), bad)
    got, updates, buffers, model, opt = _port_step(tcfg, variables, opt_host, bad, model, opt)
    assert np.isnan(got["loss"].item()) and np.isnan(float(want["loss"]))
    assert opt.count.item() == int(state.opt_state[0].count) == 5 and int(state.step) == 5
    for name, update in updates.items():
        w = want_updates[name]
        assert torch.isfinite(update).all() and update.abs().max() > 0, name
        np.testing.assert_allclose(update.numpy(), w.numpy(), rtol=0,
                                   atol=tols["update"] * w.abs().max().item(), err_msg=name)
    assert len(buffers) == 62 == len(running_stats(model))
    for name, buf in buffers.items():
        assert torch.isnan(buf).all() and np.isnan(after[name].numpy()).all(), name


def test_check_supported_refuses_several_processes(monkeypatch):
    """Several processes run data parallel, but only over a global batch
    they split evenly."""
    cfg, _ = ttse.parse_args(TOY + ["--device", "cpu"])
    ttse.check_supported(cfg)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    cfg.data["batch_size"] = 4
    ttse.check_supported(cfg)
    cfg.data["batch_size"] = 3
    with pytest.raises(ValueError, match="data parallel"):
        ttse.check_supported(cfg)


def test_train_and_verify_end_to_end(corpus, tmp_path):
    argv = _argv(corpus, "--device", "cpu", "--data.batch_size", "4", "--data.seg_dur", "1.0",
                 "--train.ckpt_dir", str(tmp_path / "ckpt"), "--train.max_steps", "3",
                 "--train.log_every_steps", "2", "--train.save_every_steps", "2",
                 "--optim.max_lr", "0.001", "--optim.cycle_steps", "2", "--eval.cohort_size", "6")
    out = ttse.main(argv)
    assert out["steps"] == 3 and sorted(out["losses"]) == [1, 2]
    assert np.isfinite(list(out["losses"].values())).all()
    assert tckpt.list_steps(str(tmp_path / "ckpt")) == [2, 3]
    saved = tckpt.restore_checkpoint(str(tmp_path / "ckpt"))
    assert set(saved) == {"params", "buffers"} and len(saved["buffers"]) == 62
    cfg, device = ttse.parse_args(argv)
    restored = tsv.load_model(cfg, device)
    for (name, a), b in zip(out["model"].state_dict().items(), restored.state_dict().values()):
        assert torch.equal(a, b), name
    eers = [tsv.main(argv + ["--eval.score_norm", flag]) for flag in ("false", "true")]
    assert all(np.isfinite(e) and 0.0 <= e <= 1.0 for e in eers)
    with open(f"{corpus}/train.csv", newline="") as f:
        assert len(list(csv.DictReader(f))) == 16

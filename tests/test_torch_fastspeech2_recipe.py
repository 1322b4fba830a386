"""Port parity for the FastSpeech2 recipe (``mindaudio_torch/recipes/fastspeech2``)
and its host-side copies (``data/spectrum``, ``data/textgrid``,
``data/features.yin``, the ``text`` front end), against the JAX recipe
(``examples/fastspeech2``) and the JAX package, on the CPU at a toy size
(d_model 32, 2 heads, FFN 64, 2 + 2 blocks).

The JAX recipe's modules (``text``, ``dataset``, ``train``, ``preprocess``,
``convergence_run``) are loaded by name from their directory and removed
from ``sys.modules`` (and the directory from ``sys.path``) afterwards.

- the YAML is the JAX recipe's (after the same overrides);
- the NumPy copies give the same values bit for bit: the text front end
  (the symbol table, 288 symbols, and the ids of English, number,
  abbreviation, CMUdict and pinyin strings), ``read_textgrid`` (long and
  short formats) and ``alignment_to_durations``, ``yin`` on tones, glides
  and noise, ``stft``/``spectrogram``/``melscale``/``melspectrogram``,
  ``batch_iterator``, ``mcd_db`` and ``mcd_dtw_db``;
- ``preprocess.main()`` on a corpus in LJSpeech's layout (TextGrid
  alignments, the ``.npy`` duration fallback, the uniform split, the pinyin
  transcripts) writes the same ``.npy`` contents as the JAX ``main()``;
- ``build_corpus`` and ``prepare_wavegrad_corpus`` write byte-equal files;
- ``evaluate`` on a toy checkpoint against the JAX ``evaluate`` on the same
  parameters: the duration metrics exactly, the others within 1e-4
  relative (a float32 model; the metrics are float64 means of its output);
- ``train.main()``, ``generate.main()`` (English and ``--pinyin``, both
  checkpoint layouts) and ``convergence_run.main()`` end to end on
  ``--device cpu``, each turning TF32 off (the recipe computes in float32,
  as JAX's does), and their ``--wavegrad_ckpt`` legs with a toy WaveGrad
  (channels 8-32; ``generate``'s 1000-step schedule cut to its last 3
  steps for CPU time).
"""

import filecmp
import functools
import importlib
import os
import shutil
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.data import features as jfeatures
from mindaudio_tpu.data import spectrum as jspectrum
from mindaudio_tpu.data import textgrid as jtextgrid
from mindaudio_tpu.train import config as jconfig
from mindaudio_torch.convert import convert_params
from mindaudio_torch.data import features as tfeatures
from mindaudio_torch.data import io as tio
from mindaudio_torch.data import spectrum as tspectrum
from mindaudio_torch.data import textgrid as ttextgrid
from mindaudio_torch.models import wavegrad as twg
from mindaudio_torch.recipes.fastspeech2 import convergence_run as tconv
from mindaudio_torch.recipes.fastspeech2 import dataset as tdataset
from mindaudio_torch.recipes.fastspeech2 import generate as tgenerate
from mindaudio_torch.recipes.fastspeech2 import preprocess as tpreprocess
from mindaudio_torch.recipes.fastspeech2 import synthetic
from mindaudio_torch.recipes.fastspeech2 import text as ttext
from mindaudio_torch.recipes.fastspeech2 import train as ttrain
from mindaudio_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_RECIPE = os.path.join(REPO, "examples", "fastspeech2")
YAML = os.path.join(JAX_RECIPE, "fastspeech2.yaml")
TOY = ["--model.d_model", "32", "--model.head_num", "2", "--model.conv_filter", "64",
       "--model.encoder_layers", "2", "--model.decoder_layers", "2"]
NAMES = ("text", "text.cleaners", "text.numbers", "text.pinyin", "dataset", "train",
         "preprocess", "convergence_run")


@pytest.fixture(scope="module")
def jax_recipe():
    saved_path = list(sys.path)
    saved = {n: sys.modules.pop(n, None) for n in NAMES}
    try:
        sys.path.insert(0, JAX_RECIPE)
        yield SimpleNamespace(**{n: importlib.import_module(n) for n in NAMES if "." not in n})
    finally:
        sys.path[:] = saved_path
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def _run_jax_main(module, argv):
    saved = sys.argv
    sys.argv = [module.__file__] + list(argv)
    try:
        return module.main()
    finally:
        sys.argv = saved


def _same_npy_dicts(dir_a, dir_b, names):
    for name in names:
        a = np.load(os.path.join(dir_a, name + ".npy"), allow_pickle=True).item()
        b = np.load(os.path.join(dir_b, name + ".npy"), allow_pickle=True).item()
        assert set(a) == set(b), name
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (name, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")


def test_config_matches_the_jax_recipe():
    argv = TOY + ["--optim.lr", "0.002", "--data.pinyin", "true"]
    tcfg, device, seed = ttrain.parse_args(argv + ["--device", "cpu", "--init-seed", "3"])
    jcfg = jconfig.get_config(YAML, argv)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert (device, seed, tcfg.optim.lr, tcfg.data.pinyin) == (torch.device("cpu"), 3, 0.002,
                                                               True)


# -------------------------------------------------------------- host copies


STRINGS = ["The quick brown fox jumps over the lazy dog.",
           "Dr. Smith paid $42 on Jan. 3rd, 1999 -- Mr. Jones's 1,250 people!",
           "Mrs. O'Neil & Co. Ltd.; Sgt. Pepper's lonely hearts club band, No. 7?",
           "Numbers: 0, 13, 101, 2000, 1st 22nd 33rd 1000000 3.14 £5 $2.50",
           "Café naïve coöperate — résumé", "", "   multiple    spaces   "]
PINYIN = ["ni3 hao3", "zhong1 guo2 ren2", "yi1 er4 san1, si4! wu3", "nver3 lv4 xue2 yue4",
          "wo3 men5 sp hao3 sil", "er2 hua4r4 hello 123", "jiong3 qiu2 xiu4 yun1 zhi1 chi1"]


def test_text_front_end(jax_recipe, tmp_path):
    jtext = jax_recipe.text
    assert ttext.symbols == jtext.symbols and ttext.vocab_size() == jtext.vocab_size() == 288
    for s in STRINGS:
        assert ttext.text_to_sequence(s) == jtext.text_to_sequence(s), s
        assert ttext.clean_text(s) == jtext.clean_text(s)
    for s in PINYIN:
        assert ttext.pinyin_to_sequence(s) == jtext.pinyin_to_sequence(s), s
    phones = ["sil", "HH", "AH0", "L", "OW1", "sp", "spn", "ZH", "xx", "zh", "ang3", "rr", ""]
    assert ttext.phones_to_sequence(phones) == jtext.phones_to_sequence(phones)
    dict_path = tmp_path / "cmudict"
    dict_path.write_text(";;; comment\nHELLO  HH AH0 L OW1\nHELLO(1)  HH EH0 L OW1\n"
                         "WORLD  W ER1 L D\nQUICK  K W IH1 K\nBAD  B AE1 XX\n",
                         encoding="latin-1")
    tdict, jdict = ttext.load_cmudict(str(dict_path)), jtext.load_cmudict(str(dict_path))
    assert tdict == jdict and "bad" not in tdict
    for s in STRINGS + ["hello, world! the quick one"]:
        assert ttext.text_to_sequence(s, cmudict=tdict) == jtext.text_to_sequence(s,
                                                                                  cmudict=jdict)


LONG_TG = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 1.5
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 1.5
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 1.5
            text = "hello"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 1.5
        intervals: size = 6
        intervals [1]:
            xmin = 0
            xmax = 0.2
            text = "sil"
        intervals [2]:
            xmin = 0.2
            xmax = 0.4512
            text = "HH"
        intervals [3]:
            xmin = 0.4512
            xmax = 0.7
            text = "AH0"
        intervals [4]:
            xmin = 0.7
            xmax = 0.85
            text = ""
        intervals [5]:
            xmin = 0.85
            xmax = 1.1
            text = "OW1"
        intervals [6]:
            xmin = 1.1
            xmax = 1.5
            text = "sp"
'''

SHORT_TG = '''File type = "ooTextFile short"
"TextGrid"

0
1.2
<exists>
2
"IntervalTier"
"phones"
0
1.2
3
0
0.3
"sil"
0.3
0.9
"AA1"
0.9
1.2
"B"
"TextTier"
"marks"
0
1.2
1
0.5
"x"
'''


@pytest.mark.parametrize("fmt", ["long", "short", "file"])
def test_textgrid(fmt, tmp_path):
    text = SHORT_TG if fmt == "short" else LONG_TG
    if fmt == "file":
        (tmp_path / "a.TextGrid").write_text(text, encoding="utf-8")
        text = str(tmp_path / "a.TextGrid")
    got, want = ttextgrid.read_textgrid(text), jtextgrid.read_textgrid(text)
    assert got == want and "phones" in got
    for trim in (True, False):
        for sr, hop in ((22050, 256), (24000, 300)):
            assert (ttextgrid.alignment_to_durations(got["phones"], sr, hop,
                                                     trim_trailing_silence=trim)
                    == jtextgrid.alignment_to_durations(want["phones"], sr, hop,
                                                        trim_trailing_silence=trim))
    assert ttextgrid.alignment_to_durations([(0, 1, "sil")], 16000, 160) == ([], [], 0.0, 0.0)


def _signals():
    rng = np.random.default_rng(0)
    sr = 22050
    t = np.arange(int(0.6 * sr)) / sr
    glide = np.sin(2 * np.pi * np.cumsum(np.linspace(90, 350, t.size)) / sr)
    return {"tone": np.sin(2 * np.pi * 180.0 * t) + 0.3 * np.sin(2 * np.pi * 360.0 * t),
            "glide": glide, "noise": 0.1 * rng.standard_normal(t.size),
            "short": np.sin(2 * np.pi * 220 * t[:700]), "silence": np.zeros(3000)}


@pytest.mark.parametrize("name", sorted(_signals()))
def test_yin(name):
    x = _signals()[name].astype(np.float32)
    for kw in ({"sample_rate": 22050, "hop_length": 256},
               {"sample_rate": 16000, "frame_length": 512, "center": False, "fmin": 80.0}):
        if not kw.get("center", True) and x.size < 512:
            continue
        got, want = tfeatures.yin(x, **kw), jfeatures.yin(x, **kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if name == "tone":
        f0 = tfeatures.yin(x, sample_rate=22050, hop_length=256)
        assert abs(np.median(f0[2:-2]) - 180.0) < 2.0


def test_spectrum_copies():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    cases = [
        ("stft", dict(n_fft=512)), ("stft", dict(n_fft=400, hop_length=100, window="hamming",
                                                 center=False, return_complex=False)),
        ("spectrogram", dict(n_fft=1024, hop_length=256, pad_mode="constant")),
        ("spectrogram", dict(n_fft=400, pad=3, power=1.0, normalized=True)),
        ("spectrogram", dict(n_fft=256, power=None, onesided=False)),
        ("melspectrogram", dict(n_fft=1024, hop_length=256, win_length=1024, n_mels=80,
                                sample_rate=22050, pad_mode="constant")),
        ("melspectrogram", dict(n_fft=1024, hop_length=300, win_length=1024, n_mels=128,
                                sample_rate=24000, norm="slaney", mel_type="slaney")),
        ("melspectrogram", dict(n_fft=512, win_length=400, hop_length=160, n_mels=40,
                                f_min=20, f_max=7600)),
    ]
    for name, kw in cases:
        for sig in (x, x[0]):
            got, want = getattr(tspectrum, name)(sig, **kw), getattr(jspectrum, name)(sig, **kw)
            assert got.dtype == want.dtype and got.shape == want.shape, (name, kw)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {kw}")
    spec = np.abs(rng.standard_normal((201, 30))).astype(np.float32)
    for kw in ({}, {"norm": "slaney", "mel_type": "slaney", "n_mels": 40, "f_min": 50}):
        np.testing.assert_array_equal(tspectrum.melscale(spec, **kw),
                                      jspectrum.melscale(spec, **kw))


def test_mcd_copies(jax_recipe):
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((37, 128)), rng.standard_normal((29, 128))
    assert tconv.mcd_db(a[:29], b) == jax_recipe.convergence_run.mcd_db(a[:29], b)
    assert tconv.mcd_dtw_db(a, b) == jax_recipe.convergence_run.mcd_dtw_db(a, b)
    assert tconv.mcd_dtw_db(a, a) == 0.0


# ------------------------------------------------------- corpus and batches


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The convergence corpus: 40 utterances (8 train, 32 dev) with wavs."""
    root = str(tmp_path_factory.mktemp("fs2_corpus"))
    dev = tconv.build_corpus(root, 40, seed=5, write_wavs=True)
    return SimpleNamespace(root=root, dev=dev)


def test_build_corpus_and_wavegrad_corpus_byte_equal(jax_recipe, tmp_path):
    jconv = jax_recipe.convergence_run
    ours, theirs = tmp_path / "t", tmp_path / "j"
    assert tconv.build_corpus(str(ours), 4, seed=3, write_wavs=True) == jconv.build_corpus(
        str(theirs), 4, seed=3, write_wavs=True)
    for sub in ("", "wavs"):
        names = sorted(os.listdir(ours / sub))
        assert names == sorted(os.listdir(theirs / sub)) and len(names) >= 4
        _, mismatch, errors = filecmp.cmpfiles(ours / sub, theirs / sub,
                                               [n for n in names if n != "wavs"], shallow=False)
        assert not mismatch and not errors, mismatch
    tconv.prepare_wavegrad_corpus(str(ours), str(tmp_path / "wt"))
    jconv.prepare_wavegrad_corpus(str(theirs), str(tmp_path / "wj"))
    names = sorted(os.listdir(tmp_path / "wt"))
    assert names == sorted(os.listdir(tmp_path / "wj")) and len(names) == 5
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "wt", tmp_path / "wj", names,
                                           shallow=False)
    assert not mismatch and not errors
    mel = tconv.fs2_mel_to_wavegrad(np.linspace(-20, 5, 11))
    np.testing.assert_array_equal(mel, jconv.fs2_mel_to_wavegrad(np.linspace(-20, 5, 11)))


@pytest.mark.parametrize("max_ph,max_mel", [(24, 320), (10, 40)])
def test_batch_iterator(jax_recipe, corpus, max_ph, max_mel):
    """The corpus's 8 training utterances; the narrow bounds truncate the
    phonemes and clamp the durations."""
    kw = dict(epochs=2, seed=4)
    got = list(tdataset.batch_iterator(corpus.root, 3, max_ph, max_mel, **kw))
    want = list(jax_recipe.dataset.batch_iterator(corpus.root, 3, max_ph, max_mel, **kw))
    assert len(got) == len(want) == 4
    for (e1, b1), (e2, b2) in zip(got, want):
        assert e1 == e2 and set(b1) == set(b2)
        for k in b1:
            assert b1[k].dtype == b2[k].dtype
            np.testing.assert_array_equal(b1[k], b2[k])
        assert (b1["duration"].sum(1) <= max_mel).all()
    ranks = [list(tdataset.batch_iterator(corpus.root, 4, max_ph, max_mel, rank=r,
                                          world_size=2)) for r in (0, 1)]
    want = list(jax_recipe.dataset.batch_iterator(corpus.root, 4, max_ph, max_mel, rank=1,
                                                  world_size=2))
    np.testing.assert_array_equal(ranks[1][0][1]["mel"], want[0][1]["mel"])


@pytest.fixture(scope="module")
def ljspeech(tmp_path_factory):
    """Eight utterances in LJSpeech's layout (TextGrids for four), one with a
    ``.npy`` duration array shorter than its transcript; and two
    tone-numbered pinyin transcripts of the same audio."""
    root = str(tmp_path_factory.mktemp("lj"))
    lj, feature_dir = synthetic.gen(root, n_utts=8, seed=2)
    np.save(os.path.join(feature_dir, "TextGrid", "LJ001-0003.npy"),
            np.array([3, 0, 5, 2, 7], np.int64))
    pinyin = os.path.join(root, "pinyin")
    shutil.copytree(os.path.join(lj, "wavs"), os.path.join(pinyin, "wavs"))
    with open(os.path.join(pinyin, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("LJ001-0001|x|ni3 hao3 zhong1 guo2\nLJ001-0005|x|wo3 men5, sp hao3 r5\n"
                "LJ001-0099|missing|x\nbroken line\n")
    return SimpleNamespace(root=root, lj=lj, feature_dir=feature_dir, pinyin=pinyin)


@pytest.mark.parametrize("mode", ["english", "pinyin"])
def test_preprocess_matches_the_jax_recipe(jax_recipe, ljspeech, tmp_path, mode):
    src = ljspeech.lj if mode == "english" else ljspeech.pinyin
    outs = {}
    for side in ("t", "j"):
        out = str(tmp_path / side)
        shutil.copytree(os.path.join(ljspeech.feature_dir, "TextGrid"),
                        os.path.join(out, "TextGrid"))
        argv = ["--data.ljspeech_dir", src, "--data.feature_dir", out]
        if mode == "pinyin":
            shutil.rmtree(os.path.join(out, "TextGrid"))
            argv += ["--data.pinyin", "true"]
        if side == "t":
            entries = tpreprocess.main(argv)
        else:
            _run_jax_main(jax_recipe.preprocess, argv)
        with open(os.path.join(out, "train.txt")) as f:
            outs[side] = f.read().split()
    assert outs["t"] == outs["j"] == entries
    assert len(entries) == (8 if mode == "english" else 2)
    _same_npy_dicts(str(tmp_path / "t"), str(tmp_path / "j"), entries)
    if mode == "english":
        # the alignment path trims the wav and takes the aligned phones;
        # the fallback pads the short duration array
        s = np.load(tmp_path / "t" / "LJ001-0000.npy", allow_pickle=True).item()
        assert s["duration"].sum() <= s["mel"].shape[0] and s["phonemes"].max() > 40
        s = np.load(tmp_path / "t" / "LJ001-0003.npy", allow_pickle=True).item()
        assert list(s["duration"][:5]) == [3, 0, 5, 2, 7] and not s["duration"][5:].any()


# ------------------------------------------------------------ evaluation


def test_evaluate_matches_the_jax_script(jax_recipe, corpus, tmp_path):
    argv = tconv.overrides(corpus.root, str(tmp_path / "ck"), 4, 2, 5e-4) + TOY
    jcfg = jconfig.get_config(YAML, argv)
    tcfg, _, _ = ttrain.parse_args(argv + ["--device", "cpu"])
    fs2, _ = jax_recipe.train.build_model(jcfg)
    shapes = jax.eval_shape(lambda *a: fs2.init(jax.random.PRNGKey(0), *a, 40),
                            jnp.zeros((1, 24), jnp.int32), jnp.ones((1,), jnp.int32))["params"]
    rng = np.random.default_rng(6)

    def leaf(path, a):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "embedding":
            return rng.standard_normal(a.shape).astype(np.float32)
        return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    # durations near the corpus's: log(d + 1) with d about 7
    params["variance_adaptor"]["duration_predictor"]["linear"]["bias"] = np.full(
        (1,), 2.0, np.float32)
    dev = corpus.dev[:3]
    os.makedirs(tmp_path / "j")
    want = jax_recipe.convergence_run.evaluate(jcfg, params, dev, corpus.root,
                                               str(tmp_path / "j"))
    # the port's evaluate reads a checkpoint's params, here the loss module's layout
    tparams = {f"model.{k}": v for k, v in convert_params(params).items()}
    got = tconv.evaluate(tcfg, tparams, dev, corpus.root, str(tmp_path / "t"),
                         torch.device("cpu"))
    assert set(got) == set(want)
    for key in ("held_out_utts", "duration_mae_frames", "duration_exact_rate",
                "pitch_mae_floor_hz", "energy_mae_floor"):
        assert got[key] == want[key], key
    for key in set(got) - {"held_out_utts", "duration_mae_frames", "duration_exact_rate"}:
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-3), key
    for name in ("mel_pred.npy", "mel_gt.npy"):
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


# ------------------------------------------------------------- end to end


def test_train_generate_end_to_end(ljspeech, tmp_path, capsys, monkeypatch):
    feature_dir = str(tmp_path / "features")
    shutil.copytree(os.path.join(ljspeech.feature_dir, "TextGrid"),
                    os.path.join(feature_dir, "TextGrid"))
    entries = tpreprocess.main(["--data.ljspeech_dir", ljspeech.lj,
                                "--data.feature_dir", feature_dir])
    assert len(entries) == 8
    ckpt_dir = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--data.feature_dir", feature_dir, "--data.batch_size", "4",
            "--data.max_mel_len", "600", "--train.max_steps", "4", "--train.log_every_steps",
            "1", "--train.save_every_steps", "2", "--train.ckpt_dir", ckpt_dir,
            "--optim.warmup_steps", "2"] + TOY
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    out = ttrain.main(argv)
    assert not torch.backends.cudnn.allow_tf32  # the recipe runs float32, as JAX's
    assert out["steps"] == 4 and sorted(out["losses"]) == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in out["losses"].values())
    assert tckpt.list_steps(ckpt_dir) == [2, 4]
    ckpt = tckpt.restore_checkpoint(ckpt_dir)
    assert int(ckpt["step"]) == 4 and all(k.startswith("model.") for k in ckpt["params"])
    for name, p in out["net"].named_parameters():
        assert torch.equal(ckpt["params"][name], p.detach())

    torch.backends.cudnn.allow_tf32 = True
    mel = tgenerate.main(["--text", "Dr. Smith paid 42 dollars.", "--output",
                          str(tmp_path / "en.npy")] + argv)
    assert not torch.backends.cudnn.allow_tf32
    assert mel.ndim == 2 and mel.shape[1] == 80 and 0 < mel.shape[0] <= 600
    assert np.isfinite(mel).all()
    np.testing.assert_array_equal(np.load(tmp_path / "en.npy"), mel)
    # the bare model's layout gives the same mel
    bare = str(tmp_path / "bare")
    tckpt.save_checkpoint(bare, {"params": {k[len("model."):]: v
                                            for k, v in ckpt["params"].items()}}, 4)
    mel_bare = tgenerate.main(["--text", "Dr. Smith paid 42 dollars.", "--output",
                               str(tmp_path / "bare.npy")] + argv + ["--train.ckpt_dir", bare])
    np.testing.assert_array_equal(mel_bare, mel)
    mel_zh = tgenerate.main(["--text", "ni3 hao3 zhong1 guo2", "--pinyin", "--output",
                             str(tmp_path / "zh.npy")] + argv)
    assert np.isfinite(mel_zh).all() and mel_zh.shape[1] == 80
    assert "-> " in capsys.readouterr().out
    # the vocoder leg: a toy WaveGrad over these 80 bins at hop 300, the
    # 1000-step schedule cut to its last 3 steps (CPU time)
    vocoder = _toy_vocoder(str(tmp_path / "wg"), 80)
    monkeypatch.setattr(tgenerate, "reverse_diffusion", functools.partial(
        twg.reverse_diffusion, betas=twg.default_noise_schedule()[:3]))
    mel = tgenerate.main(["--text", "Dr. Smith paid 42 dollars.", "--output",
                          str(tmp_path / "voc.npy"), "--wavegrad_ckpt", vocoder] + argv
                         + ["--data.hop_length", "300"])
    audio, sr = tio.read(str(tmp_path / "voc.wav"))
    assert sr == 22050 and len(audio) == mel.shape[0] * 300 and np.isfinite(audio).all()


def _toy_vocoder(directory, n_mels):
    """A WaveGrad checkpoint at channels 8-32 (hop 300), its weights halved
    so that an untrained net's samples stay finite."""
    wg = twg.WaveGrad(n_mels=n_mels, device="cpu", down_channels=(8, 8, 16, 32),
                      film_channels=(8, 8, 16, 32, 32), up_channels=(32, 32, 16, 8, 8))
    wg.reset_parameters(torch.Generator().manual_seed(0))
    params = {f"model.{k}": v.detach() * (0.5 if v.dim() == 3 else 1.0)
              for k, v in wg.named_parameters()}
    tckpt.save_checkpoint(directory, {"params": params}, 1)
    return directory


def test_convergence_run_end_to_end(corpus, tmp_path, monkeypatch):
    root = str(tmp_path / "c")
    shutil.copytree(corpus.root, root, ignore=shutil.ignore_patterns("ckpt*", "wavs"))
    out = str(tmp_path / "out")
    protocol = tconv.overrides  # the protocol's overrides, then toy widths
    monkeypatch.setattr(tconv, "overrides", lambda *a: protocol(*a) + TOY)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    results = tconv.main(["--steps", "3", "--batch", "4", "--device", "cpu", "--corpus_dir",
                          root, "--out", out, "--init-seed", "2"])
    assert results["held_out_utts"] == 32 and results["config"]["init_seed"] == 2
    assert results["config"]["cudnn_tf32"] is False  # float32, as the JAX run
    assert sorted(os.listdir(out)) == ["loss_curve_seed2.json", "mel_gt_seed2.npy",
                                       "mel_pred_seed2.npy", "results_seed2.json"]
    assert tckpt.list_steps(os.path.join(root, "ckpt_seed2")) == [1, 2, 3]  # every quarter
    # the end-to-end leg on the trained checkpoint, with a toy vocoder over
    # the corpus's 128 bins
    vocoder = _toy_vocoder(str(tmp_path / "wg"), 128)
    again = tconv.main(["--steps", "3", "--batch", "4", "--device", "cpu", "--corpus_dir", root,
                        "--out", out, "--init-seed", "2", "--skip_train", "--wavegrad_ckpt",
                        vocoder])
    assert set(again["e2e"]) == {"mel_l1_roundtrip", "mel_l1_noise_baseline"}
    assert np.isfinite(again["e2e"]["mel_l1_roundtrip"])
    assert {k: v for k, v in again.items() if k != "e2e"} == results
    assert "e2e_sample.wav" in os.listdir(out)


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the error path is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.parse_args([])
    with pytest.raises(RuntimeError, match="CUDA"):
        tgenerate.main(["--text", "a"])

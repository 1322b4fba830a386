"""Port parity for the WaveGrad recipe (``mindaudio_torch/recipes/wavegrad``)
against the JAX recipe (``examples/wavegrad``), on the CPU at toy widths
(channels 8-32, the default factors, so hop 300).

The JAX recipe's ``train`` and ``preprocess`` are loaded by name from their
directory, and its ``convergence_run`` from its file (it imports the
FastSpeech2 script as ``convergence_run``); all are removed from
``sys.modules`` (and their directories from ``sys.path``) afterwards.

- the YAML is the JAX recipe's, plus the port's ``model`` section (the JAX
  recipe's ``WaveGrad()`` defaults);
- ``crop_iterator`` yields the JAX recipe's arrays bit for bit over two
  epochs, with and without the feature cache, on a corpus with an
  utterance shorter than the crop;
- ``preprocess.main()`` on WAVs in LJSpeech's layout writes the JAX
  ``main()``'s features within 1e-6 and the same ``train.txt``;
- ``analyze_mel``, ``parse_loss_curve`` and the held-out batch equal the
  JAX script's;
- ``train.main()`` for 3 steps writes a checkpoint that ``reverse.main()``
  and ``convergence_run.main()`` read in both layouts, and
  ``convergence_run --root`` runs the whole protocol at a toy size (the
  1000-step schedule cut to its last 4 steps there: the sampler itself is
  held to JAX in ``tests/test_torch_wavegrad.py``);
- FastSpeech2's vocoder leg refuses a hop other than 300.
"""

import importlib
import importlib.util
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mindaudio_tpu.train import config as jconfig
from mindaudio_torch.data import io as tio
from mindaudio_torch.models import wavegrad as twg
from mindaudio_torch.recipes.fastspeech2 import generate as fs2_generate
from mindaudio_torch.recipes.fastspeech2 import synthetic
from mindaudio_torch.recipes.wavegrad import convergence_run as tconv
from mindaudio_torch.recipes.wavegrad import preprocess as tpreprocess
from mindaudio_torch.recipes.wavegrad import reverse as treverse
from mindaudio_torch.recipes.wavegrad import train as ttrain
from mindaudio_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_RECIPE = os.path.join(REPO, "examples", "wavegrad")
YAML = os.path.join(JAX_RECIPE, "wavegrad.yaml")
TOY = ["--model.down_channels", "[8,8,16,32]", "--model.film_channels", "[8,8,16,32,32]",
       "--model.up_channels", "[32,32,16,8,8]"]
NAMES = ("train", "preprocess", "convergence_run")


@pytest.fixture(scope="module")
def jax_recipe():
    saved_path = list(sys.path)
    saved = {n: sys.modules.pop(n, None) for n in NAMES}
    try:
        sys.path.insert(0, JAX_RECIPE)
        mods = {n: importlib.import_module(n) for n in ("train", "preprocess")}
        sys.modules.pop("train", None)
        spec = importlib.util.spec_from_file_location(
            "wavegrad_convergence_run", os.path.join(JAX_RECIPE, "convergence_run.py"))
        conv = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(conv)  # imports examples/fastspeech2's as convergence_run
        yield SimpleNamespace(convergence_run=conv, **mods)
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


def test_config_is_the_jax_recipes():
    argv = ["--optim.lr", "0.001", "--data.crop_frames", "12"]
    tcfg, device, seed = ttrain.parse_args(argv + ["--device", "cpu", "--init-seed", "3"])
    want = jconfig.get_config(YAML, argv).to_dict()
    got = tcfg.to_dict()
    assert got.pop("model") == {"up_factors": [5, 5, 3, 2, 2], "down_factors": [2, 2, 3, 5],
                                "down_channels": [128, 128, 256, 512],
                                "film_channels": [128, 128, 256, 512, 512],
                                "up_channels": [512, 512, 256, 128, 128]}
    assert got == want and (device, seed) == (torch.device("cpu"), 3)


# ------------------------------------------------------------ host side


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Five utterances of (audio, mel) at hop 300 and 8 mel bins, one of
    them (3 frames) shorter than the 5-frame crop."""
    root = str(tmp_path_factory.mktemp("wg_features"))
    rng = np.random.default_rng(0)
    names = []
    for i, frames in enumerate((3, 5, 9, 14, 22)):
        name = f"utt{i}"
        np.save(os.path.join(root, name + ".npy"),
                {"audio": rng.uniform(-1, 1, frames * 300).astype(np.float32),
                 "mel": rng.uniform(0, 1, (frames, 8)).astype(np.float32)})
        names.append(name)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n\n")
    return root


@pytest.mark.parametrize("cache", [False, True])
def test_crop_iterator_bit_for_bit(jax_recipe, features, cache):
    argv = ["--data.feature_dir", features, "--data.crop_frames", "5", "--data.n_mels", "8",
            "--data.cache_features", str(cache).lower()]
    got = list(ttrain.crop_iterator(ttrain.parse_args(argv + ["--device", "cpu"])[0], 2, 2,
                                    seed=4))
    want = list(jax_recipe.train.crop_iterator(jconfig.get_config(YAML, argv), 2, 2, seed=4))
    assert len(got) == len(want) == 4
    for (e1, b1), (e2, b2) in zip(got, want):
        assert e1 == e2 and set(b1) == set(b2) == {"mel", "audio"}
        for k in b1:
            assert b1[k].dtype == b2[k].dtype and b1[k].tobytes() == b2[k].tobytes()
    # the short utterance is zero-padded, not cropped
    short = np.load(os.path.join(features, "utt0.npy"), allow_pickle=True).item()
    rows = [b["mel"][i] for _, b in got for i in range(2)]
    padded = [r for r in rows if np.array_equal(r[:3], short["mel"])]
    assert padded and all((r[3:] == 0).all() for r in padded)


def test_preprocess_matches_the_jax_recipe(jax_recipe, tmp_path):
    lj, _ = synthetic.gen(str(tmp_path / "src"), n_utts=3, seed=1)
    argv = ["--data.ljspeech_dir", lj, "--data.n_mels", "80"]
    theirs, ours = str(tmp_path / "j"), str(tmp_path / "t")
    _run_jax_main(jax_recipe.preprocess, argv + ["--data.feature_dir", theirs])
    names = tpreprocess.main(argv + ["--data.feature_dir", ours])
    assert len(names) == 3
    for f in ("train.txt",):
        assert open(os.path.join(ours, f)).read() == open(os.path.join(theirs, f)).read()
    for name in names:
        a = np.load(os.path.join(ours, name + ".npy"), allow_pickle=True).item()
        b = np.load(os.path.join(theirs, name + ".npy"), allow_pickle=True).item()
        assert set(a) == set(b) == {"audio", "mel"}
        np.testing.assert_array_equal(a["audio"], b["audio"])
        assert a["mel"].dtype == b["mel"].dtype == np.float32
        assert a["mel"].shape == b["mel"].shape == (len(a["audio"]) // 300, 80)
        np.testing.assert_allclose(a["mel"], b["mel"], rtol=0, atol=1e-6)


def test_scoring_helpers_match_the_jax_script(jax_recipe, tmp_path):
    jconv = jax_recipe.convergence_run
    rng = np.random.default_rng(3)
    wav = (0.3 * rng.standard_normal(37 * 300 + 17)).astype(np.float32)
    np.testing.assert_array_equal(tconv.analyze_mel(wav, 37), jconv.analyze_mel(wav, 37))
    log = tmp_path / "train.log"
    log.write_text("2026 INFO wavegrad: params: 17.233M\n"
                   "2026 INFO wavegrad: epoch 0 step 100 loss 0.59036 0.11 s/step\n"
                   "noise\nepoch 3 step 200 loss 1.5 0.10 s/step\n")
    assert tconv.parse_loss_curve(str(log)) == jconv.parse_loss_curve(str(log)) == [
        {"step": 100, "loss": 0.59036}, {"step": 200, "loss": 1.5}]
    # the held-out batch: the JAX script's synthesis at seed 777, padded
    # with the silence level
    utts, mel_batch, _ = tconv.held_out(3, 777)
    want_rng = np.random.default_rng(777)
    for i, (n_frames, mel) in enumerate(utts):
        phones = want_rng.integers(1, 41, size=int(want_rng.integers(8, 17))).astype(np.int32)
        wav = jconv.synth_utterance(want_rng, phones)
        assert n_frames == len(wav) // 300
        np.testing.assert_array_equal(mel, jconv.analyze_mel(wav, n_frames))
        np.testing.assert_array_equal(mel_batch[i, :n_frames], mel)
        assert (mel_batch[i, n_frames:] == np.float32(jconv.fs2_mel_to_wavegrad(
            np.log(1e-5)))).all()


# ------------------------------------------------------------ end to end


def _short_schedule(monkeypatch):
    """The 1000-step schedule cut to its last 4 steps (CPU time)."""
    monkeypatch.setattr(tconv, "default_noise_schedule",
                        lambda: twg.default_noise_schedule()[:4])


def test_train_reverse_and_score_end_to_end(tmp_path, monkeypatch, capsys):
    lj, _ = synthetic.gen(str(tmp_path / "src"), n_utts=4, seed=1)
    feature_dir, ckpt_dir = str(tmp_path / "f"), str(tmp_path / "ckpt")
    tpreprocess.main(["--data.ljspeech_dir", lj, "--data.feature_dir", feature_dir])
    argv = ["--device", "cpu", "--data.feature_dir", feature_dir, "--data.batch_size", "2",
            "--data.crop_frames", "4", "--train.max_steps", "3", "--train.log_every_steps",
            "1", "--train.save_every_steps", "2", "--train.ckpt_dir", ckpt_dir,
            "--optim.warmup_steps", "2"] + TOY
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    out = ttrain.main(argv)
    assert not torch.backends.cudnn.allow_tf32  # float32, as the JAX recipe
    assert out["steps"] == 3 and sorted(out["losses"]) == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in out["losses"].values())
    assert tckpt.list_steps(ckpt_dir) == [2, 3]
    ckpt = tckpt.restore_checkpoint(ckpt_dir)
    assert int(ckpt["step"]) == 3 and all(k.startswith("model.") for k in ckpt["params"])
    for name, p in out["net"].named_parameters():
        assert torch.equal(ckpt["params"][name], p.detach())
    assert "epoch 1 step 3 loss " in capsys.readouterr().err

    # both layouts of the trained weights, scaled down so that an untrained
    # net's samples stay finite
    params = {k: v * 0.5 if v.dim() == 3 else v for k, v in ckpt["params"].items()}
    scoped, bare = str(tmp_path / "scoped"), str(tmp_path / "bare")
    tckpt.save_checkpoint(scoped, {"params": params, "step": ckpt["step"]}, 3)
    tckpt.save_checkpoint(bare, {"params": {k[len("model."):]: v
                                            for k, v in params.items()}}, 3)
    mel_file = os.path.join(feature_dir, "LJ001-0001.npy")
    frames = np.load(mel_file, allow_pickle=True).item()["mel"].shape[0]
    wavs = []
    for layout in (scoped, bare):
        wav = str(tmp_path / f"{os.path.basename(layout)}.wav")
        audio = treverse.main(["--mel", mel_file, "--output", wav, "--fast", "--device", "cpu",
                               "--train.ckpt_dir", layout] + TOY)
        assert audio.shape == (frames * 300,) and np.abs(audio).max() <= 1.0
        read, sr = tio.read(wav)
        assert sr == 22050 and len(read) == frames * 300
        wavs.append(audio)
    np.testing.assert_array_equal(wavs[0], wavs[1])
    # a raw (T, n_mels) array, the 1000-step schedule
    raw = str(tmp_path / "raw.npy")
    np.save(raw, np.random.default_rng(0).uniform(0, 1, (2, 128)).astype(np.float32))
    audio = treverse.main(["--mel", raw, "--output", str(tmp_path / "raw.wav"), "--device",
                           "cpu", "--train.ckpt_dir", scoped] + TOY)
    assert audio.shape == (600,) and np.isfinite(audio).all()

    _short_schedule(monkeypatch)
    results = [tconv.main(["--ckpt", layout, "--n_utts", "2", "--device", "cpu", "--out",
                           str(tmp_path / f"score_{i}")]) for i, layout in enumerate((scoped,
                                                                                      bare))]
    for key in ("mel_l1_1000step", "mel_l1_fast6", "mel_l1_noise_baseline"):
        assert np.isfinite(results[0][key]) and results[0][key] == results[1][key], key
    assert results[0]["held_out_utts"] == 2 and results[0]["config"]["seed"] == 777
    assert sorted(os.listdir(tmp_path / "score_0")) == [
        "results.json", "sample_1000step.wav", "sample_fast6.wav"]


def test_protocol_end_to_end(tmp_path, monkeypatch):
    _short_schedule(monkeypatch)
    root, out = str(tmp_path / "r"), str(tmp_path / "out")
    fs2_mel = os.path.join(REPO, "mindaudio_torch", "recipes", "fastspeech2",
                           "convergence_artifacts", "mel_pred.npy")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    results = tconv.main(["--root", root, "--utts", "4", "--steps", "3", "--init-seed", "2",
                          "--device", "cpu", "--n_utts", "2", "--cudnn-tf32", "--fs2_mel",
                          fs2_mel, "--out", out, "--data.batch_size", "2",
                          "--train.log_every_steps", "1"] + TOY)
    assert results["config"]["cudnn_tf32"] is True and results["config"]["init_seed"] == 2
    assert sorted(os.listdir(out)) == [
        "e2e_sample.wav", "e2e_seed2.json", "loss_curve_seed2.json", "results_seed2.json",
        "sample_1000step_seed2.wav", "sample_fast6_seed2.wav", "train_log_seed2.txt"]
    assert [p["step"] for p in tconv.parse_loss_curve(os.path.join(
        out, "train_log_seed2.txt"))] == [1, 2, 3]
    assert tckpt.list_steps(os.path.join(root, "ckpt_seed2")) == [3]
    assert len(os.listdir(os.path.join(root, "features"))) == 5  # 4 utterances and the list
    assert set(results["e2e"]) == {"mel_l1_roundtrip", "mel_l1_noise_baseline"}
    assert results["e2e"]["mel_l1_noise_baseline"] > 1.0
    torch.backends.cudnn.allow_tf32 = False


def test_fastspeech2_vocoder_leg_refuses_another_hop(tmp_path, monkeypatch):
    """The FastSpeech2 model and the vocoder must share hop 300 and the mel
    bins; the JAX recipe's check, before any sampling."""
    from mindaudio_torch.recipes.fastspeech2 import train as fs2_train

    fs2_argv = ["--device", "cpu", "--train.ckpt_dir", str(tmp_path / "fs2"),
                "--model.d_model", "32", "--model.head_num", "2", "--model.conv_filter", "64",
                "--model.encoder_layers", "1", "--model.decoder_layers", "1"]
    cfg, _, _ = fs2_train.parse_args(fs2_argv)
    _, net = fs2_train.build_model(cfg, torch.device("cpu"))
    tckpt.save_checkpoint(cfg.train.ckpt_dir, fs2_train.checkpoint_state(net, 1), 1)
    wg = twg.WaveGrad(n_mels=80, device="cpu", down_channels=(8, 8, 16, 32),
                      film_channels=(8, 8, 16, 32, 32), up_channels=(32, 32, 16, 8, 8))
    tckpt.save_checkpoint(str(tmp_path / "wg"), {"params": dict(wg.named_parameters())}, 1)
    called = []
    monkeypatch.setattr(fs2_generate, "reverse_diffusion", lambda *a, **k: called.append(1))
    with pytest.raises(SystemExit, match="vocoder mismatch"):  # the YAML's hop 256
        fs2_generate.main(["--text", "a b", "--output", str(tmp_path / "m.npy"),
                           "--wavegrad_ckpt", str(tmp_path / "wg")] + fs2_argv)
    with pytest.raises(SystemExit, match="128"):  # the vocoder's bins
        shutil.rmtree(tmp_path / "wg")
        wg128 = twg.WaveGrad(n_mels=128, device="cpu", down_channels=(8, 8, 16, 32),
                             film_channels=(8, 8, 16, 32, 32), up_channels=(32, 32, 16, 8, 8))
        tckpt.save_checkpoint(str(tmp_path / "wg"), {"params": dict(wg128.named_parameters())},
                              1)
        fs2_generate.main(["--text", "a b", "--output", str(tmp_path / "m.npy"),
                           "--wavegrad_ckpt", str(tmp_path / "wg"), "--data.hop_length",
                           "300"] + fs2_argv)
    assert not called


def test_data_parallel_is_refused(monkeypatch):
    """Data parallel runs (``test_torch_parallel_recipes2.py``) take a
    global batch the processes split evenly; another is refused before
    anything is built."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    cfg, _, _ = ttrain.parse_args(["--device", "cpu"])
    cfg.data["batch_size"] = 3
    with pytest.raises(ValueError, match="data parallel"):
        ttrain.train(cfg, torch.device("cpu"))


def test_entry_points_need_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the error path is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.parse_args([])
    np.save(tmp_path / "m.npy", np.zeros((2, 128), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        treverse.main(["--mel", str(tmp_path / "m.npy")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tconv.main(["--ckpt", str(tmp_path)])

"""The other recipes' ``main()`` data parallel on two gloo processes on the
CPU (toy widths, a few steps): DeepSpeech2, ECAPA-TDNN, Conv-TasNet, TasNet,
FastSpeech2 and WaveGrad. Both ranks log the global batch's loss, so they
must log the same; where neither the step nor the iterator draws at random
(DeepSpeech2), the first step's loss is the one-process run's on the same
global batch (1e-5 relative: the all-reduce sums in another order). The
others draw crops (the separation recipes, ECAPA-TDNN, WaveGrad) or
dropout from each rank's stream, as the JAX iterators do. Rank 0 writes the
checkpoints.

Also each iterator's rank slices against the JAX recipe's iterator at the
same rank and world size, and their rows tiling the one-process batch
where no row draws from a rank's own stream.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from mindaudio_torch.recipes.conv_tasnet import convergence_run as sep_conv
from mindaudio_torch.recipes.deepspeech2 import dataset as ds2_dataset
from mindaudio_torch.recipes.deepspeech2 import synthetic as ds2_synthetic
from mindaudio_torch.recipes.ecapa_tdnn import convergence_run as ecapa_conv
from mindaudio_torch.recipes.ecapa_tdnn import dataset as ecapa_dataset
from mindaudio_torch.recipes.fastspeech2 import dataset as fs2_dataset
from mindaudio_torch.recipes.fastspeech2 import preprocess as fs2_preprocess
from mindaudio_torch.recipes.fastspeech2 import synthetic as fs2_synthetic
from mindaudio_torch.recipes.wavegrad import preprocess as wg_preprocess
from mindaudio_torch.recipes.wavegrad import train as wg_train
from mindaudio_torch.train import checkpoint as tckpt
from torch_dist import run_ranks

torch.set_num_threads(1)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SEP_TOY = {"conv_tasnet": ["--model.enc_dim", "32", "--model.bottleneck", "8",
                           "--model.hidden", "16", "--model.num_blocks", "3",
                           "--model.num_repeats", "2"],
           "tasnet": ["--model.enc_dim", "32", "--model.hidden", "32",
                      "--model.num_layers", "2"]}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    ds2_train, _ = ds2_synthetic.gen(str(root / "ds2"), n_train=8, n_test=2, seed=2,
                                     train_frames=((30, 40),), test_frames=((30, 40),))
    ecapa_conv.make_corpus(str(root / "ecapa"), 4, n_train=4, n_enrol=1, n_test=1, seed=3)
    sep_conv.make_corpus(str(root / "sep"), n_utts=8, seconds=0.25, seed=3)
    lj, _ = fs2_synthetic.gen(str(root / "lj"), n_utts=8, seed=2)
    _, fs2_features = fs2_synthetic.gen(str(root / "lj_fs2"), n_utts=8, seed=2)
    fs2_preprocess.main(["--data.ljspeech_dir", os.path.join(str(root / "lj_fs2"), "LJSpeech-1.1")
                         if os.path.isdir(os.path.join(str(root / "lj_fs2"), "LJSpeech-1.1"))
                         else str(root / "lj_fs2"), "--data.feature_dir", fs2_features])
    wg_preprocess.main(["--data.ljspeech_dir", lj, "--data.feature_dir", str(root / "wg")])
    return {"ds2": ds2_train, "ecapa": str(root / "ecapa"), "sep": str(root / "sep"),
            "fs2": fs2_features, "wg": str(root / "wg")}


def _recipes(c, ckpt):
    """``{name: (module, argv, patches, deterministic first step)}``."""
    common = ["--device", "cpu", "--train.ckpt_dir", ckpt, "--train.log_every_steps", "1"]
    ecapa = c["ecapa"]
    return {
        "deepspeech2": ("mindaudio_torch.recipes.deepspeech2.train", common + [
            "--model.hidden_size", "32", "--model.num_rnn_layers", "2",
            "--data.train_manifest", c["ds2"], "--data.batch_size", "4",
            "--train.max_steps", "2", "--optim.epochs", "4"],
            [("mindaudio_torch.recipes.deepspeech2.dataset", "FRAME_BUCKETS", (40, 80))], True),
        "ecapa_tdnn": ("mindaudio_torch.recipes.ecapa_tdnn.train_speaker_embeddings", common + [
            "--model.channels", "[32,32,32,32,96]", "--model.emb_dim", "24",
            "--data.train_csv", f"{ecapa}/train.csv", "--data.enrol_csv", f"{ecapa}/enrol.csv",
            "--data.test_csv", f"{ecapa}/test.csv", "--data.veri_pairs",
            f"{ecapa}/veri_pairs.txt", "--data.batch_size", "4", "--data.seg_dur", "1.0",
            "--train.max_steps", "2", "--optim.cycle_steps", "2"], [], False),
        **{name: (f"mindaudio_torch.recipes.{name}.train", common + SEP_TOY[name] + [
            "--data.train_dir", f"{c['sep']}/tr", "--data.segment_seconds", "0.2",
            "--data.batch_size", "4", "--train.max_steps", "2"], [], False)
           for name in ("conv_tasnet", "tasnet")},
        "fastspeech2": ("mindaudio_torch.recipes.fastspeech2.train", common + [
            "--model.d_model", "32", "--model.head_num", "2", "--model.conv_filter", "64",
            "--model.encoder_layers", "2", "--model.decoder_layers", "2",
            "--data.feature_dir", c["fs2"], "--data.batch_size", "4", "--data.max_mel_len",
            "600", "--train.max_steps", "2", "--optim.warmup_steps", "2"], [], False),
        "wavegrad": ("mindaudio_torch.recipes.wavegrad.train", common + [
            "--model.down_channels", "[8,8,16,32]", "--model.film_channels",
            "[8,8,16,32,32]", "--model.up_channels", "[32,32,16,8,8]",
            "--data.feature_dir", c["wg"], "--data.batch_size", "2", "--data.crop_frames", "4",
            "--train.max_steps", "2", "--optim.warmup_steps", "2"], [], False),
    }


def _first_loss(out):
    first = out["losses"][min(out["losses"])]
    return first["loss"] if isinstance(first, dict) else first


@pytest.mark.parametrize("name", ["deepspeech2", "ecapa_tdnn", "conv_tasnet", "tasnet",
                                  "fastspeech2", "wavegrad"])
def test_recipe_trains_data_parallel(corpora, tmp_path, name):
    module, argv, patches, deterministic = _recipes(corpora, str(tmp_path / "ckpt"))[name]
    outs = run_ranks(2, "torch_parallel_cases", "recipe_case", (module, argv, patches),
                     timeout=300)
    assert outs[0]["steps"] == outs[1]["steps"] == 2
    assert outs[0]["losses"] == outs[1]["losses"]
    assert np.isfinite(_first_loss(outs[0]))
    assert tckpt.list_steps(str(tmp_path / "ckpt")) == [2]
    if deterministic:
        one = run_ranks(1, "torch_parallel_cases", "recipe_case",
                        (module, [a.replace("ckpt", "ckpt1") for a in argv], patches),
                        timeout=300)[0]
        np.testing.assert_allclose(_first_loss(outs[0]), _first_loss(one), rtol=1e-5)


def _jax_module(path, name):
    saved = sys.modules.get(name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = saved
    return mod


def _tile(batches_of_ranks, whole, keys):
    for parts, full in zip(zip(*batches_of_ranks), whole):
        for key in keys:
            np.testing.assert_array_equal(np.concatenate([p[1][key] for p in parts]),
                                          full[1][key], err_msg=key)


def test_deepspeech2_iterator_ranks(corpora, monkeypatch):
    jds = _jax_module(os.path.join(REPO, "examples/deepspeech2/dataset.py"), "dataset")
    monkeypatch.setattr(ds2_dataset, "FRAME_BUCKETS", (40, 80))
    monkeypatch.setattr(jds, "FRAME_BUCKETS", (40, 80))
    kw = dict(batch_size=4, epochs=2, seed=1)
    ranks = [list(ds2_dataset.batch_iterator(corpora["ds2"], rank=r, world_size=2, **kw))
             for r in range(2)]
    for r in range(2):
        want = list(jds.batch_iterator(corpora["ds2"], rank=r, world_size=2, **kw))
        for (e, got), (we, w) in zip(ranks[r], want):
            assert e == we and set(got) == set(w)
            for key in w:
                np.testing.assert_array_equal(got[key], w[key], err_msg=key)
    _tile(ranks, list(ds2_dataset.batch_iterator(corpora["ds2"], **kw)),
          ("wavs", "wav_lens", "labels", "label_lens"))


def test_ecapa_iterator_ranks(corpora):
    jds = _jax_module(os.path.join(REPO, "examples/ECAPA-TDNN/dataset.py"), "dataset")
    csv = f"{corpora['ecapa']}/train.csv"
    kw = dict(batch_size=4, seg_dur=1.0, epochs=2, seed=1)
    ranks = [list(ecapa_dataset.batch_iterator(csv, rank=r, world_size=2, **kw))
             for r in range(2)]
    for r in range(2):
        want = list(jds.batch_iterator(csv, rank=r, world_size=2, **kw))
        assert len(want) == len(ranks[r])
        for (e, got), (we, w) in zip(ranks[r], want):
            assert e == we
            for key in ("wavs", "labels"):
                np.testing.assert_array_equal(got[key], w[key], err_msg=key)
    # the crops draw from each rank's stream; the speakers tile the batch
    _tile(ranks, list(ecapa_dataset.batch_iterator(csv, **kw)), ("labels",))


def test_wavegrad_iterator_ranks(corpora):
    from mindaudio_tpu.train import config as jconfig

    jax_dir = os.path.join(REPO, "examples", "wavegrad")
    saved_path, saved = list(sys.path), {n: sys.modules.pop(n, None) for n in ("train",)}
    try:
        sys.path.insert(0, jax_dir)
        jtrain = importlib.import_module("train")
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("train", None)
        if saved["train"] is not None:
            sys.modules["train"] = saved["train"]
    argv = ["--data.feature_dir", corpora["wg"], "--data.crop_frames", "4"]
    cfg = wg_train.parse_args(argv + ["--device", "cpu"])[0]
    jcfg = jconfig.get_config(os.path.join(jax_dir, "wavegrad.yaml"), argv)
    for r in range(2):
        got = list(wg_train.crop_iterator(cfg, 2, 2, seed=1, rank=r, world_size=2))
        want = list(jtrain.crop_iterator(jcfg, 2, 2, seed=1, rank=r, world_size=2))
        assert len(got) == len(want) > 0
        for (e, g), (we, w) in zip(got, want):
            assert e == we and g["mel"].shape[0] == 1
            for key in ("mel", "audio"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_fastspeech2_iterator_ranks(corpora):
    kw = dict(batch_size=4, max_phoneme_len=64, max_mel_len=600, epochs=2, seed=1)
    ranks = [list(fs2_dataset.batch_iterator(corpora["fs2"], rank=r, world_size=2, **kw))
             for r in range(2)]
    _tile(ranks, list(fs2_dataset.batch_iterator(corpora["fs2"], **kw)),
          ("phonemes", "src_lens", "mel", "duration"))


def test_librimix_iterator_ranks(corpora):
    from mindaudio_tpu.data import librimix as jlibrimix
    from mindaudio_torch.data import librimix

    kw = dict(batch_size=4, segment_len=1600, epochs=2, seed=1)
    d = f"{corpora['sep']}/tr"
    ranks = [list(librimix.separation_batch_iterator(d, rank=r, world_size=2, **kw))
             for r in range(2)]
    for r in range(2):
        want = list(jlibrimix.separation_batch_iterator(d, rank=r, world_size=2, **kw))
        for (_, got), (_, w) in zip(ranks[r], want):
            for key in w:
                np.testing.assert_array_equal(got[key], w[key], err_msg=key)
    # the crops draw from each rank's stream; the lengths tile the batch
    _tile(ranks, list(librimix.separation_batch_iterator(d, **kw)), ("lengths",))

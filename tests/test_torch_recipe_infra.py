"""Port parity for the recipe's infrastructure: tokenizer, CMVN, config,
logger, error rates, WAV I/O, resampling, checkpoints and prefetch, each run
on the same seeded numpy inputs through the JAX package's module and the
port's (``mindaudio_torch.{utils,metric,data,train}``), mirroring the cases
of ``tests/test_train_infra.py``.

Everything here is host code in both packages, numpy on the one side and
numpy or torch on the other: results must be equal, bit for bit where both
compute in the same dtype (float64 averages of float32 or bf16 leaves are
cast back the same way on both sides).
"""

import importlib
import itertools
import logging
import os
import time

import numpy as np
import pytest
import torch
import yaml

from mindaudio_tpu.data import io as jio
from mindaudio_tpu.data.processing import resample as jresample
from mindaudio_tpu.train import checkpoint as jckpt
from mindaudio_tpu.train import config as jconfig
from mindaudio_tpu.train import log as jlog
from mindaudio_tpu.train import prefetch as jprefetch
from mindaudio_tpu.utils import cmvn as jcmvn
from mindaudio_tpu.utils import tokenizer as jtok
from mindaudio_torch.data import io as tio
from mindaudio_torch.data.processing import resample as tresample
from mindaudio_torch.metric import wer as twer
from mindaudio_torch.train import checkpoint as tckpt
from mindaudio_torch.train import config as tconfig
from mindaudio_torch.train import log as tlog
from mindaudio_torch.train import prefetch as tprefetch
from mindaudio_torch.utils import cmvn as tcmvn
from mindaudio_torch.utils import tokenizer as ttok

jwer = importlib.import_module("mindaudio_tpu.metric.wer")  # the package exports wer()

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CHARS = list("的一是不了人我在有他这中大来上国个到说们")


def _texts(seed, n=12):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(CHARS, size=rng.integers(1, 9))) + " " * int(rng.integers(0, 2))
            for _ in range(n)]


# ---------------------------------------------------------------- tokenizer


def test_tokenizer_matches_jax(tmp_path):
    texts = _texts(0)
    jt, tt = jtok.CharTokenizer.from_transcripts(texts), ttok.CharTokenizer.from_transcripts(texts)
    assert ttok.build_char_vocab(texts) == jtok.build_char_vocab(texts)
    assert tt.symbols == jt.symbols
    assert (tt.blank_id, tt.unk_id, tt.sos, tt.eos, tt.vocab_size) == (
        jt.blank_id, jt.unk_id, jt.sos, jt.eos, jt.vocab_size) == (0, 1, len(jt.symbols) - 1,
                                                                   len(jt.symbols) - 1,
                                                                   len(jt.symbols))
    probe = _texts(1) + ["§ 好", ""]  # unseen characters map to <unk>
    for text in probe:
        assert tt.encode(text) == jt.encode(text)
    ids = [0, 1, 2, 5, tt.eos, 3, 1]
    assert tt.decode(ids) == jt.decode(ids)

    # file round trip: the same bytes, and each package reads the other's
    tt.save(tmp_path / "t.txt")
    jt.save(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    t2, j2 = ttok.CharTokenizer.from_file(tmp_path / "j.txt"), jtok.CharTokenizer.from_file(
        str(tmp_path / "t.txt"))
    assert t2.symbols == j2.symbols == jt.symbols
    assert (t2.unk_id, t2.sos) == (j2.unk_id, j2.sos)


# ---------------------------------------------------------------- CMVN


@pytest.mark.parametrize("case", ["masked", "unmasked", "two_dim"])
def test_cmvn_matches_jax(tmp_path, case):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((4, 50, 8)) * 3.0 + 1.5
    feats[..., 2] = 7.0  # a constant dim: the variance floor
    lens = np.array([50, 30, 10, 45]) if case == "masked" else None
    if case == "two_dim":
        feats = feats[0]
    accs = []
    for mod in (jcmvn, tcmvn):
        acc = mod.CMVNAccumulator(8)
        acc.update(feats, lens)
        acc.update(feats[..., ::-1, :] * 0.5, lens)
        accs.append(acc)
    ja, ta = accs
    np.testing.assert_array_equal(ta.mean_stat, ja.mean_stat)
    np.testing.assert_array_equal(ta.var_stat, ja.var_stat)
    assert ta.frame_num == ja.frame_num
    for x, y in zip(ta.finalize(), ja.finalize()):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.float32

    jcmvn.save_cmvn(str(tmp_path / "j.json"), ja)
    tcmvn.save_cmvn(str(tmp_path / "t.json"), ta)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    for x, y in zip(tcmvn.load_cmvn(str(tmp_path / "j.json")),
                    jcmvn.load_cmvn(str(tmp_path / "t.json"))):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- config


CONFIG_CASES = {
    # name: (yaml dict, argv)
    "scalars": ({"optim": {"lr": 0.1, "epochs": 10}, "name": "base"},
                ["--optim.epochs", "3", "--optim.lr", "2e-3"]),
    "bool_override": ({"flag": True, "other": False}, ["--flag", "false", "--other", "yes"]),
    "float_over_int_null_and_string": (
        {"ctc_weight": 0, "resume": None, "name": "x", "ver": "1.9"},
        ["--ctc_weight", "0.3", "--resume", "5", "--ver", "2.0"]),
    "list_key": ({"data": {"frame_bucket_limit": [200, 400], "batch": 8}},
                 ["--data.frame_bucket_limit", "[227, 419]"]),
    "bare_scalar_over_list": ({"data": {"frame_bucket_limit": [200, 400]}},
                              ["--data.frame_bucket_limit", "227"]),
    # a flag whose key the YAML lacks is dropped, as the convergence run's
    # bucket flags are
    "unknown_key_dropped": ({"data": {"batch_factor": 1.34}},
                            ["--data.frame_bucket_limit", "227", "--data.batch_factor", "0.5"]),
}


@pytest.mark.parametrize("name", list(CONFIG_CASES))
def test_config_cli_matches_jax(tmp_path, name):
    tree, argv = CONFIG_CASES[name]
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(tree))
    got = tconfig.get_config(str(path), argv)
    want = jconfig.get_config(str(path), argv)
    assert got.to_dict() == want.to_dict()
    assert type(got).__name__ == "Config" and isinstance(got, dict)


def test_config_inheritance_matches_jax(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("optim:\n  lr: 0.1\n  epochs: 10\nname: base\n")
    child = tmp_path / "child.yaml"
    child.write_text("base_config: base.yaml\noptim:\n  lr: 0.2\n")
    got, want = tconfig.load_config(str(child)), jconfig.load_config(str(child))
    assert got.to_dict() == want.to_dict() == {"optim": {"lr": 0.2, "epochs": 10},
                                               "name": "base"}
    assert got.optim.epochs == 10
    got.optim = {"lr": 1.0}
    assert got.optim.lr == 1.0  # attribute writes wrap dicts
    with pytest.raises(AttributeError):
        got.missing


def test_recipe_yaml_is_the_jax_recipes():
    ours = tconfig.load_config(os.path.join(REPO, "mindaudio_torch/recipes/conformer/"
                                                  "conformer.yaml"))
    theirs = jconfig.load_config(os.path.join(REPO, "examples/conformer/conformer.yaml"))
    assert ours.to_dict() == theirs.to_dict()


# ---------------------------------------------------------------- logger


def test_logger_matches_jax(tmp_path):
    lines = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        log_dir = tmp_path / name
        logger = mod.get_logger(f"t_parity_{name}", log_dir=str(log_dir), rank=3,
                                stdout_ranks=())
        logger.info("step %d loss %.4f", 7, 1.25)
        for h in logger.handlers:
            h.flush()
        text = (log_dir / f"t_parity_{name}.log").read_text().strip()
        # drop the timestamp; keep "[rank 3] INFO <name>: message"
        lines[name] = text.split(" ", 2)[2].replace(f"t_parity_{name}", "NAME")
    assert lines["torch"] == lines["jax"] == "[rank 3] INFO NAME: step 7 loss 1.2500"
    assert tlog.process_rank() == 0  # no process group here


def test_print_log_matches_jax(tmp_path):
    """``print_log`` through a given logger, at a given level."""
    lines = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        log_dir = tmp_path / name
        logger = mod.get_logger(f"t_print_{name}", log_dir=str(log_dir), rank=0,
                                stdout_ranks=())
        mod.print_log("epoch 3 done", logger)
        mod.print_log("lr too high", logger, level=logging.WARNING)
        for h in logger.handlers:
            h.flush()
        text = (log_dir / f"t_print_{name}.log").read_text().strip().splitlines()
        lines[name] = [t.split(" ", 2)[2].replace(f"t_print_{name}", "NAME") for t in text]
    assert lines["torch"] == lines["jax"] == ["[rank 0] INFO NAME: epoch 3 done",
                                              "[rank 0] WARNING NAME: lr too high"]


def test_logger_reconfigures_on_explicit_args(tmp_path):
    first = tlog.get_logger("t_reconf_torch")  # defaults
    second = tlog.get_logger("t_reconf_torch", log_dir=str(tmp_path), rank=3, stdout_ranks=())
    assert second is first  # one logging.Logger per name, handlers replaced
    assert os.path.exists(os.path.join(str(tmp_path), "t_reconf_torch.log"))
    third = tlog.get_logger("t_reconf_torch")  # a default call keeps the configuration
    assert any(getattr(h, "baseFilename", "").startswith(str(tmp_path)) for h in third.handlers)


# ---------------------------------------------------------------- error rates


def test_error_rates_match_jax():
    rng = np.random.default_rng(5)
    refs = ["".join(rng.choice(CHARS[:6], size=rng.integers(0, 10))) for _ in range(20)]
    hyps = ["".join(rng.choice(CHARS[:6], size=rng.integers(0, 12))) for _ in range(20)]
    assert twer.cer(refs, hyps) == jwer.cer(refs, hyps)
    words_r = [r.split("一") for r in refs]
    words_h = [h.split("一") for h in hyps]
    assert twer.wer(words_r, words_h) == jwer.wer(words_r, words_h)
    assert twer.wer([1, 2, 3], [1, 3]) == jwer.wer([1, 2, 3], [1, 3]) == pytest.approx(1 / 3)
    assert twer.cer(["abc"], ["abc"]) == 0.0
    for mod in (twer, jwer):
        with pytest.raises(ValueError):
            mod.cer(["a", "b"], ["a"])


# ---------------------------------------------------------------- WAV I/O


def _wav_data(kind, rng):
    n = 4801
    x = rng.uniform(-0.9, 0.9, (n, 2) if kind == "stereo" else n)
    return {
        "int16": lambda: (x * 32767).astype(np.int16),
        "int32": lambda: (x * 2**31).astype(np.int32),
        "float32": lambda: x.astype(np.float32),
        "float64": lambda: x.astype(np.float64),
        "uint8": lambda: (x * 127 + 128).astype(np.uint8),
        "int24": lambda: (x * 2**31).astype(np.int32),
        "big_endian": lambda: (x * 32767).astype(np.int16),
        "stereo": lambda: (x * 32767).astype(np.int16),
    }[kind]()


@pytest.mark.parametrize("kind", ["int16", "int32", "float32", "float64", "uint8", "int24",
                                  "big_endian", "stereo"])
def test_wav_write_read_matches_jax(tmp_path, kind):
    data = _wav_data(kind, np.random.default_rng(6))
    path = str(tmp_path / "t.wav")
    if kind in ("int24", "big_endian"):
        # the port writes RIFF at the array's width only: these two files,
        # which the port must still read, come from the JAX writer
        kw = {"bits": 24} if kind == "int24" else {"big_endian": True}
        jio.write(path, data, 16000, **kw)
    else:
        tio.write(path, data, 16000)
        jio.write(str(tmp_path / "j.wav"), data, 16000)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert tio.info(path) == jio.info(path)
    for offset, duration in ((0.0, None), (0.05, 0.1), (0.29, 1.0), (-1.0, 0.01), (0.1, -1.0)):
        got, sr = tio.read(path, offset=offset, duration=duration)
        want, jsr = jio.read(path, offset=offset, duration=duration)
        assert sr == jsr == 16000 and got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:  # an open handle, rewound afterwards
        got, _ = tio.read(f)
        assert f.tell() == 0
    np.testing.assert_array_equal(got, jio.read(path)[0])


def test_wav_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\0\0\0\0WAVX")
    for mod in (tio, jio):
        with pytest.raises(ValueError):
            mod.read(str(bad))
        with pytest.raises(ValueError):
            mod.write(str(tmp_path / "c.wav"), np.zeros(4, np.complex64), 16000)


# ---------------------------------------------------------------- resample


@pytest.mark.parametrize("orig,new,res_type", [
    (16000, 8000, "fft"), (8000, 16000, "fft"),
    (14400, 16000, "fft"), (17600, 16000, "fft"),  # speed perturbation 0.9 and 1.1
    (16000, 16000, "fft"), (16000, 22050, "kaiser"), (44100, 16000, "kaiser"),
])
def test_resample_matches_jax(orig, new, res_type):
    x = np.random.default_rng(7).standard_normal((2, 1999)).astype(np.float32)
    got = tresample(x, orig, new, res_type=res_type)
    want = jresample(x, orig, new, res_type=res_type)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- checkpoints


def _jax_tree(step):
    return {"w": np.full((2, 3), float(step), np.float32)}


def _torch_tree(step):
    return {"w": torch.full((2, 3), float(step))}


@pytest.mark.parametrize("name,keep_max,keep_best,saves", [
    ("retention_and_best", 3, None, [(1, 5.0), (2, 3.0), (3, 4.0), (4, 2.0)]),
    # the best score lands early: recency alone would prune it
    ("prune_protects_best_scored_steps", 2, 2, [(1, 1.0), (2, 9.0), (3, 8.0), (4, 7.0)]),
    ("unscored_saves_between", 2, 1, [(1, 2.0), (2, None), (3, 3.0), (4, None), (5, 1.5)]),
])
def test_checkpoint_manager_matches_jax(tmp_path, name, keep_max, keep_best, saves):
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), keep_max=keep_max, keep_best=keep_best)
    tm = tckpt.CheckpointManager(str(tmp_path / "t"), keep_max=keep_max, keep_best=keep_best)
    for step, metric in saves:
        jm.save(_jax_tree(step), step, eval_metric=metric)
        tm.save(_torch_tree(step), step, eval_metric=metric)
    assert tckpt.list_steps(tm.directory) == jckpt.list_steps(jm.directory)
    assert tm.scores == jm.scores
    assert tckpt.load_scores(tm.directory) == jckpt.load_scores(jm.directory) == tm.scores
    for n in (1, 2):
        assert tm.best_steps(n) == jm.best_steps(n)
        np.testing.assert_array_equal(
            tckpt.average_checkpoints(tm.directory, tm.best_steps(n))["w"].numpy(),
            jm.average_best(n)["w"])
    assert os.path.exists(os.path.join(tm.directory, f"step_{saves[-1][0]}", tckpt.STATE_FILE))


def test_average_keeps_integer_leaves_and_averages_bf16(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(8)
    trees = []
    for step in (1, 2, 3):
        w = rng.standard_normal((4, 5)).astype(np.float32)
        mu = rng.standard_normal(7).astype(ml_dtypes.bfloat16)
        rng_state = rng.integers(0, 256, 16).astype(np.uint8)
        trees.append((step, w, mu, rng_state))
        jckpt.save_checkpoint(str(tmp_path / "j"), {
            "params": {"w": w}, "opt_state": {"count": np.asarray(step * 10, np.int32),
                                              "mu": {"w": mu}},
            "step": np.asarray(step * 10, np.int32), "rng": {"dropout": rng_state}}, step)
        tckpt.save_checkpoint(str(tmp_path / "t"), {
            "params": {"w": torch.from_numpy(w)},
            "opt_state": {"count": torch.tensor(step * 10, dtype=torch.int32),
                          "mu": {"w": torch.from_numpy(mu.astype(np.float32)).bfloat16()}},
            "step": torch.tensor(step * 10, dtype=torch.int32),
            "rng": {"dropout": torch.from_numpy(rng_state)}}, step)
    want = jckpt.average_checkpoints(str(tmp_path / "j"), [1, 2, 3])
    got = tckpt.average_checkpoints(str(tmp_path / "t"), [1, 2, 3])
    np.testing.assert_array_equal(got["params"]["w"].numpy(), want["params"]["w"])
    assert got["opt_state"]["mu"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["opt_state"]["mu"]["w"].float().numpy(),
                                  want["opt_state"]["mu"]["w"].astype(np.float32))
    # integer and bool leaves come from the last step, not averaged
    for key in ("step",):
        assert got[key].dtype == torch.int32 and int(got[key]) == int(want[key]) == 30
    assert int(got["opt_state"]["count"]) == int(want["opt_state"]["count"]) == 30
    assert got["rng"]["dropout"].dtype == torch.uint8
    np.testing.assert_array_equal(got["rng"]["dropout"].numpy(), want["rng"]["dropout"])


def test_scores_survive_a_restart(tmp_path):
    for mod, tree in ((jckpt, _jax_tree), (tckpt, _torch_tree)):
        d = str(tmp_path / mod.__name__.split(".")[0])
        m = mod.CheckpointManager(d, keep_max=5)
        for step, loss in [(100, 3.0), (200, 1.0), (300, 2.0)]:
            m.save(tree(step), step, eval_metric=loss)
        m2 = mod.CheckpointManager(d, keep_max=5)  # a new process sees the scores
        assert m2.best_steps(2) == [200, 300]
        assert mod.load_scores(d) == {100: 3.0, 200: 1.0, 300: 2.0}


def test_a_killed_save_leaves_no_step(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tckpt.save_checkpoint(d, _torch_tree(1), 1)

    def killed(obj, f, *a, **k):
        with open(f, "wb") as out:
            out.write(b"half a file")
        raise KeyboardInterrupt

    monkeypatch.setattr(tckpt.torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_checkpoint(d, _torch_tree(2), 2)
    assert tckpt.list_steps(d) == [1]  # the temporary directory matches no step
    assert sorted(os.listdir(d)) == ["step_1", f"step_2.tmp-{os.getpid()}"]
    monkeypatch.undo()
    tckpt.save_checkpoint(d, _torch_tree(2), 2)  # a later save replaces it
    assert tckpt.list_steps(d) == [1, 2] and sorted(os.listdir(d)) == ["step_1", "step_2"]
    assert float(tckpt.restore_checkpoint(d)["w"][0, 0]) == 2.0


def test_restore_loads_tensors_only(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "step_1"))
    torch.save({"w": torch.ones(2), "f": time.time}, os.path.join(d, "step_1", tckpt.STATE_FILE))
    with pytest.raises(Exception, match="[Ww]eights only"):
        tckpt.restore_checkpoint(d)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "empty"))


# ---------------------------------------------------------------- prefetch


@pytest.mark.parametrize("size", [1, 3])
def test_prefetch_order_and_transform_match_jax(size):
    items = list(np.random.default_rng(9).integers(0, 100, 20))
    got = list(tprefetch.prefetch(iter(items), size=size, transform=lambda x: x * 2))
    want = list(jprefetch.prefetch(iter(items), size=size, transform=lambda x: x * 2))
    assert got == want == [x * 2 for x in items]


@pytest.mark.parametrize("where", ["iterator", "transform"])
def test_prefetch_hands_the_worker_error_over(where):
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    def transform(x):
        if x == 2:
            raise ValueError("boom")
        return x

    for mod in (tprefetch, jprefetch):
        it = (mod.prefetch(gen(), size=2) if where == "iterator"
              else mod.prefetch(iter([1, 2, 3]), size=2, transform=transform))
        assert next(it) == 1
        with pytest.raises(ValueError, match="boom"):
            list(it)


def test_prefetch_early_abandon_stops_the_worker():
    produced = []

    def gen():
        for i in itertools.count():
            produced.append(i)
            yield i

    it = tprefetch.prefetch(gen(), size=2)
    assert next(it) == 0
    it.close()  # GeneratorExit must stop the producer
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.4)
    assert len(produced) == n, "producer kept running after abandon"

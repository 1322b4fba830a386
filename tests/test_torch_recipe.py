"""Port parity for the Conformer recipe (``mindaudio_torch/recipes/conformer``)
against the JAX recipe (``examples/conformer``), on the CPU at a toy size.

The JAX recipe's files are top-level modules (``dataset``, ``train``,
``compute_cmvn_stats``, ``predict``, ``convergence_run``); they are loaded by
path and removed from ``sys.modules`` (and their directory from
``sys.path``) afterwards. Their ``main()`` reads ``sys.argv``.

- ``gen`` of both packages writes the same WAVs and CSVs for the same seed;
- both ``batch_iterator``s yield equal batches (arrays and order) for the
  same seed, with and without speed perturbation, on one rank and on two;
- on the first batch, with the JAX parameters converted, dither 0, no
  SpecAugment and dropout off, the port recipe's eval step gives the JAX
  recipe's ``eval_step`` loss (its ``device_features`` then
  ``model.apply(..., deterministic=True)``), ``loss_att`` and ``loss_ctc``
  within ``LOSS_RTOL`` (float32 sums in another order, as in
  ``tests/test_torch_train.py``);
- both ``compute_cmvn_stats`` write the same statistics (float32 fbanks of
  both packages, summed in float64: rtol 1e-5), and both ``predict`` decode
  the same checkpoint (JAX parameters, converted for the port) to the same
  hypotheses, batched and streaming;
- ``train.main()`` on ``--device cpu`` (2 + 1 layers, d_model 32) trains with
  saves, a resumed ``main()`` continues at the global step and the schedule,
  and ``predict.main()`` decodes the best-2 average;
- ``--model.remat`` and ``--model.int8_ffn`` train and save, and their
  checkpoints load into the float model;
- (the parallel settings run in ``test_torch_parallel_recipes.py``);
- streaming decode (``decode.mode: streaming``) matches the JAX recipe's
  on a causal-conv model, and raises on a model without one.
"""

import importlib.util
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.train import config as jconfig
from mindaudio_torch.convert import convert_params
from mindaudio_torch.metric.wer import cer
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.recipes.conformer import compute_cmvn_stats, convergence_run, dataset
from mindaudio_torch.recipes.conformer import predict as tpredict
from mindaudio_torch.recipes.conformer import train as ttrain
from mindaudio_torch.scheduler.schedules import asr_warmup_lr
from mindaudio_torch.train import checkpoint as tckpt
from mindaudio_torch.train.optim import AdamW
from mindaudio_torch.train.state import make_train_step
from mindaudio_torch.utils.tokenizer import CharTokenizer

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_RECIPE = os.path.join(REPO, "examples", "conformer")
TOY = ["--model.d_model", "32", "--model.head_num", "2", "--model.ffn_dim", "64",
       "--model.num_encoder_layers", "2", "--model.num_decoder_layers", "1",
       "--optim.bf16", "false", "--data.batch_factor", "0.05"]  # B = 4 in the 227-frame bucket


@pytest.fixture(scope="module")
def jax_recipe():
    names = ("dataset", "train", "convergence_run", "compute_cmvn_stats", "predict")
    saved_path = list(sys.path)
    saved = {n: sys.modules.get(n) for n in names}
    try:
        mods = {}
        for name in names:
            spec = importlib.util.spec_from_file_location(name, os.path.join(JAX_RECIPE,
                                                                             f"{name}.py"))
            mods[name] = sys.modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])  # train.py imports `dataset` by name
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
    root = str(tmp_path_factory.mktemp("cipher"))
    convergence_run.gen(root, n_train=24, n_dev=8, n_test=8, seed=1)
    return root


def _args(root, steps, *extra):
    return convergence_run._args(root, steps) + TOY + list(extra)


def test_gen_writes_the_jax_corpus(jax_recipe, tmp_path):
    ours, theirs = tmp_path / "t", tmp_path / "j"
    convergence_run.gen(str(ours), n_train=5, n_dev=2, n_test=2, seed=3)
    jax_recipe.convergence_run.gen(str(theirs), n_train=5, n_dev=2, n_test=2, seed=3)
    wavs = sorted(os.listdir(ours / "wavs"))
    assert wavs == sorted(os.listdir(theirs / "wavs")) and len(wavs) == 9
    for name in wavs:
        assert (ours / "wavs" / name).read_bytes() == (theirs / "wavs" / name).read_bytes()
    for split in ("train", "dev", "test"):
        got = (ours / f"{split}.csv").read_text(encoding="utf-8").replace(str(ours), "ROOT")
        want = (theirs / f"{split}.csv").read_text(encoding="utf-8").replace(str(theirs), "ROOT")
        assert got == want
    assert convergence_run.VOCAB == jax_recipe.convergence_run.VOCAB
    assert convergence_run._args("R", 7) == jax_recipe.convergence_run._args("R", 7)


@pytest.mark.parametrize("speed_perturb,rank,world_size", [(False, 0, 1), (True, 0, 1),
                                                          (False, 1, 2)])
def test_batch_iterators_agree(jax_recipe, corpus, speed_perturb, rank, world_size):
    csv_path = f"{corpus}/train.csv"
    texts = [u.text for u in dataset.read_manifest(csv_path)]
    kw = dict(epochs=2, seed=5, rank=rank, world_size=world_size, speed_perturb=speed_perturb,
              max_label_len=10, frame_bucket_limit=[150, 227], batch_bucket_limit=[4, 6])
    ours = list(dataset.batch_iterator(csv_path, CharTokenizer.from_transcripts(texts), **kw))
    jtok = sys.modules["mindaudio_tpu.utils.tokenizer"].CharTokenizer.from_transcripts(texts)
    theirs = list(jax_recipe.dataset.batch_iterator(csv_path, jtok, **kw))
    assert len(ours) == len(theirs) > 4
    assert {f for _, f, _ in ours} == {150, 227}
    for (e, f, got), (je, jf, want) in zip(ours, theirs):
        assert (e, f) == (je, jf) and got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for _, frames, got in ours:  # each rank takes its block of rows of the batch
        assert got["wavs"].shape == ({150: 4, 227: 6}[frames] // world_size,
                                     frames * 160 + 400)
    sampler = dataset.BucketSampler(dataset.read_manifest(csv_path), [150, 227], [4, 6])
    want = jax_recipe.dataset.BucketSampler(jax_recipe.dataset.read_manifest(csv_path),
                                            [150, 227], [4, 6])
    assert len(sampler) == len(want)
    assert [(i, [u.utt_id for u in c]) for i, c in sampler] == [
        (i, [u.utt_id for u in c]) for i, c in want]


def _draw_params(shapes, seed=0):
    """Flax params drawn with numpy from their shapes (fan-in scaled, so the
    posteriors are not flat), without compiling an init."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        n = rng.standard_normal(s.shape)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * n).astype(np.float32)
        scale = 0.1 if len(s.shape) < 2 else 1.5 / np.sqrt(np.prod(s.shape[:-1]))
        return (scale * n).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_recipe_loss_matches_jax_eval_step(jax_recipe, corpus):
    argv = _args(corpus, 4, "--device", "cpu")
    compute_cmvn_stats.main(argv)  # both recipes read this file
    tcfg, device = ttrain.parse_args(argv)
    jcfg = jconfig.get_config(os.path.join(JAX_RECIPE, "conformer.yaml"), argv)
    assert tcfg.to_dict() == jcfg.to_dict()
    tok = ttrain.build_tokenizer(tcfg)
    loader = dict(speed_perturb=False, batch_factor=float(tcfg.data.batch_factor),
                  max_label_len=int(tcfg.data.max_label_len))
    _, _, batch = next(dataset.batch_iterator(tcfg.data.train_csv, tok, **loader))

    # the JAX recipe's eval_step: device_features without dither, then the
    # model in deterministic mode
    jmodel = jax_recipe.train.build_model(jcfg, tok.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    feats, feat_lens = jax_recipe.train.device_features(
        jcfg, jbatch["wavs"], jbatch["wav_lens"], jax.random.PRNGKey(0), train=False)
    jbatch.update(feats=feats, feat_lens=feat_lens)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jbatch))["params"]
    params = _draw_params(shapes)
    want_loss, want = jmodel.apply({"params": params}, jbatch, deterministic=True)

    model = ttrain.build_model(tcfg, tok.vocab_size, device).train()
    ttrain.load_params(model, convert_params(params))
    generators = {k: torch.Generator(device=device).manual_seed(0)
                  for k in ("dropout", "features")}
    model.set_dropout_generator(generators["dropout"])
    _, eval_step = ttrain.make_step(tcfg, model, ttrain.make_optimizer(tcfg, model), generators)
    to_device = ttrain.ToDevice(device)
    loss, got = eval_step(to_device.ready(to_device((0, 227, batch))[2]))
    assert model.training  # back in train() after the eval step
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for key in ("loss_att", "loss_ctc"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=LOSS_RTOL)


def _jax_main(module, argv):
    saved = sys.argv
    sys.argv = [module.__name__] + argv
    try:
        return module.main()
    finally:
        sys.argv = saved


def test_cmvn_stats_match_jax(jax_recipe, corpus, tmp_path):
    import json

    ours, theirs = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    compute_cmvn_stats.main(_args(corpus, 0, "--device", "cpu", "--data.cmvn_file", ours))
    _jax_main(jax_recipe.compute_cmvn_stats, _args(corpus, 0, "--data.cmvn_file", theirs))
    got, want = (json.load(open(p)) for p in (ours, theirs))
    assert got["frame_num"] == want["frame_num"] > 0
    for key in ("mean_stat", "var_stat"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


@pytest.mark.parametrize("mode", ["ctc_greedy", "attention_rescoring", "streaming"])
def test_predict_matches_jax(jax_recipe, corpus, tmp_path, mode):
    from mindaudio_tpu.train.checkpoint import save_checkpoint as jax_save

    argv = _args(corpus, 0, "--decode.mode", mode, "--decode.beam_size", "3",
                 "--decode.average_num", "1")
    if mode == "streaming":  # chunks of 16 subsampled frames, the cache capped at 32
        argv += ["--model.causal_conv", "true", "--decode.streaming_cache_size", "32"]
    if not os.path.exists(f"{corpus}/global_cmvn.json"):
        compute_cmvn_stats.main(argv + ["--device", "cpu"])
    cfg = jconfig.get_config(os.path.join(JAX_RECIPE, "conformer.yaml"), argv)
    tok = ttrain.build_tokenizer(cfg)
    jmodel = jax_recipe.train.build_model(cfg, tok.vocab_size)
    batch = {"feats": jnp.zeros((1, 40, 80)), "feat_lens": jnp.array([40]),
             "labels": jnp.ones((1, 2), jnp.int32), "label_lens": jnp.array([2]),
             "ys_in": jnp.ones((1, 3), jnp.int32), "ys_out": jnp.ones((1, 3), jnp.int32),
             "ys_lens": jnp.array([3])}
    params = _draw_params(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), batch))["params"], seed=4)
    jax_save(str(tmp_path / "j"), {"params": params}, 7)
    tckpt.save_checkpoint(str(tmp_path / "t"), {"params": convert_params(params)}, 7)
    results = {}
    for name, run in (("jax", lambda a: _jax_main(jax_recipe.predict, a)),
                      ("torch", lambda a: tpredict.main(a + ["--device", "cpu"]))):
        out = tmp_path / f"{name}.txt"
        score = run(argv + ["--train.ckpt_dir", str(tmp_path / name[0]),
                            "--decode.result_file", str(out)])
        results[name] = (score, out.read_text(encoding="utf-8"))
    assert results["torch"] == results["jax"]
    assert len(results["jax"][1].splitlines()) == 8


def test_train_resume_and_predict_on_the_cpu(corpus, tmp_path):
    extra = ["--device", "cpu", "--train.ckpt_dir", str(tmp_path / "ckpt"),
             "--train.log_every_steps", "2", "--train.save_every_steps", "2",
             "--decode.result_file", str(tmp_path / "result.txt"), "--decode.beam_size", "3"]
    if not os.path.exists(f"{corpus}/global_cmvn.json"):
        compute_cmvn_stats.main(_args(corpus, 4, *extra))
    first = ttrain.main(_args(corpus, 4, *extra))
    assert (first["start_step"], first["steps"], first["final_step"]) == (0, 4, 4)
    assert sorted(first["dev_losses"]) == [2, 4] and len(first["window_ms"]) == 1
    ckpt_dir = str(tmp_path / "ckpt")
    assert tckpt.list_steps(ckpt_dir) == [2, 4]

    second = ttrain.main(_args(corpus, 6, *extra, "--optim.lr", "0.004"))
    cfg, _ = ttrain.parse_args(_args(corpus, 6, *extra, "--optim.lr", "0.004"))
    assert (second["start_step"], second["steps"], second["final_step"]) == (4, 2, 6)
    # the Noam schedule continues at the global step, AdamW's count too
    assert second["first_lr"] == float(asr_warmup_lr(0.004, cfg.optim.warmup_steps)(4))
    assert tckpt.list_steps(ckpt_dir) == [2, 4, 6]
    assert sorted(tckpt.load_scores(ckpt_dir)) == [2, 4, 6]
    last, before = tckpt.restore_checkpoint(ckpt_dir), tckpt.restore_checkpoint(ckpt_dir, 4)
    assert int(last["step"]) == int(last["opt_state"]["count"]) == 6
    assert last["opt_state"]["mu"]["ctc_proj.weight"].dtype == torch.bfloat16  # mu_dtype
    assert not torch.equal(last["rng"]["dropout"], before["rng"]["dropout"])

    for mode in ("ctc_greedy", "attention_rescoring"):
        score = tpredict.main(_args(corpus, 0, *extra, "--decode.average_num", "2",
                                    "--decode.mode", mode))
        lines = (tmp_path / "result.txt").read_text(encoding="utf-8").splitlines()
        refs = {u.utt_id: "".join(u.text.split())
                for u in dataset.read_manifest(f"{corpus}/test.csv")}
        hyps = dict((line.split(" ") + [""])[:2] for line in lines)
        assert list(hyps) == list(refs)
        assert score == cer(list(refs.values()), list(hyps.values())) >= 0
    assert tpredict.select_steps(ckpt_dir, 2) == sorted(
        sorted(tckpt.load_scores(ckpt_dir), key=tckpt.load_scores(ckpt_dir).get)[:2])
    assert tpredict.select_steps(ckpt_dir, 1) == [6]
    assert tpredict.select_steps(ckpt_dir, 2, average_best=False) == [4, 6]


def test_resume_restores_params_and_adamw_moments(corpus, tmp_path, monkeypatch):
    """A resumed ``main()`` holds exactly the checkpoint's params, AdamW
    count/mu/nu and generator states before its first step."""
    ckpt_dir = str(tmp_path / "ckpt")
    argv = _args(corpus, 8, "--device", "cpu", "--train.ckpt_dir", ckpt_dir)
    if not os.path.exists(f"{corpus}/global_cmvn.json"):
        compute_cmvn_stats.main(argv)
    cfg, device = ttrain.parse_args(argv)
    model = ttrain.build_model(cfg, ttrain.build_tokenizer(cfg).vocab_size, device)
    optimizer = ttrain.make_optimizer(cfg, model)
    gens = {"dropout": torch.Generator().manual_seed(11),
            "features": torch.Generator().manual_seed(12)}
    g = torch.Generator().manual_seed(13)
    with torch.no_grad():  # a state no fresh model or optimizer can have
        for t in list(model.parameters()) + optimizer.mu + optimizer.nu:
            t.copy_(torch.rand(t.shape, generator=g))
        optimizer.count.fill_(3)
    for gen in gens.values():
        torch.rand(5, generator=gen)
    tckpt.save_checkpoint(ckpt_dir, ttrain.checkpoint_state(model, optimizer, gens, 3), 3)
    saved = tckpt.restore_checkpoint(ckpt_dir, 3)

    class Restored(Exception):
        pass

    real = ttrain.restore_state

    def check(ckpt, model, optimizer, generators):
        fresh = optimizer.state_dict()
        assert not any(torch.equal(fresh["mu"][n], saved["opt_state"]["mu"][n])
                       for n in fresh["mu"])
        assert real(ckpt, model, optimizer, generators) == 3
        for name, p in model.named_parameters():
            assert torch.equal(p, saved["params"][name]), name
        got = optimizer.state_dict()
        assert int(got["count"]) == 3
        for key in ("mu", "nu"):
            assert got[key].keys() == saved["opt_state"][key].keys()
            for name, t in got[key].items():
                want = saved["opt_state"][key][name]
                assert t.dtype == want.dtype and torch.equal(t, want), (key, name)
        for k, gen in generators.items():
            assert torch.equal(gen.get_state(), saved["rng"][k]), k
        raise Restored

    monkeypatch.setattr(ttrain, "restore_state", check)
    with pytest.raises(Restored):
        ttrain.main(argv + ["--train.resume", "true"])


def test_protocol_runs_the_stages_in_order(jax_recipe, tmp_path, monkeypatch):
    calls = []

    def run(cmd):
        calls.append(cmd)
        return SimpleNamespace(returncode=7 if len(calls) == 5 else 0)

    monkeypatch.setattr(convergence_run.subprocess, "run", run)
    root = str(tmp_path)
    (tmp_path / "test.csv").write_text("")  # gen has run: it is skipped
    with pytest.raises(SystemExit, match="exited 7"):
        convergence_run.protocol(root)
    stages = [c[3:4] + c[6:] for c in calls]
    assert all(c[:3] == [sys.executable, "-m", convergence_run.__name__] and c[4:6] ==
               ["--root", root] for c in calls)
    assert stages == convergence_run.PROTOCOL[1:6]
    # the two training phases are those the JAX recipe's docstring sets out
    jax_doc = " ".join(jax_recipe.convergence_run.__doc__.split())
    for stage in stages[:2]:
        assert " ".join(stage) in jax_doc
    assert [s[1:] for s in stages[2:]] == [["--avg", "1", "--mode", "ctc_greedy"],
                                           ["--avg", "1", "--mode", "attention_rescoring"],
                                           ["--avg", "5", "--mode", "ctc_greedy"]]


@pytest.mark.parametrize("flag", ["--model.remat", "--model.int8_ffn"])
def test_remat_and_int8_ffn_train_and_save(corpus, tmp_path, flag):
    """Both training knobs of the JAX recipe run through ``train.main()``:
    two steps and a save, the checkpoint loading into the float model of the
    default config unchanged (the same parameter names)."""
    from mindaudio_torch.models.layers import Int8Dense
    from mindaudio_torch.ops.quant import int8_training_matmul

    extra = ["--device", "cpu", "--train.ckpt_dir", str(tmp_path), "--train.save_every_steps",
             "2", "--train.log_every_steps", "1", flag, "true"]
    if not os.path.exists(f"{corpus}/global_cmvn.json"):
        compute_cmvn_stats.main(_args(corpus, 2, *extra))
    cfg, _ = ttrain.parse_args(_args(corpus, 2, *extra))
    model = ttrain.build_model(cfg, 30, "cpu")
    assert model.encoder.remat == (flag == "--model.remat")
    n_int8 = sum(isinstance(m, Int8Dense) for m in model.modules())
    assert n_int8 == (4 * cfg.model.num_encoder_layers + 1 if flag == "--model.int8_ffn" else 0)

    int8_training_matmul.fwd_launches = int8_training_matmul.bwd_launches = 0
    out = ttrain.main(_args(corpus, 2, *extra))
    assert (out["steps"], out["final_step"], sorted(out["dev_losses"])) == (2, 2, [2])
    assert np.isfinite(list(out["dev_losses"].values())).all()
    # per step one int8 product a W8A8 layer forward, two backward; one forward
    # a dev batch (the eval of the save)
    if flag == "--model.int8_ffn":
        assert int8_training_matmul.bwd_launches == 2 * 2 * n_int8
        assert int8_training_matmul.fwd_launches > 2 * n_int8
    else:
        assert int8_training_matmul.fwd_launches == int8_training_matmul.bwd_launches == 0
    assert tckpt.list_steps(str(tmp_path)) == [2]
    params = tckpt.restore_checkpoint(str(tmp_path))["params"]
    tok = CharTokenizer.from_file(cfg.data.vocab_file)
    plain, _ = ttrain.parse_args(_args(corpus, 0, "--device", "cpu"))
    ttrain.load_params(ttrain.build_model(plain, tok.vocab_size, "cpu"), params)


def test_streaming_decode_raises(corpus):
    """Streaming needs a causal conv module; the config's default has none."""
    with pytest.raises(ValueError, match="causal_conv"):
        tpredict.main(_args(corpus, 0, "--device", "cpu", "--decode.mode", "streaming"))


def test_to_device_on_the_cpu():
    batch = {"wavs": np.ones((2, 5), np.int16), "labels": np.ones((2, 3), np.int32)}
    move = ttrain.ToDevice(torch.device("cpu"))
    epoch, frames, staged = move((1, 227, batch))
    got = move.ready(staged)
    assert (epoch, frames) == (1, 227) and staged[1] is None
    assert got["wavs"].dtype == torch.int16 and got["labels"].dtype == torch.int64


def test_make_train_step_passes_the_chunk_generator():
    model = ASRModel(12, input_dim=8, d_model=16, head_num=2, ffn_dim=32, num_encoder_layers=1,
                     num_decoder_layers=1, use_dynamic_chunk=True, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    batch = {"feats": torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32)),
             "feat_lens": torch.tensor([40, 31]), "labels": torch.tensor([[3, 4], [5, 0]]),
             "label_lens": torch.tensor([2, 1]), "ys_in": torch.tensor([[11, 3, 4], [11, 5, 11]]),
             "ys_out": torch.tensor([[3, 4, 11], [5, 11, -1]]), "ys_lens": torch.tensor([3, 2])}
    chunks = torch.Generator().manual_seed(1)
    before = chunks.get_state()
    step = make_train_step(model, AdamW(model.named_parameters(), 1e-3),
                           loss_fn=lambda m, b: m(b, chunk_generator=chunks))
    assert torch.isfinite(step(batch)["loss"])
    assert not torch.equal(chunks.get_state(), before)  # the chunk size was drawn from it


def test_dropless_moe_trains_through_main(corpus, tmp_path):
    """``conformer_moe.yaml`` (U2++ MoE: every encoder FFN 8 experts, top 2,
    dropless, no Switch loss) trains two steps and a save through
    ``train.main()``; every routed frame is computed."""
    from mindaudio_torch.parallel.moe import MoEFeedForward
    from mindaudio_torch.train import profiler

    moe_yaml = os.path.join(REPO, "mindaudio_torch/recipes/conformer/conformer_moe.yaml")
    extra = ["--device", "cpu", "--train.ckpt_dir", str(tmp_path), "--train.save_every_steps",
             "2", "--train.log_every_steps", "1", "--config", moe_yaml]
    if not os.path.exists(f"{corpus}/global_cmvn.json"):
        compute_cmvn_stats.main(_args(corpus, 2, *extra))
    cfg, _ = ttrain.parse_args(_args(corpus, 2, *extra))
    model = ttrain.build_model(cfg, 30, "cpu")
    ffns = [m for m in model.modules() if isinstance(m, MoEFeedForward)]
    assert len(ffns) == 2 * cfg.model.num_encoder_layers
    assert all(m.dropless and m.num_experts == 8 for m in ffns)
    profiler.reset_moe_counts()
    out = ttrain.main(_args(corpus, 2, *extra))
    assert (out["steps"], out["final_step"]) == (2, 2)
    assert np.isfinite(out["losses"]).all() and np.isfinite(list(out["dev_losses"].values())).all()
    counts = profiler.moe_counts()
    assert counts["applications"] >= 2 * len(ffns) and counts["dropped"] == 0
    profiler.reset_moe_counts()

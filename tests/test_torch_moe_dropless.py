"""The dropless MoE of U2++ MoE (``parallel/moe.py`` with
``capacity_factor=None``, its experts run by ``ops/grouped_gemm``) against
the benchmark's plain reference (``portbench/reference/conformer_moe.py``)
on the CPU in float32: the layer, a whole MoE ``ASRModel`` step, the
reference's row blocks, the counters, the expert shares over ranks, the
grouped products' plain twin, the recipe's keys and the benchmark's toy
cell. Nothing here imports JAX."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from mindaudio_torch.models import conformer as tconf
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.models.layers import PositionwiseFeedForward, Swish
from mindaudio_torch.ops import grouped_gemm as gg
from mindaudio_torch.parallel.moe import MoEFeedForward
from mindaudio_torch.train import profiler
from portbench import weights
from portbench.harness import ROOT, Bench
from portbench.reference import conformer as ref
from portbench.reference.conformer_moe import MoE, ConformerMoE
from portbench.work import moe as work_moe

D, H, E = 16, 32, 4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(top_k=2, rate=0.1, seed=0):
    """The port's dropless layer and the reference's MoE on the same weights."""
    layer = MoEFeedForward(D, E, H, rate, top_k=top_k, capacity_factor=None,
                           activation=Swish())
    plain = MoE(D, H, E, top_k)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in plain.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
            dict(layer.named_parameters())[name].copy_(p)
    layer.dropout.generator = torch.Generator().manual_seed(seed)
    return layer.train(), plain


def _inputs(case, b=3, t=7, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, D, generator=gen)
    mask = torch.ones(b, t, dtype=torch.bool)
    if case == "padding":
        mask = torch.arange(t)[None] < torch.tensor([t, 4, 1])[:, None]
    else:
        x[..., 0] = 4.0  # a feature every frame shares, which the gate keys on
    return x, mask


def _route(plain, layer, case):
    """Bias the router through the shared feature: every frame to expert 2
    (``one_expert``), or never to expert 3 (``empty_expert``)."""
    with torch.no_grad():
        if case == "one_expert":
            plain.gate[0] = torch.tensor([-5.0, -5.0, 5.0, -5.0])
        elif case == "empty_expert":
            plain.gate[0, 3] = -20.0
        layer.gate.copy_(plain.gate)


def _run_both(layer, plain, x, mask, seed=5):
    layer.dropout.generator = torch.Generator().manual_seed(seed)
    xp, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    yp = layer(xp, mask)
    yr = plain(xr, mask, ref.Dropout(layer.dropout.rate, torch.Generator().manual_seed(seed),
                                     x.shape[0]))
    cot = torch.randn(yp.shape, generator=torch.Generator().manual_seed(9))
    gp = torch.autograd.grad(yp, [xp, *layer.parameters()], cot)
    gr = torch.autograd.grad(yr, [xr, *plain.parameters()], cot)
    return yp, yr, gp, gr


def _close(got, want, rel=1e-5, floor=0.0):
    """``got`` within ``rel`` of ``want``'s largest value (or ``floor``)."""
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), floor) or 1.0
    assert float((got - want).abs().max()) <= rel * scale, (got - want).abs().max()


@pytest.mark.parametrize("case,top_k", [("padding", 2), ("one_expert", 1),
                                        ("one_expert", 2), ("empty_expert", 2)])
def test_dropless_layer_matches_the_reference(case, top_k):
    """Forward and every gradient (input, router, both experts' matrices and
    biases) with the dropout on: padding rows (zero out, zero gradient),
    every frame on one expert, and an expert that receives nothing (its
    gradients zero)."""
    layer, plain = _pair(top_k)
    x, mask = _inputs(case)
    _route(plain, layer, case)
    yp, yr, gp, gr = _run_both(layer, plain, x, mask)
    _close(yp, yr)
    assert torch.equal(yp[~mask], torch.zeros_like(yp[~mask]))
    for got, want in zip(gp, gr):
        _close(got, want)
    if case == "empty_expert":
        named = dict(zip([n for n, _ in layer.named_parameters()], gp[1:]))
        for name in ("w1", "b1", "w2", "b2"):
            assert not named[name][3].any()
    if case == "padding":
        assert not gp[0][~mask].any()


def test_dropless_counts_every_assignment():
    profiler.reset_moe_counts()
    layer, _ = _pair()
    x, mask = _inputs("padding")
    layer(x, mask)
    layer(x, mask)
    counts = profiler.moe_counts()
    assert counts["applications"] == 2 and counts["dropped"] == 0
    assert len(counts["assigned"]) == E
    assert sum(counts["assigned"]) == 2 * 2 * int(mask.sum())
    profiler.reset_moe_counts()
    assert profiler.moe_counts() == {"applications": 0, "assigned": [], "dropped": 0}


def test_capacity_path_counts_its_drops():
    """The GShard path counts what its capacity drops; the dropless path on
    the same weights drops nothing."""
    profiler.reset_moe_counts()
    layer = MoEFeedForward(D, E, H, 0.0, top_k=2, capacity_factor=0.25)
    x, mask = _inputs("padding")
    layer(x, mask)
    counts = profiler.moe_counts()
    assert sum(counts["assigned"]) == 2 * int(mask.sum())
    assert counts["dropped"] > 0
    assert layer.aux_loss is not None
    profiler.reset_moe_counts()


def test_dropless_timeline_is_kept_under_a_profiler_only():
    profiler.reset_moe_counts()
    layer, _ = _pair()
    x, mask = _inputs("padding")
    layer(x, mask)
    assert profiler.moe_timeline() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        layer(x, mask)
        spans = {s[0] for s in profiler.timeline()}
    records = profiler.moe_timeline()
    assert len(records) == 1 and sum(records[0][1]) == 2 * int(mask.sum())
    assert {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"} <= spans
    profiler.reset_moe_counts()


def test_expert_shares_add_up_to_the_whole_layer():
    """Experts split over two shares, as over two ranks: each share's part
    (its experts' rows of every token, the others zero) sums to the whole
    layer's output, and under a loss linear in the output its experts'
    gradients are the whole layer's."""
    layer, _ = _pair(rate=0.0)
    x, mask = _inputs("padding")
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
    whole = layer(x, mask)
    want = torch.autograd.grad((whole * cot).sum(), [layer.w1, layer.b2])
    total = torch.zeros_like(whole)
    for first in (0, E // 2):
        part, _ = _pair(rate=0.0)
        part.first, part.local = first, E // 2
        for name in ("w1", "b1", "w2", "b2"):
            p = getattr(part, name)
            p.data = p.data[first:first + E // 2].clone()
        y = part(x, mask)
        total = total + y.detach()
        for got, full in zip(torch.autograd.grad((y * cot).sum(), [part.w1, part.b2]), want):
            _close(got, full[first:first + E // 2])
    _close(total, whole.detach())


def test_dropless_expert_parallel_over_gloo():
    """The dropless layer sharded over two ranks' ``model`` group (gloo):
    each rank runs its own experts' groups and one sum assembles the
    output, equal to the unsharded layer's, with the same gradients."""
    from torch_dist import run_ranks

    layer, _ = _pair(rate=0.0)
    x, mask = _inputs("padding")
    xg = x.clone().requires_grad_()
    y = layer(xg, mask)
    grads = torch.autograd.grad(y.square().mean(), [*layer.parameters(), xg])
    kwargs = dict(d_model=D, num_experts=E, hidden_units=H, dropout_rate=0.0, top_k=2,
                  capacity_factor=None, activation=Swish())
    outs = run_ranks(2, "torch_parallel_cases", "moe_dropless_case",
                     (layer.state_dict(), x, mask, kwargs, dict(model=2)))
    names = [n for n, _ in layer.named_parameters()]
    for out in outs:
        _close(out["y"], y.detach())
        _close(out["x_grad"], grads[-1])
        for name, g in zip(names, grads[:-1]):
            _close(out["grads"][name], g)


@pytest.mark.parametrize("sizes,trans_b", [((5, 0, 17, 1), False), ((0, 0, 23, 0), True),
                                           ((3, 4, 0, 130), False), ((0, 0, 0, 0), False)])
def test_grouped_gemm_plain_twin(sizes, trans_b):
    """The grouped products' CPU twin against a loop of ``torch.matmul`` in
    float64: empty groups, one group holding every row, sizes that are not
    tile multiples, rows after the last group left zero; the weight
    gradient and bias gradient per group (zero for an empty group)."""
    gen = torch.Generator().manual_seed(3)
    k, n, extra = 24, 40, 3
    offsets = torch.tensor([0, *torch.tensor(sizes).cumsum(0).tolist()])
    m = int(offsets[-1]) + extra
    a = torch.randn(m, k, generator=gen)
    b = torch.randn(len(sizes), *((n, k) if trans_b else (k, n)), generator=gen)
    bias = torch.randn(len(sizes), n, generator=gen)
    got = gg.grouped_gemm(a, b, offsets, trans_b=trans_b, bias=bias)
    want = torch.zeros(m, n, dtype=torch.float64)
    dy = torch.randn(m, n, generator=gen)
    dw, db = gg.grouped_gemm_wgrad(a, dy, offsets, bias_grad=True)
    for g, (lo, hi) in enumerate(zip(offsets[:-1].tolist(), offsets[1:].tolist())):
        bg = b[g].double().t() if trans_b else b[g].double()
        want[lo:hi] = a[lo:hi].double() @ bg + bias[g].double()
        _close(dw[g].double(), a[lo:hi].double().t() @ dy[lo:hi].double())
        _close(db[g].double(), dy[lo:hi].double().sum(0))
    _close(got.double(), want)
    assert not got[int(offsets[-1]):].any()


def test_expert_ffn_gradients_against_autograd():
    """The expert FFN's hand-written backward (its four products and the
    two epilogues) against autograd through the plain chain, dropout on."""
    gen = torch.Generator().manual_seed(4)
    offsets = torch.tensor([0, 3, 3, 10, 11])
    m = 13
    x = torch.randn(m, D, generator=gen)
    w1, b1 = torch.randn(4, D, H, generator=gen), torch.randn(4, H, generator=gen)
    w2, b2 = torch.randn(4, H, D, generator=gen), torch.randn(4, D, generator=gen)
    src = torch.randperm(m, generator=gen)
    bits = torch.randint(0, 256, (m, H), generator=gen, dtype=torch.uint8)
    leaves = [t.requires_grad_() for t in (x, w1, b1, w2, b2)]
    got = gg.expert_ffn(x, w1, b1, w2, b2, offsets, src, bits, 26, 256 / 230)
    cot = torch.randn(got.shape, generator=gen)
    want = torch.zeros_like(got)
    for g, (lo, hi) in enumerate(zip(offsets[:-1].tolist(), offsets[1:].tolist())):
        z = x[lo:hi] @ w1[g] + b1[g]
        h = torch.where(bits[src[lo:hi]] >= 26, z * torch.sigmoid(z) * (256 / 230), 0.0)
        want = want.index_put((torch.arange(lo, hi),), h @ w2[g] + b2[g])
    _close(got, want)
    for a, b in zip(torch.autograd.grad(got, leaves, cot), torch.autograd.grad(want, leaves, cot)):
        _close(a, b)


def _asr_cfg():
    return dict(vocab_size=30, input_dim=20, d_model=D, head_num=2, ffn_dim=H,
                num_encoder_layers=2, num_decoder_layers=1, kernel_size=5, dropout_rate=0.1,
                ctc_weight=0.3, lsm_weight=0.1)


def _asr_batch(b=4, t=41, seed=2):
    gen = torch.Generator().manual_seed(seed)
    lens = torch.tensor([41, 33, 27, 41])[:b]
    label_lens = torch.tensor([5, 3, 4, 2])[:b]
    labels = torch.randint(2, 29, (b, 5), generator=gen)
    ys_in = torch.full((b, 6), 29)
    ys_out = torch.full((b, 6), -1)
    for r, k in enumerate(label_lens.tolist()):
        ys_in[r, 1:1 + k], ys_out[r, :k], ys_out[r, k] = labels[r, :k], labels[r, :k], 29
    return {"feats": torch.randn(b, t, 20, generator=gen), "feat_lens": lens, "labels": labels,
            "label_lens": label_lens, "ys_in": ys_in, "ys_out": ys_out, "ys_lens": label_lens + 1}


def test_moe_asr_step_matches_the_reference():
    """A tiny MoE ``ASRModel`` (every encoder FFN dropless, top 2 of 4) on
    the reference's seeded weights and dropout bytes: the loss and every
    gradient leaf against ``ConformerMoE``; the reference run in blocks of
    rows equals it run whole."""
    cfg = _asr_cfg()
    moe = dict(moe_experts=E, moe_top_k=2, moe_capacity_factor=None, moe_macaron=True)
    plain = ConformerMoE(**cfg, **moe)
    model = ASRModel(**cfg, **moe, device="cpu").train()
    state = weights.make(plain.init_spec(), 11, "cpu")
    weights.load(plain, state)
    weights.load(model, state)
    batch = _asr_batch()
    model.set_dropout_generator(torch.Generator().manual_seed(7))
    loss, metrics = model(batch)
    assert "moe_aux_losses" not in metrics
    names = [n for n, _ in plain.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, [dict(model.named_parameters())[n]
                                                     for n in names])))

    def reference(blocks):
        drop = ref.Dropout(cfg["dropout_rate"], torch.Generator().manual_seed(7), 4)
        total, grads = 0.0, None
        for block in blocks:
            drop.start(block)
            part = plain.row_losses({k: v[block] for k, v in batch.items()}, drop).sum() / 4
            g = torch.autograd.grad(part, list(plain.parameters()))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            total += float(part.detach())
        return total, dict(zip(names, grads))

    whole, want = reference([slice(0, 4)])
    blocked, want_blocks = reference([slice(0, 1), slice(1, 3), slice(3, 4)])
    assert abs(float(loss) - whole) <= 1e-5 * abs(whole)
    assert abs(blocked - whole) <= 1e-6 * abs(whole)
    assert sum(".w1" in n for n in names) == 4  # both FFNs of both blocks
    # a leaf whose gradient vanishes (a key bias under the softmax) reads
    # rounding noise: each leaf is held to its own scale or a millionth of
    # the largest gradient's
    floor = 1e-2 * max(float(g.abs().max()) for g in want.values())
    for name in names:
        _close(got[name], want[name], 1e-4, floor)
        _close(want_blocks[name], want[name], 1e-5, floor)


def test_default_blocks_are_unchanged():
    """The default block keeps both FFNs dense; ``moe_experts`` alone makes
    the final FFN the GShard MoE with its Switch loss, as before."""
    dense = tconf.ConformerEncoderLayer(D, 2, H)
    assert isinstance(dense.feed_forward_macaron, PositionwiseFeedForward)
    assert isinstance(dense.feed_forward, PositionwiseFeedForward)
    assert not dense.moe_ff and not dense.moe_macaron
    moe = tconf.ConformerEncoderLayer(D, 2, H, dropout_rate=0.0, moe_experts=E)
    assert isinstance(moe.feed_forward_macaron, PositionwiseFeedForward)
    assert isinstance(moe.feed_forward, MoEFeedForward)
    assert moe.feed_forward.capacity_factor == 1.25 and moe.feed_forward.aux_loss is None
    x, mask = torch.randn(2, 5, D), torch.ones(2, 5, dtype=torch.bool)
    moe.feed_forward(x, mask)
    assert moe.feed_forward.aux_loss is not None
    with pytest.raises(ValueError, match="Swish"):
        MoEFeedForward(D, E, H, capacity_factor=None)


def test_recipe_builds_the_dropless_macaron_model():
    from mindaudio_torch.recipes.conformer import train as recipe

    cfg, _ = recipe.parse_args(["--device", "cpu", "--model.d_model", "16",
                                "--model.head_num", "2", "--model.ffn_dim", "32",
                                "--model.num_encoder_layers", "2",
                                "--model.num_decoder_layers", "1",
                                "--model.moe_experts", "4", "--model.moe_capacity_factor",
                                "null", "--model.moe_aux_weight", "0"])
    cfg.model["moe_macaron"] = True
    model = recipe.build_model(cfg, 30, torch.device("cpu"))
    for layer in model.encoder.layers:
        for ffn in (layer.feed_forward_macaron, layer.feed_forward):
            assert isinstance(ffn, MoEFeedForward) and ffn.dropless
    default, _ = recipe.parse_args(["--device", "cpu", "--model.moe_experts", "4",
                                    "--model.d_model", "16", "--model.head_num", "2",
                                    "--model.ffn_dim", "32", "--model.num_encoder_layers", "1",
                                    "--model.num_decoder_layers", "1"])
    layer = recipe.build_model(default, 30, torch.device("cpu")).encoder.layers[0]
    assert isinstance(layer.feed_forward_macaron, PositionwiseFeedForward)
    assert layer.feed_forward.capacity_factor == 1.25 and not layer.feed_forward.dropless


def test_switch_loss_is_computed_only_when_weighed():
    """The recipe's hybrid loss reads the MoE blocks' Switch losses only at
    a weight above 0: at 0 no block computes one (nothing is launched for
    it); at 0.01 each block computes its own once, from the routing of the
    same forward, and the loss carries it."""
    import types

    from mindaudio_torch.recipes.conformer.train import hybrid_loss

    cfg = _asr_cfg()
    moe = dict(moe_experts=E, moe_top_k=2, moe_capacity_factor=None, moe_macaron=True)
    model = ASRModel(**cfg, **moe, device="cpu").train()
    weights.load(model, weights.make(ConformerMoE(**cfg, **moe).init_spec(), 3, "cpu"))
    batch = _asr_batch()
    blocks = [m for m in model.modules() if isinstance(m, MoEFeedForward)]
    for weight in (0.0, 0.01):
        model.set_dropout_generator(torch.Generator().manual_seed(7))
        cfg_ns = types.SimpleNamespace(model={"moe_aux_weight": weight, "moe_experts": E})
        loss, metrics = hybrid_loss(cfg_ns)(model, batch)
        model.set_dropout_generator(torch.Generator().manual_seed(7))
        plain, _ = model(batch)
        if weight == 0:
            assert "moe_aux" not in metrics and float(loss) == float(plain)
            assert all(m._routing is not None and m._aux is None for m in blocks)
        else:
            aux = torch.stack([m.aux_loss for m in blocks]).mean()
            assert float(metrics["moe_aux"]) == float(aux) > 0
            assert abs(float(loss) - (float(plain) + weight * float(aux))) <= 1e-6 * float(loss)


# -- the benchmark's cell at toy widths, through portbench.run on the CPU -----

def _toy_tree(root):
    from portbench.tests.conftest import TRAIN_NUMBERS, load_json, write_json

    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load_json(ROOT / "BENCHMARK.json")
    pb = root / "portbench"
    conf = load_json(pb / "configs" / "conformer-moe-aishell.json")
    conf["model"].update(vocab_size=50, d_model=32, head_num=2, ffn_dim=64,
                         num_encoder_layers=2, num_decoder_layers=1, moe_experts=4)
    conf["recipe"]["optim"].update(bf16=False, mu_dtype="float32")
    write_json(pb / "configs" / "toy-conformer-moe.json", conf)
    cell = load_json(pb / "workloads" / "conformer-moe-train.json")
    cell["config"] = "toy-conformer-moe"
    cell["traffic"]["groups"] = [
        {"count": 8, "min_s": 1.5, "max_s": 2.28}, {"count": 6, "min_s": 2.31, "max_s": 4.2},
        {"count": 4, "min_s": 4.23, "max_s": 6.12}, {"count": 1, "min_s": 6.15, "max_s": 8.04},
        {"count": 1, "min_s": 8.07, "max_s": 10.27}]
    cell["recipe"]["data"]["batch_factor"] = 0.05
    cell["limits"] = dict(dict.fromkeys(TRAIN_NUMBERS, 1.0), **cell["limits"])
    write_json(pb / "workloads" / "toy-conformer-moe-train.json", cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "conformer-moe-train" in m.get("workloads", ()):
            m["workloads"].append("toy-conformer-moe-train")
    write_json(root / "BENCHMARK.json", bench)
    return root


@pytest.fixture(scope="module")
def toy_moe(tmp_path_factory):
    return _toy_tree(tmp_path_factory.mktemp("toy_moe"))


def _run_toy(root, seed, trace=0):
    """``(exit code, result line, standard error)`` of the toy cell run by
    ``portbench.run.main`` on the CPU in a process of its own (this one
    holds JAX, which the benchmark refuses)."""
    argv = ["--workload", "toy-conformer-moe-train", "--seed", str(seed), "--seconds", "0.5",
            "--trace", str(trace)]
    code = ("import sys; from portbench import run; "
            f"sys.exit(run.main({argv!r}, device='cpu', root={str(root)!r}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, (json.loads(lines[-1]) if lines else None), proc.stderr


def test_toy_cell_in_float32_equals_the_reference(toy_moe):
    """The cell's own run (set-up, window, the reference's three steps in
    row blocks) at toy widths in float32: program and reference agree to
    float32's rounding; a traced run reads its metrics without raising."""
    rc, result, err = _run_toy(toy_moe, 2**31 + 21)
    assert rc == 0, err
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"], checks
    assert max(checks[f"loss{k}_gap"] for k in (1, 2, 3)) < 1e-5, checks
    assert checks["grad_gap"] < 1e-3 and checks["change_gap"] < 1e-3, checks
    assert checks["logit_gap"] < 1e-5, checks
    assert set(result["metrics"]) == {"train_audio_s_per_s", "peak_mem_gib", "setup_s"}
    rc, result, err = _run_toy(toy_moe, 5, trace=1)
    assert rc == 0 and result["correct"], err


def test_cell_refuses_a_port_without_the_dropless_layer(toy_moe, monkeypatch):
    """On a port without the dropless layer (the commit before it) set-up
    raises before it makes a corpus, so the cell fails at once."""
    bench = Bench(toy_moe)
    cell = bench.cell("toy-conformer-moe-train")
    config = bench.config(cell["config"])
    fam = bench.family(config["family"])
    monkeypatch.delattr(MoEFeedForward, "dropless")
    with pytest.raises(RuntimeError, match="dropless"):
        fam.corpus(config, cell, 3, torch.device("cpu"))


def test_step_flops_count_the_routed_experts(toy_moe):
    """The family's FLOPs at a shape whose frames are all valid equal
    ``FlopCounterMode``'s count of the reference's own step, routed on the
    CPU: each frame's k experts and the router, not every expert."""
    from torch.utils.flop_counter import FlopCounterMode

    bench = Bench(toy_moe)
    config = bench.config("toy-conformer-moe")
    fam = bench.family(config["family"])
    rows, frames, labels = 2, 31, 4
    enc = ((frames - 1) // 2 - 1) // 2
    s = {"rows": rows, "frames": frames, "enc_frames": enc, "enc_valid": rows * enc,
         "labels": labels}
    model = fam.reference_model(config)
    feats = torch.randn(rows, frames, config["model"]["input_dim"])
    lens = torch.full((rows,), frames)
    ys = torch.zeros(rows, labels + 1, dtype=torch.long)
    drop = ref.Dropout(0.0, None, rows)
    counter = FlopCounterMode(display=False)
    with counter:
        enc_out, mask = model.encode(feats, lens, drop)
        dec = model.decode(enc_out, mask, ys, lens.new_full((rows,), labels + 1), drop)
        (model.ctc_proj(enc_out, ref.FLOAT32).sum() + dec.sum()).backward()
    assert fam.flops(config, s) == counter.get_total_flops()


def test_expert_products_bound():
    """Six products a MoE FFN over k x valid frames; at the cell's largest
    step (38,807 frames) a product is bound by bytes."""
    model = json.loads((ROOT / "portbench/configs/conformer-moe-aishell.json").read_text())["model"]
    rows = 2 * 38807
    one = work_moe.product_bound_s(rows, 256, 2048, 8)
    assert one == pytest.approx(2 * (rows * 256 + rows * 2048 + 8 * 256 * 2048) / 3.35e12)
    assert one > 2 * rows * 256 * 2048 / 989e12
    assert work_moe.step_bound_s(model, 38807) == pytest.approx(24 * 6 * one)

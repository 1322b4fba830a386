"""Port parity for W8A8 int8 training and rematerialized encoder blocks
(``ops.quant.int8_training_matmul``, ``models.layers.Int8Dense``,
``PositionwiseFeedForward(int8=True)``, ``ASRModel(int8_ffn=True)``,
``ConformerEncoder(remat=True)``) against the JAX package on the CPU.

Tolerances:
- the int8 operands are JAX's exactly, except where ``x / s`` lands on a
  rounding tie whose float32 quotient the two sides form differently; such
  mismatches are counted and bounded (none at these seeds). With equal
  operands the int32 accumulators are equal and the ``(sx ⊗ sw)`` epilogue
  is the same three float32 products, so the outputs agree to float32
  rounding (1e-6 of the largest);
- the backward is JAX's bf16 ``dot_general`` with a float32 result: JAX's
  own test holds it at rtol 1e-2, atol 1e-3 against the bf16 matmul; here it
  is also held within 1e-5 of the largest gradient against float64 sums of
  the bf16-rounded operands, which a bf16-rounded result (~4e-3) misses;
- the float32 model agrees with JAX's at the losses' 1e-4 (``test_torch_
  train.py``), the bf16 model (autocast against flax ``dtype=bfloat16``,
  whose casts differ) at 2e-2 relative;
- remat on against remat off is exact: the same losses, gradients and
  running statistics bit for bit, with dropout on.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.models import conformer as jconf
from mindaudio_tpu.models import layers as jl
from mindaudio_tpu.models.asr_model import ASRModel as JaxASR
from mindaudio_tpu.ops import quant as jquant
from mindaudio_tpu.utils.common import add_sos_eos
from mindaudio_torch.convert import convert_params
from mindaudio_torch.models import conformer as tconf
from mindaudio_torch.models import layers as tl
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.ops import quant as tquant

torch.set_num_threads(1)

VOCAB = 30
CFG = dict(vocab_size=VOCAB, input_dim=20, d_model=32, head_num=2, ffn_dim=64,
           num_encoder_layers=2, num_decoder_layers=1)


def _jax_operands(x2, w):
    """JAX's int8 operands and scales, the expressions of
    ``mindaudio_tpu.ops.quant._w8a8_apply``, under jit as there."""
    @jax.jit
    def ops(x2, w):
        xf = x2.astype(jnp.float32)
        sx = jnp.maximum(jnp.abs(xf).max(axis=1, keepdims=True), 1e-12) * (1 / 127.0)
        xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
        wf = w.astype(jnp.float32)
        sw = jnp.maximum(jnp.abs(wf).max(axis=0, keepdims=True), 1e-12) * (1 / 127.0)
        wq = jnp.clip(jnp.round(wf / sw), -127, 127).astype(jnp.int8)
        return xq, sx, wq, sw

    return [np.asarray(a) for a in ops(x2, w)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(28, 256, 128), (9, 64, 33)])
def test_forward_matches_jax(dtype, m, k, n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jx, np.float32), tx.float().numpy())

    xq, sx, wq, sw = _jax_operands(jx, jnp.asarray(w))
    txq, tsx, twq, tsw = tquant.w8a8_operands(tx, torch.from_numpy(w.T.copy()))
    mismatches = int((txq.numpy() != xq).sum() + (twq.numpy().T != wq).sum())
    assert mismatches <= 1e-3 * (xq.size + wq.size), mismatches
    assert mismatches == 0  # none at these seeds: the tie count is 0
    np.testing.assert_array_equal(tsx.numpy(), sx)
    np.testing.assert_array_equal(tsw.numpy(), sw[0])

    want = np.asarray(jquant.int8_training_matmul(jx, jnp.asarray(w)), np.float32)
    got = tquant.int8_training_matmul(tx, torch.from_numpy(w.T.copy()))
    assert got.dtype == tx.dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_backward_matches_jax_vjp():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal((64, 32))).astype(np.float32)
    g = rng.standard_normal((3, 16, 32)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(jquant.int8_training_matmul, jx, jnp.asarray(w))
    jdx, jdw = (np.asarray(a, np.float32) for a in vjp(jnp.asarray(g, jnp.bfloat16)))

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    tquant.int8_training_matmul(tx, tw).backward(torch.from_numpy(g).to(torch.bfloat16))
    dx, dw = tx.grad.float().numpy(), tw.grad.numpy().T
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    # JAX's own tolerance (tests/test_int8_training.py)
    np.testing.assert_allclose(dx, jdx, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(dw, jdw, rtol=1e-2, atol=1e-3)

    # dw is a float32 result of bf16-rounded operands, not rounded itself
    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64)

    exact = bf16(x).reshape(-1, 64).T @ bf16(g).reshape(-1, 32)
    tight = 1e-5 * np.abs(exact).max()
    np.testing.assert_allclose(dw, exact, rtol=0, atol=tight)
    np.testing.assert_allclose(jdw, exact, rtol=0, atol=tight)
    assert np.abs(bf16(dw) - exact).max() > tight  # a bf16 result would fail


def test_int_mm_operands_keep_the_product():
    """The padding that fits ``torch._int_mm``'s CUDA shape rules leaves the
    product's ``[:M, :N]`` as it was (the CPU's ``_int_mm`` multiplies)."""
    rng = np.random.default_rng(2)
    for m, k, n in [(5, 12, 33), (17, 8, 8), (64, 256, 4233)]:
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
        pa, pb = tquant.int_mm_operands(a, w.t())
        assert pa.shape[0] > 16 and pa.shape[1] % 8 == 0 and pb.shape[1] % 8 == 0
        assert pa.is_contiguous() and pb.t().is_contiguous()
        got = torch._int_mm(pa, pb)[:m, :n]
        assert torch.equal(got, a.long().mm(w.long().t()).int())
        assert torch.equal(tquant.int8_mm(a, w.t()), got)


def test_int8_dynamic_matmul_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal((64, 24))).astype(np.float32)
    values, scales = tquant.quantize_int8(torch.from_numpy(w))
    want = jquant.int8_dynamic_matmul(jnp.asarray(x), jnp.asarray(values.numpy()),
                                      jnp.asarray(scales.numpy()))
    got = tquant.int8_dynamic_matmul(torch.from_numpy(x), values, scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        n = rng.standard_normal(leaf.shape)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * n).astype(np.float32)
        scale = 0.1 if len(leaf.shape) < 2 else 1.5 / np.sqrt(np.prod(leaf.shape[:-1]))
        return (scale * n).astype(np.float32)

    return flax.core.unfreeze(jax.tree_util.tree_map_with_path(draw, shapes))


def test_int8_ffn_layer_matches_jax():
    """``PositionwiseFeedForward(int8=True)`` (two ``Int8Dense``) with the
    parameter names and layout of the float layer."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    jm = jl.PositionwiseFeedForward(64, int8=True)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"], 4)
    tm = tl.PositionwiseFeedForward(32, 64, int8=True)
    assert all(isinstance(m, tl.Int8Dense) for m in (tm.w_1, tm.w_2))
    tm.load_state_dict(convert_params(params), strict=True)
    tl.PositionwiseFeedForward(32, 64).load_state_dict(tm.state_dict(), strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _batch(seed=1, b=2, t=40, n=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, VOCAB - 1, (b, n)).astype(np.int32)
    label_lens = np.array([n, n - 1], np.int32)[:b]
    padded = np.where(np.arange(n)[None] < label_lens[:, None], labels, -1)
    ys_in, ys_out = add_sos_eos(padded, VOCAB - 1, VOCAB - 1)
    return {
        "feats": rng.standard_normal((b, t, 20)).astype(np.float32),
        "feat_lens": np.array([t, t - 9], np.int32)[:b],
        "labels": labels, "label_lens": label_lens,
        "ys_in": ys_in.astype(np.int32), "ys_out": ys_out.astype(np.int32),
        "ys_lens": label_lens + 1,
    }


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def asr_params():
    shapes = jax.eval_shape(JaxASR(**CFG).init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in _batch().items()})["params"]
    return _random_params(shapes, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_asr_model_matches_jax(asr_params, dtype):
    """``ASRModel(int8_ffn=True)`` on converted parameters, deterministic:
    the loss, its parts and the CTC log-probs. The float32 model computes as
    JAX's; the bf16 one runs under autocast against flax's
    ``dtype=bfloat16``."""
    batch = _batch()
    jm = JaxASR(**CFG, int8_ffn=True, ctc_impl="scan", dtype=getattr(jnp, dtype))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jm.apply({"params": asr_params}, jb)
    enc, mask = jm.apply({"params": asr_params}, jb["feats"], jb["feat_lens"],
                         method=jm.encode)
    want_lp = np.asarray(jm.apply({"params": asr_params}, enc, method=jm.ctc_log_probs),
                         np.float32)

    tm = ASRModel(**CFG, int8_ffn=True, ctc_impl="scan", device="cpu")
    tm.load_state_dict(convert_params(asr_params), strict=True)
    n_int8 = sum(isinstance(m, tl.Int8Dense) for m in tm.modules())
    assert n_int8 == 4 * CFG["num_encoder_layers"] + 1 and isinstance(tm.ctc_proj, tl.Int8Dense)
    tb = _to_torch(batch)
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16, enabled=dtype == "bfloat16"):
        got_loss, got = tm.eval()(tb)
        lp = tm.ctc_log_probs(tm.encode(tb["feats"], tb["feat_lens"])[0])
    valid = np.arange(want_lp.shape[1])[None] < np.asarray(mask)[:, 0].sum(-1)[:, None]
    if dtype == "float32":
        rtol, lp_atol = 1e-4, 1e-4
    else:
        rtol, lp_atol = 2e-2, 0.15
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=rtol)
    for key in ("loss_att", "loss_ctc"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=rtol)
    np.testing.assert_allclose(lp.float().numpy()[valid], want_lp[valid], rtol=0, atol=lp_atol)


def _train_model(remat, seed=3, **kw):
    model = ASRModel(**CFG, ctc_impl="scan", remat=remat, device="cpu", **kw)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    gen = torch.Generator().manual_seed(seed)
    model.set_dropout_generator(gen)
    return model, gen


def _loss_and_grads(model, batch):
    loss, _ = model(batch)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("int8_ffn", [False, True])
def test_remat_is_exact_with_dropout(int8_ffn):
    """Remat on and off, dropout on, the same generator seed: equal loss and
    gradients bit for bit, and the generator left at the same state (the
    recomputation draws the forward's masks again and leaves the stream as
    it found it)."""
    batch = _to_torch(_batch())
    (ref, ref_gen), (rm, rm_gen) = (_train_model(r, int8_ffn=int8_ffn) for r in (False, True))
    loss0, grads0 = _loss_and_grads(ref, batch)
    loss1, grads1 = _loss_and_grads(rm, batch)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))
    assert torch.equal(ref_gen.get_state(), rm_gen.get_state())


def test_plain_checkpoint_is_not_exact(monkeypatch):
    """The reason for ``remat_call``'s context: a plain non-reentrant
    ``torch.utils.checkpoint`` recomputes with fresh dropout masks (its
    ``preserve_rng_state`` covers only the default generators), so the
    gradients of the test above would differ."""
    from torch.utils.checkpoint import checkpoint

    def plain(module, *args, **kwargs):
        return checkpoint(module, *args, use_reentrant=False, **kwargs)

    monkeypatch.setattr(tconf, "remat_call", plain)
    batch = _to_torch(_batch())
    (ref, _), (rm, _) = (_train_model(r) for r in (False, True))
    loss0, grads0 = _loss_and_grads(ref, batch)
    loss1, grads1 = _loss_and_grads(rm, batch)
    assert torch.equal(loss0, loss1)
    assert not all(torch.equal(a, b) for a, b in zip(grads0, grads1))


ENC = dict(input_dim=20, d_model=16, head_num=2, ffn_dim=32, num_layers=2, kernel_size=5,
           dropout_rate=0.0, norm_type="batch_norm")


@pytest.mark.parametrize("remat", [False, True])
def test_batch_norm_encoder_matches_jax_once_a_step(remat):
    """``ConformerEncoder(norm_type="batch_norm")`` in training against JAX's
    (``nn.remat`` blocks when ``remat``): the output, the gradient of a
    fixed cotangent, and ``batch_stats`` moved once: the recomputation of a
    rematerialized block leaves the running statistics alone."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 37, 20)).astype(np.float32)
    lens = np.array([37, 25])
    jm = jconf.ConformerEncoder(**ENC, remat=remat)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(feats),
                               jnp.asarray(lens))
    params = _random_params(variables["params"], 6)
    stats = jax.tree_util.tree_map(
        lambda s: (0.5 + rng.random(s.shape)).astype(np.float32), variables["batch_stats"])
    cot = rng.standard_normal((2, 8, 16)).astype(np.float32)

    def jloss(p):
        (out, _), mutated = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(feats),
                                     jnp.asarray(lens), deterministic=False,
                                     mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mutated["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    tm = tconf.ConformerEncoder(**ENC, remat=remat)
    tm.load_state_dict(convert_params(params, stats), strict=True)
    tm.train()
    out, _ = tm(torch.from_numpy(feats), torch.from_numpy(lens))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    got_stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    want_stats = convert_params(params, jstats)
    assert len(got_stats) == 2 * ENC["num_layers"]
    for k, v in got_stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), rtol=1e-5, atol=1e-6)
    want_grads = convert_params(jax.tree_util.tree_map(np.asarray, jgrads))
    # the depthwise conv's bias feeds a batch norm, so its gradient is zero
    # up to rounding: the absolute limit is a share of the largest gradient
    scale = max(np.abs(g.numpy()).max() for g in want_grads.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-3,
                                   atol=1e-5 * scale)


def test_remat_moves_the_batch_norm_statistics_once():
    """Remat on and off on the port alone: bit-equal gradients and running
    statistics after one step, dropout on."""
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.standard_normal((2, 37, 20)).astype(np.float32))
    lens = torch.tensor([37, 25])
    kw = dict(ENC, dropout_rate=0.1)
    base = tconf.ConformerEncoder(**kw)
    with torch.no_grad():
        for p in base.parameters():
            p.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(8))
    results = []
    for remat in (False, True):
        enc = copy.deepcopy(base)
        enc.remat = remat
        enc.train()
        gen = torch.Generator().manual_seed(9)
        for m in enc.modules():
            if isinstance(m, tl.FastDropout):
                m.generator = gen
        out, _ = enc(feats, lens)
        grads = torch.autograd.grad(out.square().sum(), list(enc.parameters()))
        results.append((grads, [t.clone() for t in tl.running_stats(enc)]))
    (g0, s0), (g1, s1) = results
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert not torch.equal(s0[0], tl.running_stats(base)[0])  # they did move

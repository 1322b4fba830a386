"""The dispatch of the fused dropout (``models.layers.FastDropout``'s fused
forms, ``ops.fused_dropout``) and its counter, on the CPU.

On the CPU every form keeps PyTorch's plain chain, bit for bit, and counts
as plain. Where a test makes ``FastDropout.fusable`` hold on the CPU, the
fused forms run their autograd Functions with the kernels' launches replaced
by this file's own float32 reference of the kernels' arithmetic
(``csrc/fused_dropout.cu``): that holds the dispatch, the Functions' saved
state and gradients, and the counts to the plain chain here; the kernels
themselves are held to it on the card (``tests/test_torch_kernels.py``).
"""

import copy

import pytest
import torch
from torch.nn import functional as F

from mindaudio_torch.models import conformer as tconf
from mindaudio_torch.models import layers as tl
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.ops import fused_dropout as fd
from mindaudio_torch.train import profiler


def _dropout(rate=0.1, seed=3):
    return tl.FastDropout(rate, torch.Generator().manual_seed(seed)).train()


@pytest.fixture
def counts():
    profiler.reset_dropout_counts()
    yield profiler.dropout_counts
    profiler.reset_dropout_counts()


def _activation(v, act):
    if act == "swish":
        return v * torch.sigmoid(v)
    return torch.relu(v) if act == "relu" else v


def _activation_grad(v, act):
    if act == "swish":
        sg = torch.sigmoid(v)
        return sg * (1.0 + v * (1.0 - sg))
    return (~(v <= 0.0)).float() if act == "relu" else torch.ones_like(v)


def _reference_forward(y, bits, thresh, scale, act, x=None):
    """The forward kernel's arithmetic: float32, one rounding at the end."""
    d = torch.where(bits >= thresh, _activation(y.float(), fd.ACTS[act]) * scale, 0.0)
    dtype = y.dtype if x is None else torch.result_type(x, y)
    return (d if x is None else x.float() + d).to(dtype)


def _reference_backward(g, bits, thresh, scale, dtype, act, y=None):
    """The backward kernel's arithmetic: float32, one rounding at the end."""
    d = g.float() * scale
    if y is not None:
        d = d * _activation_grad(y.float(), fd.ACTS[act])
    return torch.where(bits >= thresh, d, 0.0).to(dtype)


@pytest.fixture
def emulated(monkeypatch):
    """The Functions' kernel launches replaced by the float32 reference."""
    monkeypatch.setattr(fd, "_forward", _reference_forward)
    monkeypatch.setattr(fd, "_backward", _reference_backward)


@pytest.fixture
def card(monkeypatch, emulated):
    """``fusable`` as on the card, whatever the device, and the launches
    emulated."""

    def fusable(self, *tensors):
        return (self.training and 0 < self._thresh() < 256
                and all(t.dtype in fd.DTYPES for t in tensors))

    monkeypatch.setattr(tl.FastDropout, "fusable", fusable)


FORMS = {
    "drop": (lambda d, x, y: d.drop(y), lambda d, x, y: d(y)),
    "swish": (lambda d, x, y: d.drop_activation(y, tl.Swish()), lambda d, x, y: d(y * torch.sigmoid(y))),
    "relu": (lambda d, x, y: d.drop_activation(y, F.relu), lambda d, x, y: d(F.relu(y))),
    "add": (lambda d, x, y: d.drop_add(x, y), lambda d, x, y: x + d(y)),
    "add_half": (lambda d, x, y: d.drop_add(x, y, 0.5), lambda d, x, y: x + 0.5 * d(y)),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_keeps_the_plain_chain(form, dtype, counts):
    """On the CPU each form is the present chain bit for bit, value and
    gradients, draws what it draws, and counts once as plain."""
    fused, plain = FORMS[form]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 37, generator=g).requires_grad_()
    y = torch.randn(5, 37, generator=g).to(dtype).requires_grad_()
    d1, d2 = _dropout(), _dropout()
    got = fused(d1, x, y)
    assert counts() == {"fused": 0, "plain": 1}
    want = plain(d2, x, y)
    assert got.dtype == want.dtype and torch.equal(got, want)
    cot = torch.randn(got.shape, generator=g).to(got.dtype)
    inputs = (x, y) if form.startswith("add") else (y,)
    for a, b in zip(torch.autograd.grad(got, inputs, cot), torch.autograd.grad(want, inputs, cot)):
        assert torch.equal(a, b)
    assert torch.equal(d1.generator.get_state(), d2.generator.get_state())


@pytest.mark.parametrize("form", sorted(FORMS))
def test_eval_and_rate_zero_are_the_identity_and_not_counted(form, counts, card):
    """Eval and rate 0 draw nothing and leave their input as it is, even
    where the fused kernels would take it; neither is counted."""
    fused, _ = FORMS[form]
    x, y = torch.randn(3, 8), torch.randn(3, 8)
    act = {"swish": tl.Swish(), "relu": F.relu}.get(form, lambda v: v)
    want = act(y) + (x if form.startswith("add") else 0)
    if form == "add_half":
        want = x + 0.5 * y
    for d in (_dropout().eval(), _dropout(rate=0.0)):
        state = d.generator.get_state()
        assert torch.equal(fused(d, x, y), want)
        assert torch.equal(d.generator.get_state(), state)
    assert counts() == {"fused": 0, "plain": 0}


def test_what_the_kernels_do_not_take_stays_plain(counts, card):
    """Where the kernels would run, an activation not listed, float64, rate
    1 and a residual of another shape keep the plain chain, counted plain;
    the listed forms count as fused."""
    d, h = _dropout(), torch.randn(4, 16)
    d.drop_activation(h, F.gelu)
    d.drop(h.double())
    assert torch.equal(_dropout(rate=1.0).drop(h), torch.zeros_like(h))
    d.drop_add(h, h[:1])
    assert counts() == {"fused": 0, "plain": 4}
    d.drop_activation(h, tl.Swish())
    d.drop_activation(h, F.relu)
    d.drop(h)
    d.drop_add(h, h.bfloat16(), 0.5)
    assert counts() == {"fused": 4, "plain": 4}
    profiler.reset_dropout_counts()
    assert counts() == {"fused": 0, "plain": 0}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fused_forms_match_the_chain_in_float32(form, counts, card):
    """Through the autograd Functions (the kernels' float32 arithmetic,
    emulated on the CPU) each form gives the chain's value and gradients in float32 to
    a few float32 roundings, on the same bytes, and counts as fused."""
    fused, plain = FORMS[form]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 129, generator=g).requires_grad_()
    y = (3 * torch.randn(6, 129, generator=g)).requires_grad_()
    d1, d2 = _dropout(), _dropout()
    got = fused(d1, x, y)
    assert counts() == {"fused": 1, "plain": 0}
    want = plain(d2, x, y)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    cot = torch.randn(got.shape, generator=g)
    inputs = (x, y) if form.startswith("add") else (y,)
    for a, b in zip(torch.autograd.grad(got, inputs, cot), torch.autograd.grad(want, inputs, cot)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert torch.equal(d1.generator.get_state(), d2.generator.get_state())


@pytest.mark.parametrize("x_dtype,y_dtype", [(torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.float16)])
def test_fused_add_types(x_dtype, y_dtype, card):
    """The residual add's output is ``torch.result_type(x, y)``; the
    gradient of ``x`` is the cotangent cast to ``x``'s type, that of ``y``
    in ``y``'s."""
    x = torch.randn(4, 10, dtype=x_dtype, requires_grad=True)
    y = torch.randn(4, 10, dtype=y_dtype, requires_grad=True)
    out = _dropout().drop_add(x, y, 0.5)
    assert out.dtype == torch.result_type(x, y)
    cot = torch.randn(4, 10, dtype=out.dtype)
    dx, dy = torch.autograd.grad(out, (x, y), cot)
    assert dx.dtype == x_dtype and torch.equal(dx, cot.to(x_dtype))
    assert dy.dtype == y_dtype


def test_launchers_refuse_what_the_kernels_do_not_take():
    y = torch.randn(3, 5)
    bits = torch.zeros(3, 5, dtype=torch.uint8)
    with pytest.raises(ValueError, match="thresh"):
        fd.fused_dropout_fwd(y, bits, 256, 1.0)
    with pytest.raises(ValueError, match="act"):
        fd.fused_dropout_fwd(y, bits, 26, 1.0, act="gelu")
    with pytest.raises(TypeError, match="uint8"):
        fd.fused_dropout_fwd(y, bits.bool(), 26, 1.0)
    with pytest.raises(TypeError, match="float32, bf16 or fp16"):
        fd.fused_dropout_fwd(y.double(), bits, 26, 1.0)
    with pytest.raises(ValueError, match="shape"):
        fd.fused_dropout_fwd(y, bits[:2], 26, 1.0)
    with pytest.raises(ValueError, match="activation"):
        fd.fused_dropout_fwd(y, bits, 26, 1.0, act="swish", x=y)
    with pytest.raises(ValueError, match="only there"):
        fd.fused_dropout_bwd(y, bits, 26, 1.0, torch.float32, act="swish")
    with pytest.raises(TypeError, match="pair"):
        fd.fused_dropout_bwd(y.bfloat16(), bits, 26, 1.0, torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        fd.fused_dropout_fwd(y, bits, 26, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fd.fused_dropout_bwd(y, bits, 26, 1.0, torch.float32)


def test_functions_launch_with_packed_codes(monkeypatch, counts):
    """The Functions' path to the kernels, with a stand-in library: each form
    launches once each way with the types and activation packed as the
    kernels read them (four bits each: y | (x + 1) << 4 | act << 8 forward,
    g | y << 4 | act << 8 backward), the threshold and the float32 scale,
    and counts its launches."""
    calls = []

    class Library:
        def fused_dropout_fwd_launch(self, *args):
            calls.append(("fwd",) + args[4:8])
            return 0

        def fused_dropout_bwd_launch(self, *args):
            calls.append(("bwd",) + args[4:8])
            return 0

    monkeypatch.setattr(fd, "_LIB", [Library()])
    monkeypatch.setattr(fd, "_stream", lambda index: 0)
    monkeypatch.setattr(tl.FastDropout, "fusable",
                        lambda self, *t: self.training and 0 < self._thresh() < 256)
    before = fd.fused_dropout_fwd.launches, fd.fused_dropout_bwd.launches
    d = _dropout()
    x = torch.randn(3, 8, requires_grad=True)
    h = torch.randn(3, 8, dtype=torch.bfloat16, requires_grad=True)
    one, half = fd.scale_of(26), fd.scale_of(26, 0.5)
    forms = [(lambda: d.drop_activation(h, tl.Swish()), (1 | 1 << 8, 1 | 1 << 4 | 1 << 8), one),
             (lambda: d.drop_activation(h, F.relu), (1 | 2 << 8, 1 | 1 << 4 | 2 << 8), one),
             (lambda: d.drop(h), (1, 1 | 1 << 4), one),
             (lambda: d.drop_add(x, h, 0.5), (1 | 1 << 4, 0 | 1 << 4), half)]
    for form, (fwd, bwd), scale in forms:
        calls.clear()
        out = form()
        torch.autograd.grad(out.float().sum(), [h])
        assert calls == [("fwd", 24, fwd, 26, scale), ("bwd", 24, bwd, 26, scale)]
    assert (fd.fused_dropout_fwd.launches, fd.fused_dropout_bwd.launches) == (
        before[0] + 4, before[1] + 4)
    assert counts() == {"fused": 4, "plain": 0}


def test_scale_is_the_plain_chains_float32_reciprocal():
    for thresh in (1, 26, 255):
        keep = 1.0 - thresh / 256.0
        inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(keep, dtype=torch.float32)
        assert fd.scale_of(thresh) == float(inv)
        assert fd.scale_of(thresh, 0.5) == float(inv) / 2


def _asr(seed=0):
    model = ASRModel(30, input_dim=20, d_model=32, head_num=2, ffn_dim=64,
                     num_encoder_layers=2, num_decoder_layers=2, kernel_size=5,
                     ctc_impl="scan", device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.train().set_dropout_generator(torch.Generator().manual_seed(1))


def _batch():
    g = torch.Generator().manual_seed(2)
    y = torch.randint(1, 29, (2, 5), generator=g)
    ys_in = torch.cat([torch.full((2, 1), 29), y], 1)
    ys_out = torch.cat([y, torch.full((2, 1), 29)], 1)
    ys_in[1, 4:], ys_out[1, 3], ys_out[1, 4:] = 29, 29, -1
    return {"feats": torch.randn(2, 41, 20, generator=g), "feat_lens": torch.tensor([41, 33]),
            "labels": y, "label_lens": torch.tensor([5, 3]), "ys_in": ys_in, "ys_out": ys_out,
            "ys_lens": torch.tensor([6, 4])}


# a training step's applications: the two position encodings, and two FFN
# activations and four residuals an encoder block, one FFN activation and
# three residuals a decoder block (two of each here)
STEP_APPLICATIONS = 2 + 2 * 6 + 2 * 4


def test_conformer_step_counts_plain_on_the_cpu(counts):
    loss, _ = _asr()(_batch())
    loss.backward()
    assert counts() == {"fused": 0, "plain": STEP_APPLICATIONS}


def test_conformer_step_through_the_fused_forms(counts, monkeypatch, emulated):
    """With ``fusable`` holding (as on the card), every application of the
    Conformer's training step that draws takes a fused form, none the plain
    chain, and the loss and gradients are the plain step's in float32."""
    batch = _batch()
    plain = _asr()
    loss0, _ = plain(batch)
    grads0 = torch.autograd.grad(loss0, list(plain.parameters()))
    profiler.reset_dropout_counts()
    monkeypatch.setattr(tl.FastDropout, "fusable",
                        lambda self, *t: self.training and 0 < self._thresh() < 256)
    fused = _asr()
    loss1, _ = fused(batch)
    grads1 = torch.autograd.grad(loss1, list(fused.parameters()))
    assert counts() == {"fused": STEP_APPLICATIONS, "plain": 0}
    torch.testing.assert_close(loss1, loss0, rtol=1e-5, atol=1e-6)
    for a, b in zip(grads1, grads0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_fused_remat_encoder_is_exact(card):
    """A rematerialized encoder through the fused forms gives the plain
    encoder's gradients and running statistics bit for bit: its
    recomputation draws the same bytes."""
    base = tconf.ConformerEncoder(input_dim=20, d_model=16, head_num=2, ffn_dim=32,
                                  num_layers=2, kernel_size=5, dropout_rate=0.1,
                                  norm_type="batch_norm")
    feats, lens = torch.randn(2, 37, 20, generator=torch.Generator().manual_seed(4)), \
        torch.tensor([37, 25])
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
        results.append((grads, [t.clone() for t in tl.running_stats(enc)], gen.get_state()))
    (g0, s0, r0), (g1, s1, r1) = results
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert torch.equal(r0, r1)

"""Port parity for the training slice: ``ASRModel.forward``'s hybrid loss,
``clip_by_global_norm``, ``skip_nonfinite_update``, AdamW with a bf16 first
moment, and three steps of both trainers from the same parameters and
moments, against the JAX package (flax + optax) on the same numpy inputs.

Toy size: 2 encoder layers, 1 decoder layer, d_model 32, vocab 30. Everything
deterministic runs in float32 with dropout, dither and SpecAugment off;
dropout, dynamic chunks and the stochastic train step are tested by their
invariants, because PyTorch cannot reproduce JAX's random streams.

Tolerances. Losses are float32 sums in another order on the two sides: 1e-4
relative, as the serving tests. One optimizer update from equal inputs agrees
to float32 rounding of the powers and quotients (rtol 1e-5). Over three steps
the Adam quotient ``m / (sqrt(v) + eps)`` passes the gradients' 1e-6
differences on, so parameters agree within 2e-5, with a float32 and with a
bf16 first moment (the port forms and rounds the bf16 moment exactly as optax
does, so no extra slack is needed there).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.models.asr_model import ASRModel as JaxASR
from mindaudio_tpu.scheduler.schedules import asr_warmup_lr as jax_warmup
from mindaudio_tpu.train import state as jstate
from mindaudio_tpu.utils.common import add_sos_eos
from mindaudio_torch.convert import convert_adamw_state, convert_params
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.models.layers import FastDropout
from mindaudio_torch.ops.specaugment import spec_augment
from mindaudio_torch.ops.spectral import kaldi_fbank
from mindaudio_torch.scheduler.schedules import asr_warmup_lr
from mindaudio_torch.train.optim import AdamW
from mindaudio_torch.train.state import (
    clip_by_global_norm,
    make_train_step,
    skip_nonfinite_update,
)
from mindaudio_torch.utils import mask as tmask

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
VOCAB = 30
CFG = dict(vocab_size=VOCAB, input_dim=20, d_model=32, head_num=2, ffn_dim=64,
           num_encoder_layers=2, num_decoder_layers=1)


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


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _draw_params(jm, seed=0):
    """Flax params drawn with numpy (fan-in-scaled, so the posteriors are not
    flat) from the shapes of ``jm.init``, without compiling an init."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), _to_jax(_batch()))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        n = rng.standard_normal(s.shape)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * n).astype(np.float32)
        scale = 0.1 if len(s.shape) < 2 else 1.5 / np.sqrt(np.prod(s.shape[:-1]))
        return (scale * n).astype(np.float32)

    return flax.core.unfreeze(jax.tree_util.tree_map_with_path(draw, shapes))


def _port_model(params, **kw):
    tm = ASRModel(**CFG, **kw, device="cpu")
    tm.load_state_dict(convert_params(params))
    return tm


@pytest.fixture(scope="module")
def params():
    return _draw_params(JaxASR(**CFG))


class TestHybridLoss:
    @pytest.mark.parametrize("ctc_weight,jax_impl", [(0.3, "pallas"), (0.3, "scan"),
                                                     (0.0, "scan"), (1.0, "scan")])
    def test_forward_matches_jax(self, params, ctc_weight, jax_impl):
        batch = _batch()
        jm = JaxASR(**CFG, ctc_weight=ctc_weight, ctc_impl=jax_impl)
        want_loss, want = jm.apply({"params": params}, _to_jax(batch))
        tm = _port_model(params, ctc_weight=ctc_weight).eval()
        with torch.no_grad():
            got_loss, got = tm(_to_torch(batch))
        assert set(got) == set(want) == {"loss_att", "loss_ctc", "acc_att"}
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=LOSS_RTOL)
        for key in ("loss_att", "loss_ctc"):
            np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=LOSS_RTOL)
        assert got["acc_att"].item() == pytest.approx(float(want["acc_att"]), abs=1e-6)
        assert got_loss.dtype == torch.float32

    def test_gradients_match_jax(self, params):
        batch = _batch(seed=2)
        jm = JaxASR(**CFG)
        want = convert_params(jax.grad(
            lambda p: jm.apply({"params": p}, _to_jax(batch))[0])(params))
        tm = _port_model(params).eval()
        loss, _ = tm(_to_torch(batch))
        names, ps = zip(*tm.named_parameters())
        for name, g in zip(names, torch.autograd.grad(loss, ps)):
            # float32 backward through two encoder blocks: ~1e-6 of the
            # largest entry of a leaf
            tol = 1e-4 * max(want[name].abs().max().item(), 1e-2)
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=tol, rtol=0,
                                       err_msg=name)

    def test_bf16_autocast_keeps_the_losses_in_float32(self, params):
        tm = _port_model(params).eval()
        with torch.no_grad():
            full, _ = tm(_to_torch(_batch()))
            with torch.autocast("cpu", dtype=torch.bfloat16):
                low, metrics = tm(_to_torch(_batch()))
        assert low.dtype == metrics["loss_ctc"].dtype == metrics["loss_att"].dtype == torch.float32
        # bf16 products (8 significant bits) through two blocks
        assert low.item() == pytest.approx(full.item(), rel=0.05)


class TestDropoutAndChunks:
    def test_set_dropout_generator_reaches_every_dropout(self, params):
        tm = _port_model(params).train()
        batch = _to_torch(_batch())
        with pytest.raises(RuntimeError, match="generator"):
            tm(batch)
        gen = torch.Generator().manual_seed(0)
        assert tm.set_dropout_generator(gen) is tm
        drops = [m for m in tm.modules() if isinstance(m, FastDropout)]
        assert len(drops) > 10 and all(m.generator is gen for m in drops)
        with torch.no_grad():
            first, _ = tm(batch)
            second, _ = tm(batch)
            gen.manual_seed(0)
            again, _ = tm(batch)
            calm, _ = tm.eval()(batch)
        assert first.item() != second.item()  # fresh masks on every call
        assert first.item() == again.item()  # the generator is the only source
        assert calm.item() not in (first.item(), second.item())

    def _chunk_of(self, cm):
        """Chunk size of a (T, T) chunk mask: the first row's visible keys."""
        return int(cm[0].sum())

    def test_dynamic_chunk_sampling(self):
        size = 60
        masks = tmask.make_non_pad_mask(torch.tensor([size, 41]), size)[:, None, :]
        gen = torch.Generator().manual_seed(0)
        chunks = []
        for _ in range(200):
            out = tmask.add_optional_chunk_mask(masks, True, False, 0, 0, -1, generator=gen)
            assert out.shape == (2, size, size)
            chunk = self._chunk_of(out[0])
            # exactly the chunk mask of that size, under the pad mask
            want = tmask.subsequent_chunk_mask(size, chunk)[None] & masks
            assert torch.equal(out, want)
            chunks.append(chunk)
        partial = [c for c in chunks if c != size]
        # draw in [1, 60]: full context when draw > 30, else draw % 25 + 1
        assert all(1 <= c <= 25 for c in partial)
        assert 70 <= len(partial) <= 130  # half of 200, standard deviation 7
        assert len(set(partial)) > 10

    def test_dynamic_left_chunks(self):
        size = 48
        masks = torch.ones(1, 1, size, dtype=torch.bool)
        gen = torch.Generator().manual_seed(1)
        lefts = set()
        for _ in range(200):
            out = tmask.add_optional_chunk_mask(masks, True, True, 0, 0, -1, generator=gen)[0]
            chunk = self._chunk_of(out)
            # the last row sees its own chunk and num_left whole chunks
            visible = int(out[-1].sum())
            own = size - (size - 1) // chunk * chunk
            num_left, rest = divmod(visible - own, chunk)
            assert rest == 0 and 0 <= num_left < max((size - 1) // chunk, 1)
            assert torch.equal(out, tmask.subsequent_chunk_mask(size, chunk, num_left))
            if chunk != size:
                lefts.add(num_left)
        assert len(lefts) > 3

    def test_chunk_generator_reaches_the_encoder(self, params):
        tm = _port_model(params, use_dynamic_chunk=True).eval()
        batch = _to_torch(_batch(t=120))
        with torch.no_grad():
            full, _ = tm(batch)  # no generator: full context
            seen = {tm(batch, chunk_generator=torch.Generator().manual_seed(s))[0].item()
                    for s in range(8)}
        # T' = 29: draws of 1..14 give a chunk below full context
        assert len(seen - {full.item()}) >= 2


class TestClipAndSkip:
    def _grads(self, seed=0):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal(s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]

    @pytest.mark.parametrize("max_norm", [0.5, 100.0])
    def test_clip_matches_jax(self, max_norm):
        grads = self._grads()
        want, want_norm = jstate.clip_by_global_norm([jnp.asarray(g) for g in grads], max_norm)
        got, got_norm = clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
        np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    @pytest.mark.parametrize("poison", [np.inf, np.nan])
    def test_clip_non_finite_norm_zeroes_the_scale(self, poison):
        grads = self._grads()
        grads[1][2] = poison
        want, want_norm = jstate.clip_by_global_norm([jnp.asarray(g) for g in grads], 5.0)
        got, got_norm = clip_by_global_norm([torch.from_numpy(g) for g in grads], 5.0)
        assert not np.isfinite(got_norm.item()) and not np.isfinite(float(want_norm))
        for g, w in zip(got, want):  # zeros, and NaN where 0 * inf
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(got[0], torch.zeros(3, 4)) and torch.isnan(got[1][2])

    def _optimizer(self):
        ps = [torch.nn.Parameter(torch.from_numpy(g)) for g in self._grads(seed=1)]
        opt = AdamW([(f"p{i}", p) for i, p in enumerate(ps)], 1e-2, weight_decay=1e-2,
                    mu_dtype=torch.bfloat16)
        opt.step([torch.from_numpy(g) for g in self._grads(seed=2)])  # non-zero moments
        return ps, opt

    @pytest.mark.parametrize("bad", ["nan_loss", "inf_loss", "inf_grad", "nan_grad",
                                     "clipped_inf_grad"])
    def test_skip_keeps_state_and_advances_the_step(self, bad):
        ps, opt = self._optimizer()
        before = [t.clone() for t in (*ps, *opt.mu, *opt.nu)]
        grads = [torch.from_numpy(g) for g in self._grads(seed=3)]
        loss = torch.tensor(1.0)
        if bad.endswith("loss"):
            loss = torch.tensor(float(bad[:3]))
        else:
            grads[2][1, 0, 1] = float("inf" if "inf" in bad else "nan")
        if bad == "clipped_inf_grad":
            grads, _ = clip_by_global_norm(grads, 5.0)
        ok = skip_nonfinite_update(opt, loss, grads)
        assert ok.dtype == torch.bool and not ok.item()
        # AdamW's count stays with the rest, as optax's does in the JAX
        # package (its recipes advance a global step of their own)
        assert opt.count.item() == 1
        for old, new in zip(before, (*ps, *opt.mu, *opt.nu)):
            assert torch.equal(old, new)

    def test_finite_batch_updates(self):
        ps, opt = self._optimizer()
        before = [p.detach().clone() for p in ps]
        ok = skip_nonfinite_update(opt, torch.tensor(1.0),
                                   [torch.from_numpy(g) for g in self._grads(seed=3)])
        assert ok.item() and opt.count.item() == 2
        assert all(not torch.equal(a, b) for a, b in zip(before, ps))


class TestAdamW:
    @pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
    def test_updates_match_optax(self, mu_dtype):
        """Four updates with a Noam schedule: every update from the same
        gradients, so the two sides differ by float32 rounding only (the bf16
        moment is rounded from equal float32 values up to that)."""
        rng = np.random.default_rng(0)
        shapes = {"a": (4, 6), "b": (6,), "c": (3, 2, 2)}
        p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        tx = optax.adamw(jax_warmup(1e-2, 3), weight_decay=1e-2, mu_dtype=getattr(jnp, mu_dtype))
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        jopt = tx.init(jp)
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
        opt = AdamW(tp.items(), asr_warmup_lr(1e-2, 3), weight_decay=1e-2,
                    mu_dtype=getattr(torch, mu_dtype))
        assert opt.mu[0].dtype == getattr(torch, mu_dtype) and opt.nu[0].dtype == torch.float32
        for _ in range(4):
            g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
            updates, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
            jp = optax.apply_updates(jp, updates)
            opt.step([torch.from_numpy(g[k]) for k in shapes])
            for k in shapes:
                np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                           rtol=1e-5, atol=1e-6)
        assert opt.count.item() == int(jopt[0].count) == 4
        for k, mu, nu in zip(shapes, opt.mu, opt.nu):
            np.testing.assert_allclose(nu.numpy(), np.asarray(jopt[0].nu[k]), rtol=1e-6)
            # equal up to one rounding of the stored dtype
            np.testing.assert_allclose(mu.float().numpy(),
                                       np.asarray(jopt[0].mu[k], dtype=np.float32),
                                       rtol=1e-6 if mu_dtype == "float32" else 2.0 ** -7)

    def test_weight_decay_reaches_every_parameter(self):
        p = torch.nn.Parameter(torch.ones(3))
        opt = AdamW([("bias", p)], 0.1, weight_decay=0.5)
        opt.step([torch.zeros(3)])
        # zero gradient: only the decoupled decay moves it, p - lr * wd * p
        np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1 * 0.5, rtol=1e-6)

    def test_state_dict_round_trip(self):
        p = torch.nn.Parameter(torch.randn(4, generator=torch.Generator().manual_seed(0)))
        opt = AdamW([("w", p)], 1e-2, mu_dtype=torch.bfloat16)
        opt.step([torch.ones(4)])
        other = AdamW([("w", torch.nn.Parameter(p.detach().clone()))], 1e-2,
                      mu_dtype=torch.bfloat16)
        other.load_state_dict(opt.state_dict())
        assert other.count.item() == 1
        assert torch.equal(other.mu[0], opt.mu[0]) and torch.equal(other.nu[0], opt.nu[0])
        with pytest.raises(KeyError):
            other.load_state_dict({"count": 0, "mu": {}, "nu": {}})


def _seed_moments(opt_state, seed, mu_dtype):
    """Non-zero moments drawn with numpy, count 3: a running optimizer. The
    second moment is kept well above the squared gradient noise of leaves
    whose true gradient is zero (a key bias under softmax), which Adam would
    otherwise normalize into updates of full size and random sign."""
    rng = np.random.default_rng(seed)
    adam = opt_state[0]
    mu = jax.tree_util.tree_map(
        lambda m: jnp.asarray(0.01 * rng.standard_normal(m.shape), mu_dtype), adam.mu)
    nu = jax.tree_util.tree_map(
        lambda v: jnp.asarray(1e-4 * (1.0 + rng.random(v.shape)), jnp.float32), adam.nu)
    count = jnp.asarray(3, jnp.int32)
    rest = tuple(s._replace(count=count) if "count" in s._fields else s for s in opt_state[1:])
    return (adam._replace(count=count, mu=mu, nu=nu), *rest)


class TestTrainStep:
    @pytest.mark.parametrize("mu_dtype,param_atol", [("float32", 2e-5), ("bfloat16", 2e-5)])
    def test_three_steps_match_the_jax_trainer(self, params, mu_dtype, param_atol):
        batches = [_batch(seed=s) for s in (3, 4, 5)]
        jm = JaxASR(**CFG)
        tx = optax.adamw(jax_warmup(2e-3, 5), weight_decay=1e-2, mu_dtype=getattr(jnp, mu_dtype))
        state = jstate.TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
        state = state.replace(step=3, opt_state=_seed_moments(state.opt_state, 9,
                                                              getattr(jnp, mu_dtype)))
        jstep = jstate.make_train_step(
            lambda p, st, batch, rng: jm.apply({"params": p}, batch),
            grad_clip_norm=5.0, donate=False)

        tm = _port_model(params).eval()  # dropout off, as deterministic=True
        opt = AdamW(tm.named_parameters(), asr_warmup_lr(2e-3, 5), weight_decay=1e-2,
                    mu_dtype=getattr(torch, mu_dtype))
        opt.load_state_dict(convert_adamw_state(state.opt_state))
        assert opt.count.item() == 3
        tstep = make_train_step(tm, opt, grad_clip_norm=5.0)

        for batch in batches:
            state, want = jstep(state, _to_jax(batch))
            got = tstep(_to_torch(batch))
            assert set(got) == set(want) == {"loss", "loss_att", "loss_ctc", "acc_att",
                                             "grad_norm"}
            for key in ("loss", "loss_att", "loss_ctc", "grad_norm"):
                np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=LOSS_RTOL,
                                           err_msg=key)
        assert opt.count.item() == int(state.opt_state[0].count) == 6
        want_params = convert_params(state.params)
        moved = 0.0
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                       atol=param_atol, rtol=0, err_msg=name)
            moved = max(moved, (p.detach() - convert_params(params)[name]).abs().max().item())
        assert moved > 20 * param_atol  # the steps moved the parameters far more
        want_nu = convert_params(state.opt_state[0].nu)
        for name, nu in zip(opt.names, opt.nu):
            np.testing.assert_allclose(nu.numpy(), want_nu[name].numpy(), rtol=1e-3, atol=1e-9,
                                       err_msg=name)

    def test_stochastic_step_from_waveforms(self, params):
        """The train step as the bench builds it, at toy size on the CPU:
        dither, SpecAugment, dropout, bf16 autocast, clip, skip, AdamW with a
        bf16 first moment, one batch repeated."""
        rng = np.random.default_rng(0)
        batch = {k: v for k, v in _to_torch(_batch()).items() if k not in ("feats", "feat_lens")}
        batch["wavs"] = torch.from_numpy((0.1 * rng.standard_normal((2, 6800))).astype(np.float32))
        batch["wav_lens"] = torch.tensor([6800, 5000])
        gen = torch.Generator().manual_seed(0)

        def features(b):
            feats = kaldi_fbank(b["wavs"], num_mel_bins=20, dither=0.1, generator=gen,
                                device="cpu")
            return (spec_augment(feats, max_t=5, max_f=3, generator=gen),
                    1 + (b["wav_lens"] - 400) // 160)

        tm = _port_model(params).train().set_dropout_generator(gen)
        start = [p.detach().clone() for p in tm.parameters()]
        opt = AdamW(tm.named_parameters(), 2e-3, weight_decay=1e-2, mu_dtype=torch.bfloat16)
        step = make_train_step(tm, opt, features, grad_clip_norm=5.0,
                               autocast_dtype=torch.bfloat16)
        losses = [step(batch)["loss"].item() for _ in range(8)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(not torch.equal(a, b) for a, b in zip(start, tm.parameters()))
        assert opt.count.item() == 8

        # a poisoned batch: nothing moves, AdamW's count included
        before = [t.clone() for t in (*tm.parameters(), *opt.mu, *opt.nu)]
        bad = dict(batch, wavs=batch["wavs"].clone())
        bad["wavs"][1, 100] = float("inf")
        assert not np.isfinite(step(bad)["loss"].item())
        assert opt.count.item() == 8
        for old, new in zip(before, (*tm.parameters(), *opt.mu, *opt.nu)):
            assert torch.equal(old, new)

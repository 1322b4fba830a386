"""Port parity for the training losses and the augmentation around them:
``label_smoothing_loss``, the plain CTC dynamic program, ``ctc_loss``'s
dispatch, ``asr_warmup_lr`` and SpecAugment, against the JAX package on the
same numpy inputs.

Tolerances. The label-smoothing loss and the CTC recursion run in float32 on
both sides with sums and log-sum-exps in another order: values agree to a few
1e-7 relative, so ``rtol`` 1e-5; gradients at the logits pass through a
softmax and a scatter-add, ``atol`` 1e-5 (the JAX package's own kernel test,
``tests/test_pallas_ctc.py``, uses rtol 1e-4 / atol 1e-6 between its two
paths and 1e-5 against optax). The JAX Pallas kernel runs in interpret mode.
SpecAugment draws other random numbers than JAX, so it is tested by its
invariants and statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from mindaudio_tpu.loss.ctc_loss import ctc_loss as jax_ctc_loss
from mindaudio_tpu.loss.ctc_loss import ctc_per_seq_loss as jax_ctc_per_seq
from mindaudio_tpu.loss.label_smoothing_loss import label_smoothing_loss as jax_lsm
from mindaudio_tpu.ops.pallas_ctc import ctc_per_seq_loss_pallas
from mindaudio_tpu.scheduler.schedules import asr_warmup_lr as jax_warmup
from mindaudio_torch.loss.ctc_loss import ctc_loss, ctc_per_seq_loss
from mindaudio_torch.loss.label_smoothing_loss import IGNORE_ID, label_smoothing_loss
from mindaudio_torch.ops import ctc_dp
from mindaudio_torch.ops.specaugment import mask_along_axis, spec_augment
from mindaudio_torch.scheduler.schedules import asr_warmup_lr

torch.set_num_threads(1)

RTOL, GRAD_ATOL = 1e-5, 1e-5


class TestLabelSmoothing:
    @pytest.mark.parametrize("smoothing,normalize_length", [
        (0.1, False), (0.1, True), (0.0, False), (0.3, True)])
    def test_value_and_grad(self, smoothing, normalize_length):
        rng = np.random.default_rng(0)
        logits = (3.0 * rng.standard_normal((3, 5, 17))).astype(np.float32)
        targets = rng.integers(0, 17, (3, 5))
        targets[0, 3:] = IGNORE_ID
        targets[2, 1:] = IGNORE_ID
        kw = dict(smoothing=smoothing, normalize_length=normalize_length)
        want_v, want_g = jax.value_and_grad(
            lambda lg: jax_lsm(lg, jnp.asarray(targets), **kw))(jnp.asarray(logits))
        x = torch.tensor(logits, requires_grad=True)
        got = label_smoothing_loss(x, torch.from_numpy(targets), **kw)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want_v), rtol=RTOL)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=GRAD_ATOL, rtol=0)

    def test_all_padding_and_bf16_logits(self):
        targets = torch.full((2, 4), IGNORE_ID)
        logits = torch.randn(2, 4, 9, generator=torch.Generator().manual_seed(0))
        assert label_smoothing_loss(logits, targets, normalize_length=True).item() == 0.0
        # bf16 logits are cast to float32 first: the loss of the rounded
        # logits, in float32
        targets = torch.tensor([[1, 2, 3, IGNORE_ID], [4, 5, IGNORE_ID, IGNORE_ID]])
        low = label_smoothing_loss(logits.bfloat16(), targets)
        assert low.dtype == torch.float32
        assert torch.equal(low, label_smoothing_loss(logits.bfloat16().float(), targets))


def _ctc_case(name):
    """The edge cases of ``tests/test_pallas_ctc.py``: logits, logit lengths,
    labels, label lengths, blank."""
    if name == "mixed_lengths_and_repeats":
        rng = np.random.default_rng(0)
        b, t, k, n = 4, 37, 11, 9
        labels = rng.integers(1, k, (b, n))
        labels[0, 2] = labels[0, 1]  # repeat: no s-2 skip
        labels[3, 1] = labels[3, 0]
        lens, llens, blank = [37, 25, 10, 30], [9, 5, 2, 4], 0
    elif name == "empty_label":
        rng = np.random.default_rng(1)
        b, t, k, n = 3, 17, 7, 5
        labels = rng.integers(1, k, (b, n))
        lens, llens, blank = [17, 9, 3], [0, 3, 0], 0
    elif name == "minimal_fit_t_equals_2l_plus_1":
        rng = np.random.default_rng(2)
        b, t, k, n = 2, 9, 6, 4
        labels = rng.integers(1, k, (b, n))
        lens, llens, blank = [9, 9], [4, 4], 0
    elif name == "full_length":
        rng = np.random.default_rng(3)
        b, t, k, n = 2, 24, 8, 6
        labels = rng.integers(1, k, (b, n))
        lens, llens, blank = [24, 24], [6, 4], 0
    elif name == "blank_is_last_class":
        rng = np.random.default_rng(5)
        b, t, k, n = 2, 19, 9, 5
        labels = rng.integers(0, k - 1, (b, n))
        lens, llens, blank = [19, 12], [5, 3], k - 1
    elif name == "single_frame":
        rng = np.random.default_rng(6)
        b, t, k, n = 2, 1, 5, 1
        labels = rng.integers(1, k, (b, n))
        lens, llens, blank = [1, 1], [1, 0], 0
    else:
        raise KeyError(name)
    logits = rng.standard_normal((b, t, k)).astype(np.float32)
    return (logits, np.asarray(lens, np.int32), labels.astype(np.int32),
            np.asarray(llens, np.int32), blank)


CTC_CASES = ["mixed_lengths_and_repeats", "empty_label", "minimal_fit_t_equals_2l_plus_1",
             "full_length", "blank_is_last_class", "single_frame"]


def _torch_value_and_grad(fn, logits):
    x = torch.tensor(logits, requires_grad=True)
    per_seq = fn(x)
    per_seq.mean().backward()
    return per_seq.detach().numpy(), x.grad.numpy()


class TestCtcReference:
    def _port(self, case):
        logits, lens, labels, llens, blank = _ctc_case(case)
        return _torch_value_and_grad(
            lambda x: ctc_dp.ctc_per_seq_loss_reference(
                x, torch.from_numpy(lens), torch.from_numpy(labels),
                torch.from_numpy(llens), blank_id=blank), logits)

    @pytest.mark.parametrize("case", CTC_CASES)
    @pytest.mark.parametrize("jax_impl", ["pallas", "scan"])
    def test_matches_jax(self, case, jax_impl):
        logits, lens, labels, llens, blank = _ctc_case(case)
        args = (jnp.asarray(lens), jnp.asarray(labels), jnp.asarray(llens))
        if jax_impl == "pallas":
            per = lambda lg: ctc_per_seq_loss_pallas(lg, *args, blank_id=blank)  # noqa: E731
        else:
            per = lambda lg: jax_ctc_per_seq(lg, *args, blank_id=blank, impl="scan")  # noqa: E731
        want_g = jax.grad(lambda lg: per(lg).mean())(jnp.asarray(logits))
        got_v, got_g = self._port(case)
        np.testing.assert_allclose(got_v, np.asarray(per(jnp.asarray(logits))),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got_g, np.asarray(want_g), atol=GRAD_ATOL, rtol=1e-4)

    @pytest.mark.parametrize("case", CTC_CASES)
    def test_matches_torch_ctc_loss(self, case):
        """A third opinion: PyTorch's own CTC on the same log-probs."""
        logits, lens, labels, llens, blank = _ctc_case(case)
        want_v, want_g = _torch_value_and_grad(
            lambda x: F.ctc_loss(F.log_softmax(x, -1).transpose(0, 1),
                                 torch.from_numpy(labels).long(),
                                 torch.from_numpy(lens).long(), torch.from_numpy(llens).long(),
                                 blank=blank, reduction="none"), logits)
        got_v, got_g = self._port(case)
        np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got_g, want_g, atol=GRAD_ATOL, rtol=1e-4)

    def test_infeasible_pair_is_finite(self):
        """T < L + repeats: a loss near 1e5, finite, with finite gradients,
        as in the JAX package (the additive -1e5 masks, not -inf)."""
        rng = np.random.default_rng(7)
        logits = rng.standard_normal((1, 3, 6)).astype(np.float32)
        lens, labels, llens = np.array([3]), np.array([[2, 2, 4]]), np.array([3])
        got_v, got_g = _torch_value_and_grad(
            lambda x: ctc_dp.ctc_per_seq_loss_reference(
                x, torch.from_numpy(lens), torch.from_numpy(labels), torch.from_numpy(llens)),
            logits)
        want = ctc_per_seq_loss_pallas(jnp.asarray(logits), jnp.asarray(lens),
                                       jnp.asarray(labels), jnp.asarray(llens))
        assert np.isfinite(got_v).all() and np.isfinite(got_g).all()
        assert got_v[0] > 5e4
        np.testing.assert_allclose(got_v, np.asarray(want), rtol=RTOL)

    def test_extended_log_probs(self):
        logits = torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(0))
        labels = torch.tensor([[3, 3, 1], [2, 5, 2]])
        logp_ext, allowed = ctc_dp.extended_log_probs(logits, labels, blank_id=0)
        assert logp_ext.shape == (2, 4, 7) and allowed.shape == (2, 7)
        lp = F.log_softmax(logits, -1)
        assert torch.equal(logp_ext[:, :, 0], lp[:, :, 0])
        assert torch.equal(logp_ext[0, :, 3], lp[0, :, 3])
        # skips: not into a blank, not between equal labels, not before s = 2
        assert allowed.tolist() == [[False, False, False, False, False, True, False],
                                    [False, False, False, True, False, True, False]]


class TestCtcLossDispatch:
    def _args(self):
        logits, lens, labels, llens, _ = _ctc_case("mixed_lengths_and_repeats")
        return logits, lens, labels, llens

    def test_batch_mean_matches_jax(self):
        logits, lens, labels, llens = self._args()
        want = jax_ctc_loss(jnp.asarray(logits), jnp.asarray(lens), jnp.asarray(labels),
                            jnp.asarray(llens))
        for impl in ("auto", "scan"):  # a CPU tensor takes the plain version
            got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(lens),
                           torch.from_numpy(labels), torch.from_numpy(llens), impl=impl)
            np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)

    def test_kernel_on_cpu_raises(self):
        logits, lens, labels, llens = map(torch.from_numpy, self._args())
        with pytest.raises(ValueError, match="CUDA"):
            ctc_per_seq_loss(logits, lens, labels, llens, impl="kernel")
        with pytest.raises(ValueError, match="CUDA"):
            ctc_dp.ctc_dp_fwd(torch.zeros(1, 2, 3), torch.ones(1), torch.ones(1, 3).bool(),
                              torch.ones(1))
        with pytest.raises(ValueError, match="impl"):
            ctc_per_seq_loss(logits, lens, labels, llens, impl="pallas")

    def test_bf16_logits_are_cast_first(self):
        logits, lens, labels, llens = map(torch.from_numpy, self._args())
        low = ctc_per_seq_loss(logits.bfloat16(), lens, labels, llens)
        assert low.dtype == torch.float32
        assert torch.equal(low, ctc_per_seq_loss(logits.bfloat16().float(), lens, labels, llens))


class TestWarmupSchedule:
    @pytest.mark.parametrize("lr,warmup,start", [(1e-3, 25000, 0), (2e-3, 5, 0), (1.0, 100, 7)])
    def test_matches_jax(self, lr, warmup, start):
        want_fn, got_fn = jax_warmup(lr, warmup, start), asr_warmup_lr(lr, warmup, start)
        steps = [0, 1, 2, warmup - 1, warmup, warmup + 1, 10 * warmup]
        want = np.array([float(want_fn(s)) for s in steps])
        # float32 powers on both sides
        np.testing.assert_allclose([got_fn(s).item() for s in steps], want, rtol=1e-6)
        got = got_fn(torch.tensor(steps, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        if start == 0:  # the step is clamped to 1
            assert got_fn(0).item() == got_fn(1).item()


class TestSpecAugment:
    def _bands(self, mask_1d):
        """[(start, width)] of the runs of True in a 1-D bool array."""
        padded = np.concatenate([[False], mask_1d, [False]]).astype(np.int8)
        edges = np.flatnonzero(np.diff(padded))
        return [(int(a), int(b - a)) for a, b in zip(edges[::2], edges[1::2])]

    def test_one_band_width_and_start_in_range(self):
        gen = torch.Generator().manual_seed(0)
        spec = torch.ones(512, 3, 40)
        out = mask_along_axis(spec, 10, axis=2, generator=gen)
        widths = []
        for row in (out[:, 0] == 0).numpy():
            bands = self._bands(row)
            assert len(bands) <= 1
            start, width = bands[0] if bands else (0, 0)
            assert 0 <= width <= 10 and 0 <= start <= 40 - width
            widths.append(width)
        # the same band on every row of a sample
        assert torch.equal(out[:, 0], out[:, 1]) and torch.equal(out[:, 0], out[:, 2])
        # widths uniform on 0..10: mean 5, standard error 0.14 over 512 draws
        assert abs(np.mean(widths) - 5.0) < 0.6
        assert set(widths) == set(range(11))

    def test_masks_are_iid_per_sample_and_keep_the_rest(self):
        gen = torch.Generator().manual_seed(3)
        spec = torch.randn(8, 32, 64, generator=torch.Generator().manual_seed(1))
        out = mask_along_axis(spec, 16, axis=2, mask_value=-7.0, generator=gen)
        masked = out == -7.0
        assert torch.equal(out[~masked], spec[~masked])
        assert len({tuple(np.flatnonzero(m[0].numpy())) for m in masked}) > 1

    def test_band_wider_than_the_axis(self):
        gen = torch.Generator().manual_seed(0)
        out = mask_along_axis(torch.ones(64, 4, 5), 20, axis=2, generator=gen)
        rows = (out[:, 0] == 0).numpy()
        # a width >= 5 can only start at 0 and covers everything
        assert any(r.all() for r in rows)
        for r in rows:
            assert len(self._bands(r)) <= 1

    def test_spec_augment_defaults(self):
        gen = torch.Generator().manual_seed(0)
        spec = torch.ones(16, 300, 80)
        out = spec_augment(spec, generator=gen)
        assert out.shape == spec.shape
        time_masked = (out == 0).all(dim=2)  # (B, T): whole frames
        freq_masked = (out == 0).all(dim=1)  # (B, F): whole bins
        for b in range(16):
            t_bands, f_bands = self._bands(time_masked[b].numpy()), self._bands(
                freq_masked[b].numpy())
            # two bands of at most 50 frames / 10 bins each, possibly merged
            assert len(t_bands) <= 2 and sum(w for _, w in t_bands) <= 100
            assert len(f_bands) <= 2 and sum(w for _, w in f_bands) <= 20
        assert time_masked.any() and freq_masked.any()
        swapped = spec_augment(spec.transpose(1, 2), time_axis=-1, freq_axis=-2,
                               generator=torch.Generator().manual_seed(0))
        assert torch.equal(swapped.transpose(1, 2), out)

    def test_needs_a_generator(self):
        with pytest.raises(ValueError, match="Generator"):
            spec_augment(torch.ones(2, 10, 8))

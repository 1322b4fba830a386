"""Data parallelism and ZeRO-1 of the port on gloo groups on the CPU,
against the JAX package's step on the global batch (what GSPMD computes for
a ``data``-sharded batch).

- The Conformer: three train steps at world size 2 and 4, each rank on its
  rows of every global batch, against ``train.state.make_train_step`` of the
  JAX package on the whole batch, from the same parameters and running AdamW
  moments (count 3, bf16 first moment). Tolerances as the single-process
  step test (``test_torch_train.py``): metrics 1e-4 relative, parameters
  2e-5 absolute after three steps; the all-reduce adds float32 sums in
  another order, far below that.
- ZeRO-1 against the replicated moments at the same world size: losses,
  parameters and the whole AdamW state bit for bit, and each rank's moment
  bytes ``1 / n`` of the replicated ones (padded to a multiple of n).
- DeepSpeech2: two steps with the batch norms' statistics over the global
  batch (flax's biased variance and running update) against the JAX model's
  steps on the whole batch: running statistics 1e-5, parameters 1e-5.
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
from torch_dist import run_ranks

VOCAB = 30
CFG = dict(vocab_size=VOCAB, input_dim=20, d_model=32, head_num=2, ffn_dim=64,
           num_encoder_layers=2, num_decoder_layers=1)


def asr_batch(seed, b=4, t=40, n=4):
    """A global batch of ``b`` rows whose label lengths differ (so the
    ranks' token counts differ)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, VOCAB - 1, (b, n)).astype(np.int32)
    label_lens = (n - np.arange(b) % n).astype(np.int32)
    padded = np.where(np.arange(n)[None] < label_lens[:, None], labels, -1)
    ys_in, ys_out = add_sos_eos(padded, VOCAB - 1, VOCAB - 1)
    return {"feats": rng.standard_normal((b, t, 20)).astype(np.float32),
            "feat_lens": (t - 3 * np.arange(b)).astype(np.int32),
            "labels": labels, "label_lens": label_lens,
            "ys_in": ys_in.astype(np.int32), "ys_out": ys_out.astype(np.int32),
            "ys_lens": label_lens + 1}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def draw_params(jm, batch, seed=0):
    """Flax parameters drawn with numpy from the shapes of ``jm.init``."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        n = rng.standard_normal(s.shape)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * n).astype(np.float32)
        scale = 0.1 if len(s.shape) < 2 else 1.5 / np.sqrt(np.prod(s.shape[:-1]))
        return (scale * n).astype(np.float32)

    return flax.core.unfreeze(jax.tree_util.tree_map_with_path(draw, shapes))


def running_moments(opt_state, seed, mu_dtype):
    rng = np.random.default_rng(seed)
    adam = opt_state[0]
    mu = jax.tree_util.tree_map(
        lambda m: jnp.asarray(0.01 * rng.standard_normal(m.shape), mu_dtype), adam.mu)
    nu = jax.tree_util.tree_map(
        lambda v: jnp.asarray(1e-4 * (1.0 + rng.random(v.shape)), jnp.float32), adam.nu)
    count = jnp.asarray(3, jnp.int32)
    rest = tuple(s._replace(count=count) if "count" in s._fields else s for s in opt_state[1:])
    return (adam._replace(count=count, mu=mu, nu=nu), *rest)


@pytest.fixture(scope="module")
def conformer_jax():
    """The JAX trainer's three steps on the whole batches."""
    batches = [asr_batch(s) for s in (3, 4, 5)]
    jm = JaxASR(**CFG)
    params = draw_params(jm, batches[0])
    tx = optax.adamw(jax_warmup(2e-3, 5), weight_decay=1e-2, mu_dtype=jnp.bfloat16)
    state = jstate.TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    state = state.replace(step=3, opt_state=running_moments(state.opt_state, 9, jnp.bfloat16))
    opt0 = convert_adamw_state(state.opt_state)
    jstep = jstate.make_train_step(lambda p, st, b, rng: jm.apply({"params": p}, b),
                                   grad_clip_norm=5.0, donate=False)
    metrics = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"batches": batches, "params0": convert_params(params), "opt0": opt0,
            "metrics": metrics, "params": convert_params(state.params),
            "nu": convert_params(state.opt_state[0].nu)}


@pytest.fixture(scope="module", params=[2, 4])
def conformer_ranks(request, conformer_jax):
    j = conformer_jax
    outs = run_ranks(request.param, "torch_parallel_cases", "conformer_dp_case",
                     (CFG, j["params0"], j["opt0"], [to_torch(b) for b in j["batches"]],
                      (False, True), torch.bfloat16))
    return request.param, outs


@pytest.mark.parametrize("zero1", [False, True])
def test_conformer_steps_match_the_jax_global_batch(conformer_jax, conformer_ranks, zero1):
    n, outs = conformer_ranks
    for r, out in enumerate(outs):
        got = out[zero1]
        for step, (g, w) in enumerate(zip(got["metrics"], conformer_jax["metrics"])):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=f"rank {r} step {step} {key}")
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), conformer_jax["params"][name].numpy(),
                                       rtol=0, atol=2e-5, err_msg=f"rank {r} {name}")
        for name, nu in got["opt"]["nu"].items():
            np.testing.assert_allclose(nu.numpy(), conformer_jax["nu"][name].numpy(),
                                       rtol=1e-3, atol=1e-9, err_msg=name)
        assert int(got["opt"]["count"]) == 6


def test_ranks_agree_bit_for_bit(conformer_ranks):
    """Every rank holds the same losses, parameters and moments."""
    _, outs = conformer_ranks
    for zero1 in (False, True):
        for out in outs[1:]:
            assert out[zero1]["metrics"] == outs[0][zero1]["metrics"]
            for name, p in out[zero1]["params"].items():
                assert torch.equal(p, outs[0][zero1]["params"][name]), name


def test_zero1_is_bit_identical_to_replicated(conformer_ranks):
    n, outs = conformer_ranks
    for out in outs:
        rep, z1 = out[False], out[True]
        assert z1["metrics"] == rep["metrics"]
        for name, p in z1["params"].items():
            assert torch.equal(p, rep["params"][name]), name
        for key in ("mu", "nu"):
            for name, t in z1["opt"][key].items():
                assert torch.equal(t, rep["opt"][key][name]), (key, name)
        assert torch.equal(z1["opt"]["count"], rep["opt"]["count"])


def test_zero1_moment_bytes_drop_by_the_world_size(conformer_ranks):
    n, outs = conformer_ranks
    total = sum(p.numel() for p in outs[0][False]["params"].values())
    for out in outs:
        assert out[False]["moment_bytes"] == total * (2 + 4)  # bf16 mu, float32 nu
        assert out[True]["moment_bytes"] == -(-total // n) * (2 + 4)

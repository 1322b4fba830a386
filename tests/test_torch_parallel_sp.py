"""Sequence parallelism of the port (``parallel.ring_attention`` and the
encoder's ``sp_mesh``) on gloo groups of 2 and 4 processes, against the JAX
package.

- Ring and Ulysses attention on whole ``(B, H, T, D)`` tensors with a
  padding mask (one row fully masked past its length) against the JAX
  ``sequence_parallel_attention`` on a ``seq`` mesh: the
  output and the gradients of ``sum(out * w)`` with respect to q, k and v,
  1e-5 (float32 streaming softmax against dense, sums in another order);
  JAX on a mesh of 4 devices, the port on 2 and 4 processes.
- The Conformer encoder with its blocks sequence parallel (ring and Ulysses)
  against the dense JAX encoder on converted parameters: the output at the
  valid frames, 2e-5 (the JAX test's tolerance for its own SP encoder). The
  gradients of every parameter of ``sum(out^2 * valid)`` are held against
  the port's dense encoder in float64, 1e-6 of each leaf's largest (of
  1e-6 of the largest gradient for the key biases, whose exact gradient is
  zero): in float32 this loss is ill-conditioned (the port's and JAX's
  dense encoders differ by 12 % on the subsampling convs' gradients and on
  the key biases), so the float32 comparison would not see a wrong
  collective. ``tests/test_torch_encoder_grad64.py`` holds the dense
  encoders' float64 gradients of this loss against each other, 1e-5 of
  each leaf's largest: the float32 gap is the loss's conditioning.
- The refusals: chunked attention, a subsampled length the group does not
  divide, and Ulysses with a head count it does not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.models.conformer import ConformerEncoder as JaxEncoder
from mindaudio_tpu.parallel.mesh import make_mesh as jax_mesh
from mindaudio_tpu.parallel.ring_attention import sequence_parallel_attention as jax_spa
from mindaudio_torch.convert import convert_params
from torch_dist import run_ranks

B, H, T, D = 2, 4, 16, 8


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    valid = np.ones((B, T), bool)
    valid[1, 11:] = False
    return q, k, v, valid, w


@pytest.fixture(scope="module", params=["ring", "ulysses"])
def jax_attention(request):
    """JAX's ``sequence_parallel_attention`` over a ``seq`` mesh of 4 CPU
    devices: the output and the gradients of ``sum(out * w)``."""
    variant = request.param
    q, k, v, valid, w = _qkv()
    mesh = jax_mesh(data=1, seq=4, devices=jax.devices()[:4])

    def loss(q, k, v):
        out = jax_spa(q, k, v, mesh, kv_valid=jnp.asarray(valid), batch_axis=None,
                      variant=variant, scale=SCALE)
        return jnp.sum(out * w), out

    (_, want), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return variant, (q, k, v, valid, w), np.asarray(want), [np.asarray(g) for g in want_g]


SCALE = 0.3


@pytest.mark.parametrize("world", [2, 4])
def test_attention_matches_jax(jax_attention, world):
    variant, (q, k, v, valid, w), want, want_g = jax_attention
    outs = run_ranks(world, "torch_parallel_cases", "sp_attention_case",
                     tuple(torch.from_numpy(a) for a in (q, k, v, valid))
                     + (variant, SCALE, torch.from_numpy(w)))
    for out, grads in outs:
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
        for g, wg in zip(grads, want_g):
            np.testing.assert_allclose(g.numpy(), wg, rtol=1e-5, atol=1e-5)


ENC = dict(input_dim=40, d_model=64, head_num=4, ffn_dim=128, num_layers=2,
           dropout_rate=0.0, kernel_size=15)


@pytest.fixture(scope="module")
def dense_jax():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 131, 40)).astype(np.float32)
    lens = np.array([131, 103], np.int32)
    enc = JaxEncoder(**ENC)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(lens))["params"]
    out, mask = enc.apply({"params": params}, jnp.asarray(xs), jnp.asarray(lens))
    return xs, lens, convert_params(params), np.asarray(out), np.asarray(mask)


@pytest.mark.parametrize("world,variant", [(2, "ring"), (2, "ulysses"), (4, "ring"),
                                           (4, "ulysses")])
def test_sequence_parallel_encoder_matches_dense_jax(dense_jax, world, variant):
    xs, lens, state, want, mask = dense_jax
    outs = run_ranks(world, "torch_parallel_cases", "sp_encoder_case",
                     (ENC, state, torch.from_numpy(xs), torch.from_numpy(lens).long(), variant))
    valid = mask[:, 0, :]
    for out, got_mask, grads, dense in outs:
        np.testing.assert_array_equal(got_mask.numpy(), mask)
        np.testing.assert_allclose(out.numpy()[valid], want[valid], rtol=2e-5, atol=2e-5)
        assert set(grads) == set(dense) == set(state)
        scale = max(np.abs(g.numpy()).max() for g in dense.values())
        for name, g in grads.items():
            w = dense[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-6 * max(np.abs(w).max(), 1e-6 * scale),
                                       err_msg=name)


def test_refusals(dense_jax):
    xs, lens, state, *_ = dense_jax
    msgs = run_ranks(2, "torch_parallel_cases", "sp_raises_case",
                     (ENC, state, torch.from_numpy(xs), torch.from_numpy(lens).long()))[0]
    assert "full-context" in msgs[0] and "full-context" in msgs[1]
    assert "not divisible by 'seq' axis size 2" in msgs[2]
    assert "head count 3 not divisible by mesh axis size 2" in msgs[3]

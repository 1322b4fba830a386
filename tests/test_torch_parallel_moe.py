"""``parallel.moe`` against the JAX package's ``MoEFeedForward`` on the same
parameters (``convert_params``) and inputs, made with numpy.

One process: the output, the Switch aux loss and the gradients of
``mean(y^2) + 0.01 * aux`` (parameters and input), top-1 and top-2, with a
padding mask, with tied experts (the dense FFN), one expert, and a capacity
overflow (the first ``C`` tokens in GShard order kept, the rest exactly 0).
Over gloo processes: experts split over ``model`` (2 ranks), the batch over
``data`` (2 ranks: the capacity and the priority are the global batch's) and
both (4 ranks), against JAX on the whole batch. Float32 throughout;
outputs and gradients agree to 1e-5 relative (sums in another order), the
zeros of dropped tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.parallel.moe import MoEFeedForward as JaxMoE
from mindaudio_tpu.parallel.moe import moe_capacity as jax_capacity
from mindaudio_torch.convert import convert_params
from mindaudio_torch.parallel.moe import MoEFeedForward, moe_capacity
from torch_dist import run_ranks

B, T, D, H = 4, 12, 16, 32
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed=0, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    if positive:
        x = np.abs(x) + 0.1
    mask = np.ones((B, T), bool)
    mask[1, 9:] = False
    mask[3, 5:] = False
    return x, mask


def _params(e, seed=1, tie=False):
    rng = np.random.default_rng(seed)
    p = {"gate": rng.standard_normal((D, e)) / np.sqrt(D),
         "w1": rng.standard_normal((e, D, H)) / np.sqrt(D),
         "b1": 0.1 * rng.standard_normal((e, H)),
         "w2": rng.standard_normal((e, H, D)) / np.sqrt(H),
         "b2": 0.1 * rng.standard_normal((e, D))}
    if tie:
        for k in ("w1", "b1", "w2", "b2"):
            p[k] = np.broadcast_to(p[k][:1], p[k].shape).copy()
    return {k: v.astype(np.float32) for k, v in p.items()}


def _jax(params, x, mask, **kw):
    moe = JaxMoE(num_experts=params["gate"].shape[1], hidden_units=H, dropout_rate=0.0, **kw)

    def loss(p, x):
        y, inter = moe.apply({"params": p}, x, mask_pad=jnp.asarray(mask),
                             mutable=["intermediates"])
        aux = inter["intermediates"]["moe_aux_loss"][0]
        return jnp.mean(jnp.square(y)) + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(y), float(aux), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _port(params, x, mask, **kw):
    layer = MoEFeedForward(D, params["gate"].shape[1], H, dropout_rate=0.0, **kw)
    layer.load_state_dict(convert_params(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt, torch.from_numpy(mask))
    loss = y.square().mean() + 0.01 * layer.aux_loss
    grads = torch.autograd.grad(loss, list(layer.parameters()) + [xt])
    names = [n for n, _ in layer.named_parameters()]
    return (y.detach().numpy(), float(layer.aux_loss.detach()),
            {n: g.numpy() for n, g in zip(names, grads[:-1])}, grads[-1].numpy())


@pytest.mark.parametrize("top_k,factor", [(1, 1.25), (2, 1.25), (2, 0.5), (1, 4.0)])
def test_matches_jax(top_k, factor):
    params, (x, mask) = _params(4), _inputs()
    want = _jax(params, x, mask, top_k=top_k, capacity_factor=factor)
    got = _port(params, x, mask, top_k=top_k, capacity_factor=factor)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(got[2][k], want[2][k], **TOL, err_msg=k)
    np.testing.assert_allclose(got[3], want[3], **TOL)
    assert np.abs(want[2]["w1"]).sum() > 0 and 0.5 < want[1] < 4.0


@pytest.mark.parametrize("top_k", [1, 2])
def test_identical_experts_are_the_dense_ffn(top_k):
    params, (x, mask) = _params(4, tie=True), _inputs()
    y = _port(params, x, mask, top_k=top_k, capacity_factor=4.0 / top_k)[0]
    h = np.maximum(x @ params["w1"][0] + params["b1"][0], 0.0)
    dense = np.where(mask[..., None], h @ params["w2"][0] + params["b2"][0], 0.0)
    np.testing.assert_allclose(y, dense, rtol=1e-5, atol=1e-5)


def test_single_expert():
    params, (x, mask) = _params(1), _inputs()
    assert moe_capacity(B * T, 1, 1, 1.0) >= B * T
    want = _jax(params, x, mask, top_k=1, capacity_factor=1.0)
    got = _port(params, x, mask, top_k=1, capacity_factor=1.0)
    np.testing.assert_allclose(got[0], want[0], **TOL)


def test_capacity_overflow_keeps_the_first_tokens():
    params, (x, _) = _params(2), _inputs(positive=True)
    mask = np.ones((B, T), bool)
    params["gate"] = np.zeros((D, 2), np.float32)
    params["gate"][:, 0] = 1e3  # every token to expert 0
    cap = moe_capacity(B * T, 2, 1, 0.5)
    assert cap == jax_capacity(B * T, 2, 1, 0.5) < B * T
    want = _jax(params, x, mask, top_k=1, capacity_factor=0.5)[0].reshape(-1, D)
    got = _port(params, x, mask, top_k=1, capacity_factor=0.5)[0].reshape(-1, D)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[cap:], 0.0)
    np.testing.assert_array_equal(want[cap:], 0.0)
    assert np.abs(got[:cap]).min(-1).max() > 0
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("capacity", [(8, 4, 2, 1.25), (1000, 8, 2, 1.25), (3, 3, 1, 1.0),
                                      (96, 8, 2, 0.5)])
def test_capacity_formula(capacity):
    assert moe_capacity(*capacity) == jax_capacity(*capacity)


def test_top_k_above_the_experts_raises():
    with pytest.raises(ValueError, match="top_k"):
        MoEFeedForward(D, 2, H, top_k=3)


@pytest.fixture(scope="module")
def jax_global():
    params, (x, mask) = _params(4, seed=5), _inputs(seed=6)
    return params, x, mask, _jax(params, x, mask, top_k=2, capacity_factor=1.0)


@pytest.mark.parametrize("world,shape", [(2, dict(model=2)), (2, dict(data=2)),
                                         (4, dict(data=2, model=2))])
def test_expert_and_data_parallel_match_jax(jax_global, world, shape):
    params, x, mask, (y, aux, gp, gx) = jax_global
    kwargs = dict(d_model=D, num_experts=4, hidden_units=H, dropout_rate=0.0, top_k=2,
                  capacity_factor=1.0)
    outs = run_ranks(world, "torch_parallel_cases", "moe_case",
                     (convert_params(params), torch.from_numpy(x), torch.from_numpy(mask),
                      kwargs, shape))
    n_data = shape.get("data", 1)
    local = B // n_data
    for out in outs:
        d = out["coords"]["data"]
        np.testing.assert_allclose(out["y"].numpy(), y[d * local:(d + 1) * local], **TOL)
        for k in params:
            np.testing.assert_allclose(out["grads"][k].numpy(), gp[k], **TOL, err_msg=k)
        # the rank's loss is the mean over its rows: the global loss (the
        # ranks' mean) has 1 / n_data of its input gradient
        np.testing.assert_allclose(out["x_grad"].numpy() / n_data,
                                   gx[d * local:(d + 1) * local], **TOL)
    np.testing.assert_allclose(np.mean([float(o["aux"]) for o in outs]), aux, rtol=1e-6)

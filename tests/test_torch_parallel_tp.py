"""Megatron tensor parallelism of the port (``parallel.shardings``) against
the JAX package.

- The rule table: on the Conformer's parameters (with MoE blocks too) the
  port cuts exactly the leaves the JAX ``infer_shardings`` shards over
  ``model``, along the same dimension (a Linear's weight is the transposed
  kernel), and keeps the vocabulary heads whole at V = 4233, model = 2.
- One train step over ``model = 2`` (and ``data = 2 x model = 2``): the
  hybrid loss and every gradient of the first forward, then the step's
  metrics (the global gradient norm over the pieces) and the updated
  parameters, against the JAX step run sharded by ``state_shardings`` on a
  ``model`` mesh of the CPU devices; tolerances as the data-parallel test
  (1e-4 relative on metrics; 1e-5 of each gradient leaf's largest, plus
  1e-7 of the largest gradient for the key biases, whose exact gradient is
  zero and whose float32 value is noise on both sides; 2e-5 on
  parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mindaudio_tpu.models.asr_model import ASRModel as JaxASR
from mindaudio_tpu.parallel.mesh import make_mesh as jax_mesh
from mindaudio_tpu.parallel.shardings import infer_shardings as jax_infer
from mindaudio_tpu.parallel.shardings import state_shardings as jax_state_shardings
from mindaudio_tpu.scheduler.schedules import asr_warmup_lr as jax_warmup
from mindaudio_tpu.train import state as jstate
from mindaudio_torch.convert import convert_adamw_state, convert_params, module_name
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.parallel.shardings import infer_shardings
from test_torch_parallel_dp import CFG, asr_batch, draw_params, running_moments, to_torch
from torch_dist import run_ranks


def _jax_cuts(params, model_size):
    """``{port name: (dim, kind)}`` of the leaves JAX shards over ``model``."""
    mesh = jax_mesh(data=8 // model_size, model=model_size)
    cuts = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(jax_infer(params, mesh))[0]:
        keys = [p.key for p in path]
        spec = tuple(sh.spec)
        if "model" not in spec:
            continue
        leaf = keys[-1]
        name = ".".join(filter(None, (module_name(keys[:-1]),
                                      "weight" if leaf == "kernel" else leaf)))
        dim = spec.index("model")
        if leaf == "kernel":
            dim = 1 - dim  # (in, out) -> (out, in)
        cuts[name] = (dim, "glu" if "pointwise_conv1" in name else "split")
    return cuts


@pytest.mark.parametrize("kw,model_size", [
    (dict(vocab_size=4233, d_model=256, head_num=4, ffn_dim=2048), 2),
    (dict(vocab_size=32, d_model=64, head_num=4, ffn_dim=128), 4),
    (dict(vocab_size=32, d_model=64, head_num=4, ffn_dim=128, moe_experts=4), 2),
])
def test_rule_table_matches_infer_shardings(kw, model_size):
    layers = dict(num_encoder_layers=1, num_decoder_layers=1, input_dim=16)
    jm = JaxASR(**kw, **layers)
    batch = asr_batch(0, b=2, t=24)
    batch["feats"] = batch["feats"][..., :16]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    want = _jax_cuts(shapes, model_size)
    tm = ASRModel(**kw, **layers, device="meta")
    got = infer_shardings([(k, tuple(p.shape)) for k, p in tm.named_parameters()],
                          model_size)
    got = {k: v for k, v in got.items() if v is not None}
    assert got == want
    if kw["vocab_size"] == 4233:
        assert not any(k.startswith(("ctc_proj", "decoder.output_layer")) for k in got)


@pytest.fixture(scope="module")
def jax_tp():
    batch = asr_batch(7)  # one global batch of 4
    jm = JaxASR(**CFG)
    params = draw_params(jm, batch, seed=3)
    tx = optax.adamw(jax_warmup(2e-3, 5), weight_decay=1e-2)
    state = jstate.TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    state = state.replace(step=3, opt_state=running_moments(state.opt_state, 2, jnp.float32))
    opt0 = convert_adamw_state(state.opt_state)

    def loss_fn(p, b):
        return jm.apply({"params": p}, b)[0]

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jb)
    mesh = jax_mesh(data=1, model=2, devices=jax.devices()[:2])
    st_sh = jax_state_shardings(state, mesh)
    jstep = jstate.make_train_step(lambda p, st, b, rng: jm.apply({"params": p}, b),
                                   grad_clip_norm=5.0, donate=False)
    new, metrics = jstep(jax.device_put(state, st_sh), jb)
    return (batch, convert_params(params), opt0, float(loss), convert_params(grads),
            {k: float(v) for k, v in metrics.items()}, convert_params(new.params))


@pytest.mark.parametrize("world,shape", [(2, dict(model=2)), (4, dict(data=2, model=2))])
def test_tensor_parallel_step_matches_jax(jax_tp, world, shape):
    batch, state, opt0, loss, grads, metrics, new_params = jax_tp
    outs = run_ranks(world, "torch_parallel_cases", "tp_step_case",
                     (CFG, state, opt0, to_torch(batch), shape))
    for got_metrics, got_params, cut, got_loss, got_grads in outs:
        assert cut and all(k in state for k in cut)  # something was cut
        if shape.get("data", 1) == 1:
            np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        scale = max(np.abs(g.numpy()).max() for g in grads.values())
        for name, g in got_grads.items():
            w = grads[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max() + 1e-7 * scale, err_msg=name)
        for key in ("loss", "grad_norm", "loss_att", "loss_ctc"):
            np.testing.assert_allclose(got_metrics[key], metrics[key], rtol=1e-4, err_msg=key)
        for name, p in got_params.items():
            np.testing.assert_allclose(p.numpy(), new_params[name].numpy(), rtol=0, atol=2e-5,
                                       err_msg=name)

"""GPipe over the Conformer encoder's blocks (``parallel.pipeline``, the
encoder's ``pipeline_mesh``) on gloo groups: 2 and 4 stages, and data x
pipe (2 x 2), against the JAX encoder pipelined over a data x pipe mesh of
the CPU devices (``pipeline_apply``).

The output rows agree with JAX's to 2e-5 (float32). The gradients of
``sum(out * w)`` after the train step's sync (each block's gradient summed
from the stage that runs it, then averaged over ``data``) are held against
the sequential encoder on the whole batch in float64, 1e-6 of each leaf's
largest (the same sums in another order; of 1e-6 of the largest gradient
for leaves whose exact gradient is zero): in float32 the subsampling
convs' gradients of this encoder are too ill-conditioned to show a wrong
hop (see ``test_torch_parallel_sp.py``). Also the schedule's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.models.conformer import ConformerEncoder as JaxEncoder
from mindaudio_tpu.parallel.mesh import make_mesh as jax_mesh
from mindaudio_torch.convert import convert_params
from mindaudio_torch.parallel.mesh import Mesh
from mindaudio_torch.parallel.pipeline import pipeline_apply, stack_layer_params
from torch_dist import run_ranks

ENC = dict(input_dim=40, d_model=32, head_num=2, ffn_dim=64, num_layers=4,
           dropout_rate=0.0, kernel_size=7)


@pytest.fixture(scope="module")
def inputs():
    """The inputs, and the JAX encoder pipelined over 4 stages of a
    ``(data 2, pipe 4)`` mesh with 2 microbatches (each port layout below
    computes the same function)."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((4, 67, 40)).astype(np.float32)
    lens = np.array([67, 59, 51, 43], np.int32)
    w = rng.standard_normal((4, 16, 32)).astype(np.float32)
    params = JaxEncoder(**ENC).init(jax.random.PRNGKey(0), jnp.asarray(xs),
                                    jnp.asarray(lens))["params"]
    mesh = jax_mesh(data=2, pipe=4)
    enc = JaxEncoder(**ENC, pipeline_mesh=mesh, pipeline_microbatches=2)
    want = np.asarray(enc.apply({"params": params}, jnp.asarray(xs), jnp.asarray(lens))[0])
    return xs, lens, w, params, want


@pytest.mark.parametrize("world,shape,n_micro", [(2, dict(data=1, pipe=2), 4),
                                                 (4, dict(data=1, pipe=4), 4),
                                                 (4, dict(data=2, pipe=2), 2)])
def test_pipelined_encoder(inputs, world, shape, n_micro):
    xs, lens, w, params, want = inputs
    n_data = shape["data"]
    outs = run_ranks(world, "torch_parallel_cases", "pp_encoder_case",
                     (ENC, convert_params(params), torch.from_numpy(xs),
                      torch.from_numpy(lens).long(), torch.from_numpy(w), shape, n_micro))
    local = 4 // n_data
    for out, piped, seq, coords in outs:
        d = coords["data"]
        np.testing.assert_allclose(out.numpy(), want[d * local:(d + 1) * local],
                                   rtol=2e-5, atol=2e-5)
        assert set(piped) == set(seq)
        scale = max(np.abs(g.numpy()).max() for g in seq.values())
        for name, g in piped.items():
            ref = seq[name].numpy()
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=1e-6 * max(np.abs(ref).max(), 1e-6 * scale),
                                       err_msg=name)


def test_refusals_and_stacking():
    mesh = Mesh({"pipe": 1}, 0)
    x = torch.zeros(6, 3)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda i, h: h, 2, x, mesh, num_microbatches=4)
    one = pipeline_apply(lambda i, h: h + i, 3, x, mesh, num_microbatches=3)
    np.testing.assert_array_equal(one.numpy(), np.full((6, 3), 3.0))  # 0 + 1 + 2
    stacked = stack_layer_params([{"w": torch.ones(2)}, {"w": torch.zeros(2)}])
    assert stacked["w"].shape == (2, 2)

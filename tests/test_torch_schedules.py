"""The port's learning-rate schedules (``mindaudio_torch.scheduler
.schedules``) against the JAX package's and optax's, over their whole range
(before the warm-up ends, through the decay and past its end), float32 on
both sides: equal, or, for the cosine, within two float32 ulps of the peak
rate (``cos`` rounds differently); the step counts go in as int32 arrays, as a train step's count
does, and as Python ints."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.scheduler import schedules as jsched
from mindaudio_torch.scheduler import schedules as tsched

STEPS = np.arange(0, 3001, dtype=np.int32)

CASES = {
    "warmup_poly_lr": (lambda m: m.warmup_poly_lr(1e-3, 1e-5, 100, 2000, power=2.0,
                                                  start_steps=3), 0.0),
    "warmup_poly_lr_linear": (lambda m: m.warmup_poly_lr(5e-4, 0.0, 0, 1500), 0.0),
    "cosine_lr": (lambda m: m.cosine_lr(1e-3, 1e-5, 100, 2000),
                  2 * float(np.spacing(np.float32(1e-3)))),
    "cosine_lr_offset": (lambda m: m.cosine_lr(2e-3, 1e-4, 250, 2500, start_steps=50),
                         2 * float(np.spacing(np.float32(2e-3)))),
    "step_lr": (lambda m: m.step_lr(1e-3, 37, factor=0.5, interval=2), 0.0),
    "step_lr_tenth": (lambda m: m.step_lr(0.1, 100, factor=0.1, interval=3), 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax(name):
    make, atol = CASES[name]
    got = make(tsched)(torch.from_numpy(STEPS))
    want = np.asarray(make(jsched)(jnp.asarray(STEPS)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    for step in (0, 1, 99, 100, 101, 1999, 2000, 2999):
        np.testing.assert_allclose(float(make(tsched)(step)), float(make(jsched)(step)),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("init,end,steps", [(0.0, 2e-4, 1000), (1e-3, 1e-5, 7), (0.0, 2e-4, 0)])
def test_linear_schedule_matches_optax(init, end, steps):
    """WaveGrad's warm-up: 0 at the first step, the full rate from
    ``steps`` on; with no transition optax holds the initial value."""
    got = tsched.linear_schedule(init, end, steps)(torch.from_numpy(STEPS)).numpy()
    want = np.asarray(optax.linear_schedule(init, end, steps)(jnp.asarray(STEPS)),
                      np.float32)
    np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))
    if init == 0.0:
        assert got[0] == 0.0 and got[-1] == np.float32(end if steps > 0 else 0.0)

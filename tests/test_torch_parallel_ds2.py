"""DeepSpeech2's data-parallel step (the recipe's ``make_step`` over the
data group, replicated and ZeRO-1 moments) against the JAX recipe's
``make_step`` on a ``data`` mesh of 2 CPU devices with the same global
batch of 4 utterances: the batch norms take the global batch's mean and
biased variance (flax's), so the running statistics, the loss, the gradient
norm, the parameters and the moments agree as in the one-process test
(``test_torch_ds2_recipe.py``: 1e-5 relative, floors of 1e-6 / 1e-5 of
each leaf's largest), and ZeRO-1 is bit for bit the replicated step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.parallel.mesh import make_mesh as jax_mesh
from mindaudio_tpu.parallel.shardings import state_shardings
from mindaudio_tpu.train import config as jconfig
from mindaudio_tpu.train.state import TrainState
from mindaudio_torch.convert import convert_adamw_state, convert_params
from mindaudio_torch.recipes.deepspeech2 import dataset
from test_torch_ds2_recipe import JAX_RECIPE, TOY, _draw, _running_adam, jax_recipe  # noqa: F401
from torch_dist import run_ranks


def _batch(seed=3, b=4, frames=60):
    rng = np.random.default_rng(seed)
    wav_lens = np.array([frames * 160 - 1, 41 * 160, 23 * 160 + 7, 50 * 160], np.int32)[:b]
    wavs = np.zeros((b, frames * 160), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = 0.1 * rng.standard_normal(n)
    labels = np.zeros((b, dataset.MAX_LABEL_LEN), np.int32)
    label_lens = np.array([7, 5, 3, 6], np.int32)[:b]
    for i, n in enumerate(label_lens):
        labels[i, :n] = rng.integers(0, dataset.BLANK_ID, n)
    return {"wavs": wavs, "wav_lens": wav_lens, "labels": labels, "label_lens": label_lens}


@pytest.fixture(scope="module")
def jax_step(jax_recipe):  # noqa: F811
    import os

    argv = TOY + ["--optim.lr", "0.001"]
    jcfg = jconfig.get_config(os.path.join(JAX_RECIPE, "deepspeech2.yaml"), argv)
    batch = _batch()
    jmodel = jax_recipe.train.DeepSpeechModel(vocab_size=len(dataset.LABELS), hidden_size=32,
                                              num_rnn_layers=2)
    feats, feat_lens = jax_recipe.train.device_features(jnp.asarray(batch["wavs"]),
                                                        jnp.asarray(batch["wav_lens"]))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), feats, feat_lens)
    rng = np.random.default_rng(4)
    params = _draw(shapes["params"], rng)
    stats = jax.tree_util.tree_map(lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
                                   shapes["batch_stats"])
    tx = optax.adamw(float(jcfg.optim.lr), weight_decay=float(jcfg.optim.weight_decay))
    state = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx, batch_stats=stats)
    state = state.replace(step=3, opt_state=_running_adam(state.opt_state, rng))
    start = (convert_params(params, stats), convert_adamw_state(
        jax.tree_util.tree_map(np.array, state.opt_state)))
    mesh = jax_mesh(data=2, devices=jax.devices()[:2])
    st_sh = state_shardings(state, mesh)
    jstep, _ = jax_recipe.train.make_step(jcfg, jmodel, mesh, st_sh)
    state, want = jstep(jax.device_put(state, st_sh), {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    return (argv, batch, start, {k: float(v) for k, v in want.items()},
            convert_params(state.params, state.batch_stats),
            convert_adamw_state(state.opt_state))


@pytest.mark.parametrize("zero1", [False, True])
def test_data_parallel_step_matches_the_jax_recipe(jax_step, zero1):
    argv, batch, (state, opt0), want, want_state, want_opt = jax_step
    argv = argv + ["--train.zero1_optimizer", str(zero1).lower()]
    outs = run_ranks(2, "torch_parallel_cases", "ds2_recipe_step_case",
                     (argv, state, opt0, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                                          else torch.from_numpy(v) for k, v in batch.items()}))
    for metrics, got_state, got_opt in outs:
        np.testing.assert_allclose(metrics["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"], want["grad_norm"], rtol=1e-4)
        for name, t in got_state.items():
            w = want_state[name].numpy()
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
        for key in ("mu", "nu"):
            for name, t in got_opt[key].items():
                w = want_opt[key][name].numpy()
                np.testing.assert_allclose(t.numpy(), w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max(), err_msg=name)
    for a, b in zip(outs[0][1].values(), outs[1][1].values()):
        assert torch.equal(a, b)
    RUNS[zero1] = outs


RUNS = {}  # the runs above, for the bit-for-bit comparison below


def test_zero1_is_bit_identical_to_replicated(jax_step):
    runs = RUNS
    if set(runs) != {False, True}:
        argv, batch, (state, opt0), *_ = jax_step
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in batch.items()}
        for z in (False, True):
            runs[z] = run_ranks(2, "torch_parallel_cases", "ds2_recipe_step_case",
                                (argv + ["--train.zero1_optimizer", str(z).lower()], state,
                                 opt0, tb))
    for rep, z1 in zip(runs[False], runs[True]):
        assert rep[0] == z1[0]
        for name, t in rep[1].items():
            assert torch.equal(t, z1[1][name]), name
        for key in ("mu", "nu"):
            for name, t in rep[2][key].items():
                assert torch.equal(t, z1[2][key][name]), (key, name)

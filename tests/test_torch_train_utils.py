"""Port parity for the training utilities: the rest of ``utils/common``
(``add_blank``, ``get_parameter_numel``, ``get_activation``,
``get_subsample``, ``get_feat_extract_output_lengths``,
``set_weight_decay`` with ``AdamW(decay=...)``) and ``train/profiler``
(``trace``, ``annotate``, ``StepTimer``), against the JAX package on the
CPU.

Tolerances: the activations are float32 elementwise functions on both sides
(1e-6); one AdamW step with a decay mask against optax's ``adamw(mask=...)``
at the 1e-5 of ``tests/test_torch_train.py``'s single update.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindaudio_tpu.models.asr_model import ASRModel as JaxASR
from mindaudio_tpu.train import profiler as jprof
from mindaudio_tpu.utils import common as jcommon
from mindaudio_torch.convert import convert_params
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.train import profiler as tprof
from mindaudio_torch.train.optim import AdamW
from mindaudio_torch.utils import common as tcommon

torch.set_num_threads(1)

CFG = dict(vocab_size=12, input_dim=20, d_model=16, head_num=2, ffn_dim=32,
           num_encoder_layers=1, num_decoder_layers=1)


def test_add_blank_matches_jax():
    ys = np.array([[3, 5, 7, -1], [2, -1, -1, -1]], np.int32)
    for blank in (0, 11):
        got = tcommon.add_blank(ys, blank)
        np.testing.assert_array_equal(got, jcommon.add_blank(ys, blank))
        assert got.dtype == ys.dtype


@pytest.mark.parametrize("name", ["tanh", "relu", "swish", "gelu"])
def test_get_activation_matches_jax(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    want = np.asarray(jcommon.get_activation(name)(jnp.asarray(x)))
    got = tcommon.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_subsample_and_output_lengths_match_jax():
    for layer in ("conv2d", "conv2d6", "conv2d8"):
        cfg = {"encoder_conf": {"input_layer": layer}}
        assert tcommon.get_subsample(cfg) == jcommon.get_subsample(cfg)
    with pytest.raises(ValueError):
        tcommon.get_subsample({"encoder_conf": {"input_layer": "linear"}})
    lens = np.array([100, 57, 9])
    want = jcommon.get_feat_extract_output_lengths(lens, (3, 3), (2, 2))
    np.testing.assert_array_equal(
        tcommon.get_feat_extract_output_lengths(torch.from_numpy(lens), (3, 3), (2, 2)).numpy(),
        want)
    assert tcommon.get_feat_extract_output_lengths(1000, (10, 3, 3), (5, 2, 2)) == \
        jcommon.get_feat_extract_output_lengths(1000, (10, 3, 3), (5, 2, 2))


@pytest.fixture(scope="module")
def jax_params():
    batch = {"feats": jnp.zeros((1, 40, 20)), "feat_lens": jnp.array([40]),
             "labels": jnp.ones((1, 2), jnp.int32), "label_lens": jnp.array([2]),
             "ys_in": jnp.ones((1, 3), jnp.int32), "ys_out": jnp.ones((1, 3), jnp.int32),
             "ys_lens": jnp.array([3])}
    shapes = jax.eval_shape(JaxASR(**CFG).init, jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def test_parameter_numel_matches_jax(jax_params):
    model = ASRModel(**CFG, device="cpu")
    want = jcommon.get_parameter_numel(jax_params)
    assert tcommon.get_parameter_numel(model) == want
    assert tcommon.get_parameter_numel(model.state_dict()) == want  # no CMVN, no batch norm
    assert tcommon.get_parameter_numel(convert_params(jax_params)) == want
    assert tcommon.get_parameter_numel(jax_params["ctc_proj"]) == 16 * 12 + 12


def _mask_names(jax_params):
    mask = jcommon.set_weight_decay(jax_params)
    marked = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32),
                                    mask, jax_params)
    return {k for k, v in convert_params(marked).items() if bool(v.flatten()[0])}


def test_set_weight_decay_matches_jax(jax_params):
    model = ASRModel(**CFG, device="cpu")
    decay, no_decay = tcommon.set_weight_decay(model.named_parameters())
    assert set(decay) == _mask_names(jax_params)
    assert set(decay) | set(no_decay) == {n for n, _ in model.named_parameters()}
    assert not set(decay) & set(no_decay)
    assert "encoder.layers.0.self_attn.pos_bias_u" in no_decay
    assert "encoder.layers.0.norm_ff.weight" in no_decay and "ctc_proj.weight" in decay


def test_adamw_decay_mask_matches_optax(jax_params):
    """One AdamW step with ``decay=`` from ``set_weight_decay`` against
    ``optax.adamw(mask=...)`` with the JAX mask, on the same gradients."""
    rng = np.random.default_rng(1)
    grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                   jax_params)
    tx = optax.adamw(1e-2, weight_decay=0.1, mask=jcommon.set_weight_decay(jax_params))
    updates, _ = tx.update(grads, tx.init(jax_params), jax_params)
    want = convert_params(optax.apply_updates(jax_params, updates))

    model = ASRModel(**CFG, device="cpu")
    model.load_state_dict(convert_params(jax_params), strict=True)
    decay, _ = tcommon.set_weight_decay(model.named_parameters())
    opt = AdamW(model.named_parameters(), 1e-2, weight_decay=0.1, decay=decay)
    tgrads = convert_params(grads)
    opt.step([tgrads[n] for n, _ in model.named_parameters()])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7)
    with pytest.raises(KeyError):
        AdamW(model.named_parameters(), 1e-2, decay=["no.such.weight"])


def test_step_timer_matches_jax(monkeypatch):
    """The same warm-up, last, average and ETA on the same clock readings."""
    ticks = iter(np.cumsum([0.0, 0.5, 0.1, 0.2, 0.1, 0.25, 0.1, 0.3] * 2))
    readings = [float(t) for t in ticks]
    timers = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        clock = iter(readings)
        monkeypatch.setattr(mod.time, "perf_counter", lambda clock=clock: next(clock))
        timer = mod.StepTimer(total_steps=10, warmup=1)
        for _ in range(4):
            with timer:
                pass
        timers[name] = (timer.count, timer.last_ms, timer.avg_ms, timer.eta_s, timer.summary())
    assert timers["port"] == timers["jax"]
    assert timers["port"][0] == 4 and timers["port"][2] == pytest.approx(250.0)


def test_trace_and_annotate_write_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("port_matmul"):
            (x @ x).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_matmul" for e in events)
    assert any(e.key == "port_matmul" for e in prof.key_averages())

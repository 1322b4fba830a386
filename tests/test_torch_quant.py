"""Port parity for weight-only int8 serving: quantization, the plain GEMM,
the CPU dispatch of the kernel's wrapper and the Linear swap.

The CUDA kernel itself runs only on the card: ``test_torch_kernels.py``
holds it against the plain version there, and ``python3 chip_smoke.py``
does so at every shape of the serving path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.ops import quant as jq
from mindaudio_torch.convert import convert_params, module_name
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.ops import quant as tq

torch.set_num_threads(1)


def _weights(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    w[:, 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    w[0, 1] = 0.3  # one large value sets its channel's scale
    return w


def bf16_ulp(y):
    """One bf16 ulp of each value (a bf16 keeps 8 significant bits)."""
    y = np.abs(np.asarray(y, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(y, np.finfo(np.float32).tiny))) - 7)


class TestQuantize:
    @pytest.mark.parametrize("k,n", [(64, 48), (256, 33), (7, 5)])
    def test_bit_identical_to_jax(self, k, n):
        w = _weights(np.random.default_rng(k), k, n)
        jv, js = jq.quantize_int8(w)
        tv, ts = tq.quantize_int8(torch.from_numpy(w))
        assert tv.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(ts.numpy().view(np.uint32), js.view(np.uint32))

    def test_dequantize(self):
        w = _weights(np.random.default_rng(1), 32, 16)
        v, s = jq.quantize_int8(w)
        np.testing.assert_array_equal(
            tq.dequantize_int8(torch.from_numpy(v), torch.from_numpy(s)).numpy(),
            np.asarray(jq.dequantize_int8(v, s)))


class TestInt8MatmulPlain:
    """The plain version against the JAX Pallas kernel in interpret mode.

    Both multiply the same bf16 operands exactly and sum in float32 in
    another order. A float32 output agrees to float32 rounding of the sum
    (1e-5 of max|y| at K <= 384); a bf16 output is that sum rounded once,
    so a value that falls next to a rounding boundary may round the other
    way: at most one bf16 ulp apart.
    """

    @pytest.mark.parametrize("m,k,n", [(10, 128, 200), (1, 256, 33), (37, 384, 129)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_interpret(self, m, k, n, dtype):
        rng = np.random.default_rng(m + n)
        x = rng.standard_normal((m, k)).astype(np.float32)
        v, s = jq.quantize_int8(_weights(rng, k, n))
        want = np.asarray(jq.int8_matmul(jnp.asarray(x, dtype), jnp.asarray(v),
                                          jnp.asarray(s), interpret=True).astype(jnp.float32))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        got = tq.int8_matmul_reference(tx, torch.from_numpy(v), torch.from_numpy(s))
        assert got.dtype == tx.dtype and got.shape == (m, n)
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        else:
            assert (np.abs(got - want) <= bf16_ulp(want)).all()

    def test_rounds_like_the_tpu_kernel(self):
        # scale and dequantized weight are rounded to bf16 (quant.py:71-72):
        # a scale just above a bf16 value is cut to it before the product
        v = torch.tensor([[127]], dtype=torch.int8)
        s = torch.tensor([1.0 + 2.0**-10])  # rounds to 1.0 in bf16
        y = tq.int8_matmul_reference(torch.ones(1, 1), v, s)
        assert y.item() == 127.0

    def test_cpu_dispatch_and_leading_dims(self):
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
        v, s = tq.quantize_int8(torch.from_numpy(_weights(rng, 64, 40)))
        before = tq.int8_matmul.launches
        y = tq.int8_matmul(x, v, s)
        assert tq.int8_matmul.launches == before  # the CPU takes the plain version
        assert y.shape == (2, 5, 40)
        assert torch.equal(y, tq.int8_matmul_reference(x, v, s))
        with pytest.raises(ValueError, match="device"):
            tq.int8_matmul(x.to("meta"), v.to("meta"), s.to("meta"))


def _tiny_jax_asr():
    from mindaudio_tpu.models.asr_model import ASRModel as JaxASR

    cfg = dict(vocab_size=16, input_dim=20, d_model=32, head_num=2, ffn_dim=64,
               num_encoder_layers=1, num_decoder_layers=1)
    model = JaxASR(**cfg)
    batch = {"feats": jnp.zeros((1, 32, 20)), "feat_lens": jnp.array([32]),
             "labels": jnp.zeros((1, 3), jnp.int32), "label_lens": jnp.array([3]),
             "ys_in": jnp.zeros((1, 4), jnp.int32), "ys_out": jnp.zeros((1, 4), jnp.int32),
             "ys_lens": jnp.array([4])}
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    return cfg, params


class TestModelQuantization:
    def test_tables_match_jax_by_module_name(self):
        cfg, params = _tiny_jax_asr()
        want = jq.quantize_dense_params(params, min_weights=512)
        model = ASRModel(**cfg, device="cpu")
        model.load_state_dict(convert_params(params))
        got = tq.quantize_dense_params(model, min_weights=512)
        assert set(got) == {module_name(path) for path in want}
        for path, (v, s) in want.items():
            tv, ts = got[module_name(path)]
            np.testing.assert_array_equal(tv.numpy(), v)
            np.testing.assert_array_equal(ts.numpy(), s)

    def test_swap_drops_the_float_weight(self):
        cfg, params = _tiny_jax_asr()
        model = ASRModel(**cfg, device="cpu")
        model.load_state_dict(convert_params(params))
        lin = model.decoder.output_layer
        x = torch.randn(3, 32, generator=torch.Generator().manual_seed(0))
        tables = tq.quantize_dense_params(model, min_weights=512)
        v, s = tables["decoder.output_layer"]
        tq.swap_quantized(model, tables)
        q = model.decoder.output_layer
        assert isinstance(q, tq.Int8Linear) and not hasattr(q, "weight")
        assert {n for n, _ in q.named_parameters()} == {"bias"}
        assert torch.equal(q(x), tq.int8_matmul_reference(x, v, s) + lin.bias)
        assert not any(isinstance(m, torch.nn.Linear) and m.weight.numel() >= 512
                       for m in model.modules())

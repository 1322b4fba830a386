"""The int8 GEMM's host side, on the CPU: the split-K chooser, the row-padded
weight layout of ``Int8Linear`` and the operands the wrapper hands the
kernel (views, not copies).

The kernel itself runs only on the card (``test_torch_kernels.py``,
``python3 chip_smoke.py``).
"""

import pathlib
import re

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
    return (rng.standard_normal((k, n)) * 0.05).astype(np.float32)


def _tiny_jax_asr(vocab):
    """A one-block JAX ASR model whose vocab projections (32 x ``vocab``)
    are large enough to quantize; parameters drawn with numpy."""
    from mindaudio_tpu.models.asr_model import ASRModel as JaxASR

    cfg = dict(vocab_size=vocab, input_dim=20, d_model=32, head_num=2, ffn_dim=64,
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


# (M, K, N) of every int8 GEMM of the served flagship Conformer (16 x 10 s,
# beam 10, 50 tokens), the one-request embed.out and the decoder FFN down
SERVED = {
    "embed_out": (4096, 4864, 256), "ffn_up": (4096, 256, 2048),
    "ffn_down": (4096, 2048, 256), "attention": (4096, 256, 256),
    "linear_pos": (256, 256, 256), "pointwise_conv1": (4096, 256, 512),
    "ctc_proj": (4096, 256, 4233), "decoder_attention": (8160, 256, 256),
    "cross_kv": (40960, 256, 256), "decoder_ffn_up": (8160, 256, 2048),
    "decoder_ffn_down": (8160, 2048, 256), "output_layer": (8160, 256, 4233),
    "one_request_embed_out": (256, 4864, 256),
}


class TestSplitK:
    @pytest.mark.parametrize("m", [1, 63, 128, 256, 1001, 4096, 40960])
    @pytest.mark.parametrize("k", [8, 64, 200, 256, 511, 2048, 4864, 100000])
    @pytest.mark.parametrize("n", [8, 256, 4233])
    def test_never_more_splits_than_k_stages(self, m, k, n):
        splits = tq.split_k(m, n, k)
        stages = -(-k // tq.TILE_K)
        assert 1 <= splits <= stages
        if splits > 1:  # few tiles only: the split fills the SMs, no more
            tiles = -(-m // tq.TILE_M) * -(-n // tq.TILE_N)
            assert tiles * splits <= 132

    @pytest.mark.parametrize("name", ["embed_out", "one_request_embed_out", "ffn_down"])
    def test_splits_the_few_tile_long_k_shapes(self, name):
        m, k, n = SERVED[name]
        assert tq.split_k(m, n, k) > 1

    @pytest.mark.parametrize("name", sorted(set(SERVED) - {"embed_out", "one_request_embed_out",
                                                           "ffn_down"}))
    def test_leaves_the_rest_whole(self, name):
        m, k, n = SERVED[name]
        assert tq.split_k(m, n, k) == 1

    @pytest.mark.parametrize("name,const", [("BM", "TILE_M"), ("BN", "TILE_N"),
                                            ("BK", "TILE_K")])
    def test_assumes_the_kernel_s_tile(self, name, const):
        """The chooser's tile is the kernel source's (the launcher checks the
        built kernel too)."""
        src = (pathlib.Path(tq.__file__).parent / "csrc" / "int8_matmul.cu").read_text()
        value = re.search(rf"constexpr int {name} = (\d+);", src)
        assert value and int(value.group(1)) == getattr(tq, const)

    def test_follows_the_sm_count(self):
        m, k, n = SERVED["one_request_embed_out"]
        assert tq.split_k(m, n, k, sms=8) == 2
        assert tq.split_k(m, n, k, sms=132) == 19  # 4 tiles; 76 stages, 4 per split


class TestPaddedLayout:
    @pytest.mark.parametrize("n", [4233, 256, 8, 17, 1])
    def test_reads_back_what_quantize_gave(self, n):
        w = torch.from_numpy(_weights(np.random.default_rng(n), 48, n))
        v, s = tq.quantize_int8(w)
        lin = tq.Int8Linear(v, s)
        assert lin.qweight.shape == (48, -(-n // 16) * 16)
        assert lin.qweight.stride(0) % tq.ROW_ALIGN == 0
        assert lin.values.shape == (48, n) and lin.scales.shape == (n,)
        assert torch.equal(lin.values, v) and torch.equal(lin.scales, s)
        assert not lin.qweight[:, n:].any()  # the padding is zeros

    def test_one_int8_copy_only(self):
        v, s = tq.quantize_int8(torch.randn(64, 4233, generator=torch.Generator().manual_seed(0)))
        lin = tq.Int8Linear(v, s)
        int8 = [b for b in lin.buffers() if b.dtype == torch.int8]
        assert len(int8) == 1 and int8[0].numel() == 64 * 4240
        assert lin.values.data_ptr() == lin.qweight.data_ptr()  # a view of it
        # a multiple of 16 already: the table's tensor is kept as it is
        v2, s2 = tq.quantize_int8(torch.randn(64, 256))
        assert tq.Int8Linear(v2, s2).qweight.data_ptr() == v2.data_ptr()

    def test_state_survives_a_move(self):
        v, s = tq.quantize_int8(torch.randn(32, 4233, generator=torch.Generator().manual_seed(1)))
        lin = tq.Int8Linear(v, s).to(torch.float64)  # casts floats only
        assert lin.qweight.stride(0) == 4240 and torch.equal(lin.values, v)
        assert lin.scales.dtype == torch.float64


class TestOperands:
    """What the wrapper hands the kernel: views of the tensors given."""

    def test_padded_values_view_is_not_copied(self):
        v, s = tq.quantize_int8(torch.randn(256, 4233, generator=torch.Generator().manual_seed(2)))
        view = tq.pad_int8_rows(v)[:, :4233]
        x = torch.randn(3, 7, 256)
        x2, ldx, w, ldw, s2 = tq._operands(x, view, s)
        assert w.data_ptr() == view.data_ptr() and ldw == 4240
        assert x2.data_ptr() == x.data_ptr() and ldx == 256 and x2.shape == (21, 256)
        assert s2.data_ptr() == s.data_ptr()
        tq._check(x, view, s)  # the wrapper's checks take the view

    def test_row_strided_x_is_not_copied(self):
        base = torch.randn(10, 300)
        x = base[:, 8:264]  # rows 300 apart, unit columns
        v, s = tq.quantize_int8(torch.randn(256, 64))
        x2, ldx, *_ = tq._operands(x, v, s)
        assert x2.data_ptr() == x.data_ptr() and ldx == 300

    def test_misaligned_x_is_not_copied(self):
        x = torch.randn(5 * 64 + 1)[1:].view(5, 64)  # 4 bytes past an aligned base
        v, s = tq.quantize_int8(torch.randn(64, 16))
        x2, ldx, *_ = tq._operands(x, v, s)
        assert x2.data_ptr() == x.data_ptr() and ldx == 64

    def test_transposed_operands_are_made_dense(self):
        x = torch.randn(64, 6).t()  # columns 6 apart
        v, s = tq.quantize_int8(torch.randn(64, 16))
        x2, ldx, w, ldw, _ = tq._operands(x, v.t().contiguous().t(), s)
        assert x2.is_contiguous() and ldx == 64 and w.is_contiguous() and ldw == 16

    def test_checks(self):
        v, s = tq.quantize_int8(torch.randn(64, 8))
        with pytest.raises(TypeError):
            tq._check(torch.randn(4, 64).half(), v, s)
        with pytest.raises(ValueError):
            tq._check(torch.randn(4, 32), v, s)
        with pytest.raises(TypeError):
            tq._check(torch.randn(4, 64), v.float(), s)


class TestServesFromJaxTables:
    """Int8Linear built from the JAX package's int8 tables (keyed by flax
    path, mapped by ``convert.module_name``) serves on the CPU exactly as
    the plain GEMM of those tables, padded layout or not."""

    @pytest.mark.parametrize("vocab", [19, 32])
    def test_layers_serve_as_before(self, vocab):
        cfg, params = _tiny_jax_asr(vocab)
        jax_tables = jq.quantize_dense_params(params, min_weights=512)
        tables = {module_name(path): (torch.from_numpy(np.asarray(v)),
                                      torch.from_numpy(np.asarray(s)))
                  for path, (v, s) in jax_tables.items()}
        model = ASRModel(**cfg, device="cpu")
        model.load_state_dict(convert_params(params))
        biases = {name: model.get_submodule(name).bias for name in tables}
        tq.swap_quantized(model, tables)
        rng = np.random.default_rng(5)
        padded = 0
        for name, (v, s) in tables.items():
            layer = model.get_submodule(name)
            assert torch.equal(layer.values, v) and torch.equal(layer.scales, s)
            padded += layer.qweight.shape[1] != v.shape[1]
            x = torch.from_numpy(rng.standard_normal((3, v.shape[0])).astype(np.float32))
            want = tq.int8_matmul_reference(x, v, s) + biases[name]
            assert torch.equal(layer(x), want)
        # N = 19: ctc_proj and output_layer are held padded to 32 columns
        assert padded == (2 if vocab % 16 else 0)

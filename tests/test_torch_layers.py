"""Port parity: every layer of ``mindaudio_torch.models`` against its flax
original, on the same numpy inputs and converted parameters.

Parameters take the shapes flax's ``init`` gives them and values drawn with
numpy, so that biases, LayerNorm scales and position biases are not at their
initial zeros and ones: a converter that dropped or misplaced a leaf would
show.

Both sides compute in float32 on the CPU; the sums run in another order, so
outputs agree to float32 rounding. ``ATOL``/``RTOL`` = 1e-4 leaves a
hundredfold margin over the ~1e-6 differences seen at these toy sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.models import conformer as jconf
from mindaudio_tpu.models import layers as jl
from mindaudio_torch.convert import convert_params, module_name
from mindaudio_torch.models import conformer as tconf
from mindaudio_torch.models import layers as tl

torch.set_num_threads(1)

ATOL = RTOL = 1e-4


def _init(module, seed, *args, **kwargs):
    """Random flax params of ``module`` for ``args``, drawn with numpy."""
    return random_params(jax.eval_shape(module.init, jax.random.PRNGKey(seed),
                                        *args, **kwargs)["params"], seed)


def random_params(shapes, seed):
    """numpy params for a flax shape tree: fan-in-scaled normal matrices and
    kernels, LayerNorm scales near 1, small nonzero biases."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        n = rng.standard_normal(leaf.shape)
        if path[-1].key == "scale":
            n = 1.0 + 0.1 * n
        elif len(leaf.shape) >= 2:
            n = n / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(torch_module, params):
    """Load converted params into ``torch_module`` (strict: every leaf used,
    every port parameter set) and put it in eval mode."""
    torch_module.load_state_dict(convert_params(params), strict=True)
    return torch_module.eval()


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestSmallLayers:
    def test_apply_mask_fills_in_scores_dtype(self, rng):
        s = rng.standard_normal((2, 3, 4)).astype(np.float32)
        m = rng.random((2, 1, 4)) > 0.4
        _close(tl.apply_mask(_t(s), _t(m)), jl.apply_mask(jnp.asarray(s), jnp.asarray(m)), 0, 0)
        got = tl.apply_mask(_t(s).to(torch.bfloat16), _t(m))
        assert got.dtype == torch.bfloat16
        assert got.float()[~_t(np.broadcast_to(m, s.shape))].eq(
            float(torch.tensor(-1e9, dtype=torch.bfloat16))).all()

    def test_fast_dropout(self):
        x = torch.ones(64, 256)
        d = tl.FastDropout(0.1)
        assert torch.equal(d.eval()(x), x)  # identity at eval
        d.train()
        with pytest.raises(RuntimeError, match="generator"):
            d(x)
        d.generator = torch.Generator().manual_seed(0)
        y = d(x)
        thresh = round(0.1 * 256)
        keep = (256 - thresh) / 256
        kept = y != 0
        # kept values are rescaled by exactly 1/keep_prob ...
        assert torch.equal(y[kept], torch.full_like(y[kept], 1 / keep))
        # ... and P(keep) = (256 - round(256 r)) / 256: 16384 draws, 5 sigma
        frac = kept.float().mean().item()
        assert abs(frac - keep) < 5 * (keep * (1 - keep) / x.numel()) ** 0.5
        assert torch.equal(tl.FastDropout(1.0).train()(x), torch.zeros_like(x))

    def test_swish_glu_cmvn(self, rng):
        x = rng.standard_normal((2, 5, 8)).astype(np.float32)
        _close(tl.Swish()(_t(x)), jl.Swish().apply({}, jnp.asarray(x)))
        _close(tl.GLU()(_t(x)), jl.GLU().apply({}, jnp.asarray(x)))
        mean, istd = rng.standard_normal(8), rng.random(8) + 0.5
        j = jl.GlobalCMVN(jnp.asarray(mean, jnp.float32),
                          jnp.asarray(istd, jnp.float32)).apply({}, jnp.asarray(x))
        _close(tl.GlobalCMVN(mean, istd)(_t(x)), j)

    def test_positionwise_feed_forward(self, rng):
        x = rng.standard_normal((2, 7, 16)).astype(np.float32)
        jm = jl.PositionwiseFeedForward(48, activation=jax.nn.relu)
        p = _init(jm, 1, jnp.asarray(x))
        tm = _port(tl.PositionwiseFeedForward(16, 48), p)
        _close(tm(_t(x)), jm.apply({"params": p}, jnp.asarray(x)))

    def test_position_encodings(self, rng):
        np.testing.assert_array_equal(tl.sinusoid_table(50, 16), jl.sinusoid_table(50, 16))
        x = rng.standard_normal((2, 9, 16)).astype(np.float32)
        for offset in (0, 5):
            jx, jpos = jl.PositionalEncoding(16).apply({}, jnp.asarray(x), offset=offset)
            tx, tpos = tl.PositionalEncoding(16).eval()(_t(x), offset=offset)
            _close(tx, jx, 1e-6, 1e-6)
            _close(tpos, jpos, 0, 0)
            jx, jpos = jl.RelPositionalEncoding(16).apply({}, jnp.asarray(x), offset=offset)
            tx, tpos = tl.RelPositionalEncoding(16).eval()(_t(x), offset=offset)
            _close(tx, jx, 1e-6, 1e-6)  # scaled only: the table is not added
            _close(tpos, jpos, 0, 0)


class TestAttention:
    D, H = 32, 4

    def test_multi_headed_attention(self, rng):
        q = rng.standard_normal((2, 5, self.D)).astype(np.float32)
        kv = rng.standard_normal((2, 7, self.D)).astype(np.float32)
        mask = np.ones((2, 1, 7), bool)
        mask[1, 0, 4:] = False
        jm = jl.MultiHeadedAttention(self.H)
        p = _init(jm, 2, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
        tm = _port(tl.MultiHeadedAttention(self.D, self.H), p)
        for m in (None, mask, np.tril(np.ones((5, 7), bool))[None].repeat(2, 0)):
            want = jm.apply({"params": p}, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                            mask=None if m is None else jnp.asarray(m))
            _close(tm(_t(q), _t(kv), _t(kv), mask=None if m is None else _t(m)), want)

    def test_rel_position_attention(self, rng):
        x = rng.standard_normal((2, 6, self.D)).astype(np.float32)
        pos = jl.sinusoid_table(6, self.D)[None]
        mask = np.ones((2, 1, 6), bool)
        mask[0, 0, 3:] = False
        jm = jl.RelPositionMultiHeadedAttention(self.H)
        jx = jnp.asarray(x)
        p = _init(jm, 3, jx, jx, jx, pos_emb=jnp.asarray(pos))
        tm = _port(tl.RelPositionMultiHeadedAttention(self.D, self.H), p)
        want = jm.apply({"params": p}, jx, jx, jx, mask=jnp.asarray(mask), pos_emb=jnp.asarray(pos))
        _close(tm(_t(x), _t(x), _t(x), mask=_t(mask), pos_emb=_t(pos)), want)

    def test_rel_position_attention_kv_cache(self, rng):
        x = rng.standard_normal((1, 3, self.D)).astype(np.float32)
        cache = [rng.standard_normal((1, self.H, 4, self.D // self.H)).astype(np.float32)
                 for _ in range(2)]
        pos = jl.sinusoid_table(7, self.D)[None]  # spans cache + chunk
        jm = jl.RelPositionMultiHeadedAttention(self.H)
        jx, jcache = jnp.asarray(x), tuple(jnp.asarray(c) for c in cache)
        p = _init(jm, 4, jx, jx, jx, pos_emb=jnp.asarray(pos), kv_cache=jcache)
        tm = _port(tl.RelPositionMultiHeadedAttention(self.D, self.H), p)
        jout, (jk, jv) = jm.apply({"params": p}, jx, jx, jx, pos_emb=jnp.asarray(pos),
                                  kv_cache=jcache)
        tout, (tk, tv) = tm(_t(x), _t(x), _t(x), pos_emb=_t(pos),
                            kv_cache=tuple(_t(c) for c in cache))
        _close(tout, jout)
        _close(tk, jk)
        _close(tv, jv)


class TestConvBlocks:
    @pytest.mark.parametrize("causal", [False, True])
    def test_convolution_module(self, rng, causal):
        x = rng.standard_normal((2, 11, 16)).astype(np.float32)
        mask_pad = np.ones((2, 11), bool)
        mask_pad[1, 7:] = False
        jm = jl.ConvolutionModule(kernel_size=5, norm_type="layer_norm", causal=causal)
        p = _init(jm, 5, jnp.asarray(x), mask_pad=jnp.asarray(mask_pad))
        tm = _port(tl.ConvolutionModule(16, kernel_size=5, causal=causal), p)
        for m in (mask_pad, None):
            want = jm.apply({"params": p}, jnp.asarray(x),
                            mask_pad=None if m is None else jnp.asarray(m))
            _close(tm(_t(x), mask_pad=None if m is None else _t(m)), want)

    def test_conv2d_subsampling4(self, rng):
        x = rng.standard_normal((2, 29, 20)).astype(np.float32)
        jm = jl.Conv2dSubsampling4(16)
        p = _init(jm, 6, jnp.asarray(x))
        tm = _port(tl.Conv2dSubsampling4(20, 16), p)
        jx, jpos = jm.apply({"params": p}, jnp.asarray(x))
        tx, tpos = tm(_t(x))
        assert tx.shape == (2, tl.Conv2dSubsampling4.output_len(29), 16)
        _close(tx, jx)
        _close(tpos, jpos, 0, 0)


class TestConformerBlocks:
    D, H, FFN = 32, 4, 64

    def _enc_inputs(self, rng, t=8):
        x = rng.standard_normal((2, t, self.D)).astype(np.float32)
        lens = np.array([t, t - 3])
        mask = (np.arange(t)[None] < lens[:, None])[:, None, :]
        pos = jl.sinusoid_table(t, self.D)[None]
        return x, mask, pos

    def test_encoder_layer(self, rng):
        x, mask, pos = self._enc_inputs(rng)
        jm = jconf.ConformerEncoderLayer(self.D, self.H, self.FFN, kernel_size=5)
        args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(mask[:, 0]))
        p = _init(jm, 7, *args)
        tm = _port(tconf.ConformerEncoderLayer(self.D, self.H, self.FFN, kernel_size=5), p)
        _close(tm(_t(x), _t(mask), _t(pos), _t(mask[:, 0])), jm.apply({"params": p}, *args))

    def test_encoder_chunk_masked(self, rng):
        feats = rng.standard_normal((2, 37, 20)).astype(np.float32)
        lens = np.array([37, 25])
        cmvn = (rng.standard_normal(20).astype(np.float32), (rng.random(20) + 0.5).astype(np.float32))
        kw = dict(input_dim=20, d_model=self.D, head_num=self.H, ffn_dim=self.FFN,
                  num_layers=2, kernel_size=5, static_chunk_size=3)
        jm = jconf.ConformerEncoder(**kw, cmvn_mean=jnp.asarray(cmvn[0]),
                                    cmvn_istd=jnp.asarray(cmvn[1]))
        p = _init(jm, 8, jnp.asarray(feats), jnp.asarray(lens))
        tm = tconf.ConformerEncoder(**kw, cmvn_mean=cmvn[0], cmvn_istd=cmvn[1])
        missing, unexpected = tm.load_state_dict(convert_params(p), strict=False)
        # the CMVN statistics are module attributes in flax, buffers here
        assert sorted(missing) == ["global_cmvn.istd", "global_cmvn.mean"] and not unexpected
        tm.eval()
        jout, jmask = jm.apply({"params": p}, jnp.asarray(feats), jnp.asarray(lens))
        tout, tmask = tm(_t(feats), _t(lens))
        _close(tmask, jmask, 0, 0)
        _close(tout, jout)

    def test_decoder(self, rng):
        vocab = 12
        memory = rng.standard_normal((2, 9, self.D)).astype(np.float32)
        mem_mask = np.ones((2, 1, 9), bool)
        mem_mask[1, 0, 6:] = False
        ys = rng.integers(0, vocab, (2, 5))
        ys_lens = np.array([5, 3])
        kw = dict(d_model=self.D, head_num=self.H, ffn_dim=self.FFN, num_layers=2)
        jm = jconf.TransformerDecoder(vocab, **kw)
        args = (jnp.asarray(memory), jnp.asarray(mem_mask), jnp.asarray(ys), jnp.asarray(ys_lens))
        p = _init(jm, 9, *args)
        tm = _port(tconf.TransformerDecoder(vocab, **kw), p)
        targs = (_t(memory), _t(mem_mask), _t(ys), _t(ys_lens))
        _close(tm(*targs), jm.apply({"params": p}, *args))
        want = jm.apply({"params": p}, *args[:3], method=jm.forward_one_step)
        _close(tm.forward_one_step(*targs[:3]), want)

    def test_decoder_layer(self, rng):
        tgt = rng.standard_normal((2, 4, self.D)).astype(np.float32)
        memory = rng.standard_normal((2, 6, self.D)).astype(np.float32)
        tgt_mask = np.tril(np.ones((4, 4), bool))[None].repeat(2, 0)
        mem_mask = np.ones((2, 1, 6), bool)
        jm = jconf.DecoderLayer(self.D, self.H, self.FFN)
        args = (jnp.asarray(tgt), jnp.asarray(tgt_mask), jnp.asarray(memory), jnp.asarray(mem_mask))
        p = _init(jm, 10, *args)
        tm = _port(tconf.DecoderLayer(self.D, self.H, self.FFN), p)
        _close(tm(_t(tgt), _t(tgt_mask), _t(memory), _t(mem_mask)), jm.apply({"params": p}, *args))


class TestConvert:
    def test_layouts(self):
        params = {
            "Dense_0": {"kernel": np.arange(6.0).reshape(2, 3), "bias": np.ones(3)},
            "Conv_0": {"kernel": np.arange(24.0).reshape(2, 3, 1, 4)},  # HWIO
            "depthwise_conv": {"kernel": np.arange(10.0).reshape(5, 1, 2)},
            "norm": {"scale": np.ones(2), "bias": np.zeros(2)},
            "embed": {"embedding": np.eye(3)},
        }
        s = convert_params(params)
        assert s["w_1.weight"].shape == (3, 2) and s["w_1.bias"].shape == (3,)
        np.testing.assert_array_equal(s["conv1.weight"].numpy(),
                                      params["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(s["depthwise_conv.weight"].numpy(),
                                      params["depthwise_conv"]["kernel"].transpose(2, 1, 0))
        assert set(s) >= {"norm.weight", "norm.bias", "embed.weight"}
        assert all(v.dtype == torch.float32 and v.is_contiguous() for v in s.values())

    def test_module_name(self):
        assert module_name(("encoder", "layer_11", "feed_forward", "Dense_1")) \
            == "encoder.layers.11.feed_forward.w_2"
        assert module_name(("encoder", "embed", "out")) == "encoder.embed.out"
        assert module_name(("decoder", "output_layer")) == "decoder.output_layer"

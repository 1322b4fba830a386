"""Port parity for streaming decode and the rest of serving, against the JAX
package on the same numpy inputs and converted parameters, at toy widths
(2 layers, d_model 32, 2 heads, conv kernel 7, chunks of C = 4 subsampled
frames, i.e. 19 raw frames stepping 16).

- ``ConformerEncoder.forward_chunk`` and ``ASRModel.encode_chunk`` against
  JAX's, chunk by chunk: outputs and both caches, with the full history
  (cap -1) and caps 0 and 8. Float32 on both sides, sums in another order:
  ``ATOL`` = ``RTOL`` = 1e-4 (the differences seen are ~1e-6).
- The port's stream against the port's chunk-masked full encode
  (``encode(decoding_chunk_size=C)``): the same arithmetic, cut
  differently, so ``EXACT_ATOL`` = 2e-5, JAX's own bound for the same check.
- ``streaming_ctc_greedy`` hypotheses equal to JAX's, weights in float32
  and in int8 (JAX's Pallas kernel in interpret mode; both sides multiply
  the same bf16 operands).
- The causal ``ConvolutionModule`` with its cache against JAX; the
  module-level decode functions against the methods, their LRU, and their
  rebuilding of a private copy after the caller's weights change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.models import conformer as jconf
from mindaudio_tpu.models import layers as jl
from mindaudio_tpu.models.asr_model import ASRModel as JaxASR
from mindaudio_tpu.utils.recognize import ASRInference as JaxInference
from mindaudio_torch.convert import convert_params
from mindaudio_torch.models import conformer as tconf
from mindaudio_torch.models import layers as tl
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.recipes.conformer.predict import stream_chunks
from mindaudio_torch.utils import recognize

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
EXACT_ATOL = 2e-5
C, FEAT, VOCAB = 4, 16, 12
ENC = dict(d_model=32, head_num=2, ffn_dim=64, kernel_size=7)


def _draw(shapes, seed):
    """numpy values for a flax variables tree: fan-in-scaled matrices and
    kernels, scales near 1, small biases and means, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        n = rng.standard_normal(leaf.shape)
        key = path[-1].key
        if key == "scale":
            n = 1.0 + 0.1 * n
        elif key == "var":
            n = rng.uniform(0.5, 1.5, leaf.shape)
        elif len(leaf.shape) >= 2:
            n = 1.5 * n / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _feats(seed, b, n_chunks):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 4 * C * n_chunks + 3, FEAT)).astype(np.float32)


def _chunks(x):
    return [x[:, lo: lo + 4 * C + 3] for lo in range(0, x.shape[1] - 3, 4 * C)]


@pytest.fixture(scope="module")
def encoders():
    """The JAX encoder and its variables, and the port's on the same values."""
    jm = jconf.ConformerEncoder(input_dim=FEAT, num_layers=2, causal_conv=True, **ENC)
    x = jnp.zeros((1, 4 * C + 3, FEAT))
    variables = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, jnp.array([19])),
                      seed=1)
    tm = tconf.ConformerEncoder(input_dim=FEAT, num_layers=2, causal_conv=True, **ENC)
    tm.load_state_dict(convert_params(variables["params"]), strict=True)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("cap", [-1, 0, 8])
def test_forward_chunk_matches_jax(encoders, cap):
    jm, variables, tm = encoders
    x = _feats(2, 2, n_chunks=4)
    j_att = j_cnn = t_att = t_cnn = None
    for i, chunk in enumerate(_chunks(x)):
        j_ys, j_att, j_cnn = jm.apply(variables, jnp.asarray(chunk), j_att, j_cnn, cap,
                                      method=jm.forward_chunk)
        with torch.no_grad():
            t_ys, t_att, t_cnn = tm.forward_chunk(torch.from_numpy(chunk), t_att, t_cnn, cap)
        assert t_ys.shape == (2, C, ENC["d_model"])
        _close(t_ys, j_ys)
        cached = (i + 1) * C if cap < 0 else min((i + 1) * C, cap)
        for (tk, tv), (jk, jv), tc, jc in zip(t_att, j_att, t_cnn, j_cnn):
            assert tk.shape == tv.shape == (2, ENC["head_num"], cached, 16)
            assert tc.shape == (2, ENC["kernel_size"] - 1, ENC["d_model"])
            _close(tk, jk)
            _close(tv, jv)
            _close(tc, jc)


def test_forward_chunk_needs_a_causal_conv():
    tm = tconf.ConformerEncoder(input_dim=FEAT, num_layers=1, **ENC)
    with pytest.raises(ValueError, match="causal_conv"):
        tm.forward_chunk(torch.zeros(1, 19, FEAT))


MODEL = dict(vocab_size=VOCAB, input_dim=FEAT, num_encoder_layers=2, num_decoder_layers=1,
             causal_conv=True, **ENC)


@pytest.fixture(scope="module")
def models():
    """The JAX ASR model (chunk masks of size C) and its params, and the
    port's on the same weights (dynamic chunks, so that ``encode`` takes
    ``decoding_chunk_size``)."""
    jm = JaxASR(static_chunk_size=C, **MODEL)
    batch = {"feats": jnp.zeros((1, 35, FEAT)), "feat_lens": jnp.array([35]),
             "labels": jnp.zeros((1, 2), jnp.int32), "label_lens": jnp.array([2]),
             "ys_in": jnp.zeros((1, 3), jnp.int32), "ys_out": jnp.zeros((1, 3), jnp.int32),
             "ys_lens": jnp.array([3])}
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)["params"], seed=3)
    tm = ASRModel(use_dynamic_chunk=True, device="cpu", **MODEL)
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("cap", [-1, 0, 8])
def test_encode_chunk_matches_jax(models, cap):
    jm, params, tm = models
    x = _feats(4, 1, n_chunks=4)
    j_att = j_cnn = t_att = t_cnn = None
    for chunk in _chunks(x):
        j_lp, j_att, j_cnn = jm.apply({"params": params}, jnp.asarray(chunk), j_att, j_cnn, cap,
                                      method=jm.encode_chunk)
        with torch.no_grad():
            t_lp, t_att, t_cnn = tm.encode_chunk(torch.from_numpy(chunk), t_att, t_cnn, cap)
        assert t_lp.dtype == torch.float32 and t_lp.shape == (1, C, VOCAB)
        _close(t_lp, j_lp)
        for (tk, tv), (jk, jv), tc, jc in zip(t_att, j_att, t_cnn, j_cnn):
            _close(tk, jk)
            _close(tv, jv)
            _close(tc, jc)


@pytest.mark.parametrize("raw", [83, 70, 100])  # whole chunks, then a last partial one
def test_stream_equals_the_chunk_masked_encode(models, raw):
    _, _, tm = models
    x = torch.from_numpy(np.random.default_rng(raw).standard_normal((1, raw, FEAT)).astype(
        np.float32))
    with torch.no_grad():
        enc_out, _ = tm.encode(x, torch.tensor([raw]), decoding_chunk_size=C)
        full = tm.ctc_log_probs(enc_out)
        att = cnn = None
        streamed = []
        for chunk in stream_chunks(x, raw, C):
            lp, att, cnn = tm.encode_chunk(chunk, att, cnn)
            streamed.append(lp)
    streamed = torch.cat(streamed, dim=1)
    assert streamed.shape == full.shape
    _close(streamed, full, atol=EXACT_ATOL, rtol=0)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("cap", [-1, 8])
def test_streaming_ctc_greedy_matches_jax(models, quant, cap):
    jm, params, tm = models
    kw = dict(beam_size=2, weight_quant=quant, weight_quant_min_size=512)
    j_inf, t_inf = JaxInference(jm, {"params": params}, **kw), recognize.ASRInference(tm, **kw)
    chunks = _chunks(_feats(5, 1, n_chunks=4))
    want = j_inf.streaming_ctc_greedy(chunks, required_cache_size=cap)
    got = t_inf.streaming_ctc_greedy(chunks, required_cache_size=cap)
    assert got == want
    assert len(got) > 2  # the random weights emit tokens


def test_conv_module_cache_matches_jax():
    jm = jl.ConvolutionModule(kernel_size=5, norm_type="layer_norm", causal=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    cache = rng.standard_normal((2, 4, 16)).astype(np.float32)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 7)
    tm = tl.ConvolutionModule(16, kernel_size=5, causal=True)
    tm.load_state_dict(convert_params(params), strict=True)
    want, want_cache = jm.apply({"params": params}, jnp.asarray(x), cache=jnp.asarray(cache))
    with torch.no_grad():
        got, got_cache = tm.eval()(torch.from_numpy(x), cache=torch.from_numpy(cache))
    _close(got, want)
    _close(got_cache, want_cache)
    with pytest.raises(ValueError, match="causal"):
        tl.ConvolutionModule(16, kernel_size=5)(torch.from_numpy(x), cache=torch.from_numpy(cache))


def test_unknown_pos_enc_raises():
    with pytest.raises(ValueError, match="unknown pos_enc"):
        tl.Conv2dSubsampling4(FEAT, 16, pos_enc="rel-pos")


def test_module_functions_match_the_methods_and_cache(models):
    _, _, tm = models
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 40, FEAT)).astype(np.float32))
    lens = torch.tensor([40, 31])
    recognize._inference_cache.clear()
    inf = recognize.ASRInference(tm, beam_size=3, max_tgt_len=5)
    got = recognize.ctc_greedy_search(tm, x, lens, beam_size=3, max_tgt_len=5)
    assert got[0] == inf.ctc_greedy_search(x, lens)[0]
    np.testing.assert_array_equal(got[1], inf.ctc_greedy_search(x, lens)[1])
    assert recognize.ctc_prefix_beam_search(tm, x, lens, beam_size=3, max_tgt_len=5)[0] == \
        inf.ctc_prefix_beam_search_batch(x, lens)[0]
    assert recognize.ctc_prefix_beam_search(tm, x[:1], lens[:1], beam_size=3,
                                            max_tgt_len=5)[0] == \
        inf.ctc_prefix_beam_search(x[:1], lens[:1])[0]
    assert recognize.recognize(tm, x, lens, beam_size=3, max_tgt_len=5) == \
        inf.recognize_batch(x, lens)
    assert recognize.attention_rescoring(tm, x[1:], lens[1:], beam_size=3, max_tgt_len=5) == \
        inf.attention_rescoring(x[1:], lens[1:])
    # the greedy and beam calls share one entry; rescoring adds ctc_weight
    assert len(recognize._inference_cache) == 2

    recognize._inference_cache.clear()
    first = recognize._cached_inference(tm, beam_size=3)
    assert recognize._cached_inference(tm, beam_size=3) is first  # a hit
    second = recognize._cached_inference(tm, beam_size=4)
    for beam in range(5, 12):  # 9 entries in all: the least recently used goes
        recognize._cached_inference(tm, beam_size=beam)
    assert len(recognize._inference_cache) == recognize._INFERENCE_LRU_MAX == 8
    assert recognize._cached_inference(tm, beam_size=4) is second
    assert recognize._cached_inference(tm, beam_size=3) is not first  # evicted: built anew
    assert all(entry[0] is tm for entry in recognize._inference_cache.values())
    recognize._inference_cache.clear()


@pytest.mark.parametrize("opts", [dict(weight_quant="int8", weight_quant_min_size=512),
                                  dict(dtype=torch.bfloat16), dict()])
def test_module_functions_follow_new_weights(models, opts):
    """An instance that decodes a private copy (int8, or another dtype) is
    rebuilt when the caller's model gets new weights in place; the cached
    one is kept while they stay."""
    _, _, tm = models
    model = ASRModel(use_dynamic_chunk=True, device="cpu", **MODEL)
    model.load_state_dict(tm.state_dict())
    model.eval()
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((2, 40, FEAT)).astype(
        np.float32))
    lens = torch.tensor([40, 33])
    recognize._inference_cache.clear()
    before = recognize.ctc_greedy_search(model, x, lens, **opts)[0]
    first = recognize._cached_inference(model, **opts)
    assert recognize._cached_inference(model, **opts) is first  # same weights: a hit

    other = ASRModel(use_dynamic_chunk=True, device="cpu", **MODEL).reset_parameters(
        torch.Generator().manual_seed(15))
    model.load_state_dict(other.state_dict())  # new weights, copied in place
    after = recognize.ctc_greedy_search(model, x, lens, **opts)[0]
    assert after == recognize.ASRInference(other.eval(), **opts).ctc_greedy_search(x, lens)[0]
    assert after != before
    assert len(recognize._inference_cache) == 1  # the stale entry was replaced

    with torch.no_grad():  # an optimizer's in-place step
        model.ctc_proj.bias.add_(5.0 * torch.arange(VOCAB, dtype=torch.float32))
    stepped = recognize.ctc_greedy_search(model, x, lens, **opts)[0]
    assert stepped == recognize.ASRInference(model, **opts).ctc_greedy_search(x, lens)[0]
    assert stepped != after
    recognize._inference_cache.clear()

"""Port parity for the serving slice: ``ASRModel``'s inference pieces, the
four decode modes of ``ASRInference`` (float and int8-served weights) and
waveform → ``kaldi_fbank`` → decode as a whole, against the JAX package on
the same numpy inputs and weights.

Tolerances: the model pieces compute in float32 on both sides with sums in
another order, so they agree to ~1e-6; ``ATOL`` = 1e-4 leaves a wide margin.
Decoded token sequences must be equal; their scores are sums of such
log-probs over at most a few dozen frames and tokens, so ``SCORE_ATOL`` =
1e-3. The JAX int8 path runs the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.models.asr_model import ASRModel as JaxASR
from mindaudio_tpu.ops.spectral import kaldi_fbank as jax_fbank
from mindaudio_tpu.utils.recognize import ASRInference as JaxInference
from mindaudio_torch.convert import convert_params
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.ops import quant as tq
from mindaudio_torch.ops.spectral import kaldi_fbank
from mindaudio_torch.utils.recognize import ASRInference

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
SCORE_ATOL = 1e-3
CFG = dict(vocab_size=16, input_dim=20, d_model=32, head_num=2, ffn_dim=64,
           num_encoder_layers=1, num_decoder_layers=1)
DECODE = dict(beam_size=3, max_tgt_len=6)


@pytest.fixture(scope="module")
def models():
    """The JAX model and its params, and the port's model on the same weights
    (numpy draws, fan-in-scaled so that the posteriors are not flat)."""
    jm = JaxASR(**CFG)
    batch = {"feats": jnp.zeros((1, 32, 20)), "feat_lens": jnp.array([32]),
             "labels": jnp.zeros((1, 3), jnp.int32), "label_lens": jnp.array([3]),
             "ys_in": jnp.zeros((1, 4), jnp.int32), "ys_out": jnp.zeros((1, 4), jnp.int32),
             "ys_lens": jnp.array([4])}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)

    def draw(path, s):
        n = rng.standard_normal(s.shape)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * n).astype(np.float32)
        scale = 0.1 if len(s.shape) < 2 else 1.5 / np.sqrt(np.prod(s.shape[:-1]))
        return (scale * n).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tm = ASRModel(**CFG, device="cpu")
    tm.load_state_dict(convert_params(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(1)
    return rng.standard_normal((2, 32, 20)).astype(np.float32), np.array([32, 23], np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=RTOL)


def test_model_pieces(models, feats):
    jm, params, tm = models
    x, lens = feats
    v = {"params": params}
    j_out, j_mask = jm.apply(v, jnp.asarray(x), jnp.asarray(lens), method=jm.encode)
    with torch.no_grad():
        t_out, t_mask = tm.encode(torch.from_numpy(x), torch.from_numpy(lens).long())
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
        _close(t_out, j_out)
        _close(tm.ctc_log_probs(t_out), jm.apply(v, j_out, method=jm.ctc_log_probs))

        ys = np.array([[15, 3, 7, 1], [15, 2, 15, 15]])
        ys_lens = np.array([4, 2])
        want = jm.apply(v, j_out, j_mask, jnp.asarray(ys), jnp.asarray(ys_lens),
                        method=jm.decoder_logits)
        got = tm.decoder_logits(t_out, t_mask, torch.from_numpy(ys), torch.from_numpy(ys_lens))
        _close(got, want)
        want = jm.apply(v, j_out, j_mask, jnp.asarray(ys), method=jm.decode_step)
        _close(tm.decode_step(t_out, t_mask, torch.from_numpy(ys)), want)


@pytest.fixture(scope="module", params=["none", "int8"])
def decoders(request, models):
    jm, params, tm = models
    kw = dict(DECODE, weight_quant=request.param, weight_quant_min_size=512)
    return JaxInference(jm, {"params": params}, **kw), ASRInference(tm, **kw)


def _same_hyps(got, want):
    assert [list(h) for h, _ in got] == [list(h) for h, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=SCORE_ATOL)


def test_ctc_greedy(decoders, feats):
    jax_inf, inf = decoders
    j_hyps, j_scores = jax_inf.ctc_greedy_search(*feats)
    t_hyps, t_scores = inf.ctc_greedy_search(*feats)
    assert t_hyps == j_hyps
    np.testing.assert_allclose(t_scores, j_scores, atol=SCORE_ATOL)


def test_ctc_prefix_beam(decoders, feats):
    jax_inf, inf = decoders
    j_batch, _, _ = jax_inf.ctc_prefix_beam_search_batch(*feats)
    t_batch, enc_out, enc_mask = inf.ctc_prefix_beam_search_batch(*feats)
    assert enc_out.shape == (2, 7, CFG["d_model"]) and enc_mask.shape == (2, 1, 7)
    for got, want in zip(t_batch, j_batch):
        _same_hyps(got, want)
    x, lens = feats
    _same_hyps(inf.ctc_prefix_beam_search(x[1:], lens[1:])[0],
               jax_inf.ctc_prefix_beam_search(x[1:], lens[1:])[0])


def test_attention_beam(decoders, feats):
    jax_inf, inf = decoders
    _same_hyps(inf.recognize_batch(*feats), jax_inf.recognize_batch(*feats))
    x, lens = feats
    _same_hyps([inf.recognize(x[:1], lens[:1])], [jax_inf.recognize(x[:1], lens[:1])])
    with pytest.raises(ValueError, match="recognize_batch"):
        inf.recognize(x, lens)


def test_attention_rescoring(decoders, feats):
    jax_inf, inf = decoders
    _same_hyps(inf.attention_rescoring_batch(*feats), jax_inf.attention_rescoring_batch(*feats))
    x, lens = feats
    _same_hyps([inf.attention_rescoring(x[1:], lens[1:])],
               [jax_inf.attention_rescoring(x[1:], lens[1:])])


def test_int8_serving_swaps_every_large_linear(models):
    _, _, tm = models
    inf = ASRInference(tm, weight_quant="int8", weight_quant_min_size=512)
    swapped = [n for n, m in inf.model.named_modules() if isinstance(m, tq.Int8Linear)]
    assert len(swapped) == len(tq.quantize_dense_params(tm, 512)) > 0
    # the caller's model keeps its float weights
    assert not any(isinstance(m, tq.Int8Linear) for m in tm.modules())
    with pytest.raises(ValueError, match="weight_quant"):
        ASRInference(tm, weight_quant="int4")


def test_waveform_to_hypotheses(models):
    """The slice as a whole: waveforms → kaldi_fbank → int8-served attention
    rescoring, on both sides."""
    jm, params, tm = models
    rng = np.random.default_rng(2)
    wav = (0.2 * rng.standard_normal((2, 5200))).astype(np.float32)
    wav[1, 3900:] = 0.0
    lens = np.array([31, 22], np.int32)  # frames of 5200 and 3900 samples
    j_feats = np.asarray(jax_fbank(jnp.asarray(wav), num_mel_bins=20))
    t_feats = kaldi_fbank(wav, num_mel_bins=20, device="cpu")
    assert t_feats.shape == (2, 31, 20)
    # log-mel of ×32768-scaled audio: float32 rounding, see test_torch_frontend
    np.testing.assert_allclose(t_feats.numpy(), j_feats, atol=2e-4, rtol=0)
    kw = dict(DECODE, weight_quant="int8", weight_quant_min_size=512)
    want = JaxInference(jm, {"params": params}, **kw).attention_rescoring_batch(j_feats, lens)
    got = ASRInference(tm, **kw).attention_rescoring_batch(t_feats, lens)
    _same_hyps(got, want)

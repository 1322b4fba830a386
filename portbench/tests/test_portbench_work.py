"""The frozen work counts: model FLOPs agree with ``FlopCounterMode`` over
the port's own model at toy shapes, and the CTC pair's bytes follow the
rule of PERF.md's kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import Bench
from portbench.work.ctc import pair_bound_s


def test_conformer_flops_match_the_port(toy):
    bench = Bench(toy)
    config = bench.config("toy-conformer")
    shape = {"rows": 3, "frames": 120, "labels": 7}
    counted = bench.family("conformer").flops(config, shape)
    from mindaudio_torch.models.asr_model import ASRModel

    m = config["model"]
    model = ASRModel(m["vocab_size"], d_model=m["d_model"], head_num=m["head_num"],
                     ffn_dim=m["ffn_dim"], num_encoder_layers=m["num_encoder_layers"],
                     num_decoder_layers=m["num_decoder_layers"], dropout_rate=0.0,
                     device="cpu").eval()
    feats = torch.randn(3, 120, 80)
    lens = torch.full((3,), 120)
    ys = torch.randint(1, m["vocab_size"], (3, 8))
    with FlopCounterMode(display=False) as counter:
        enc, mask = model.encode(feats, lens)
        out = model.ctc_proj(enc).sum() + model.decoder_logits(enc, mask, ys,
                                                               torch.full((3,), 8)).sum()
        out.backward()
    assert counted == counter.get_total_flops()


def test_deepspeech2_line_equals_a_full_count(toy):
    from portbench.work.flops import step_flops

    bench = Bench(toy)
    config, fam = bench.config("toy-ds2"), bench.family("deepspeech2")
    shape = {"rows": 2, "frames": 81, "enc_frames": 41, "labels": 5}
    full = step_flops(lambda: fam.reference_model(config), lambda model: model.logits(
        torch.zeros(2, 81, 161, device="meta"), torch.full((2,), 81, device="meta"))[0])
    assert fam.flops(config, shape) == full


def test_deepspeech2_flops_match_the_port(toy):
    bench = Bench(toy)
    config = bench.config("toy-ds2")
    from mindaudio_torch.models.deepspeech2 import DeepSpeechModel

    m = config["model"]
    model = DeepSpeechModel(hidden_size=m["hidden_size"], num_rnn_layers=m["num_rnn_layers"],
                            device="cpu")
    counted = bench.family("deepspeech2").flops(config, {"rows": 2, "frames": 41,
                                                         "enc_frames": 21, "labels": 5})
    with FlopCounterMode(display=False) as counter:
        model(torch.randn(2, 41, 161), torch.full((2,), 41))[0].sum().backward()
    # the port's LSTM is one fused call the counter does not see; the rest
    # agrees. Per layer and direction the reference's loop takes the input
    # product once forward and twice backward, and the recurrent one T times
    # forward, T times for its weight's gradient and T - 1 times for h's
    # (h is zero before the first frame)
    b, t, h = 2, 21, m["hidden_size"]
    lstm = sum(2 * (3 * 2 * b * t * n_in * 4 * h + (3 * t - 1) * 2 * b * h * 4 * h)
               for n_in in [32 * 41] + [h] * (m["num_rnn_layers"] - 1))
    assert counted == counter.get_total_flops() + lstm


@pytest.mark.parametrize("rows,frames,valid,labels,bound_ms", [
    (32, 256, 32 * 248, 20, 0.00079 + 0.00118),  # PERF.md's table, rows 3 and 4
])
def test_ctc_bytes_follow_the_table(rows, frames, valid, labels, bound_ms):
    assert pair_bound_s(rows, frames, valid, labels) * 1e3 == pytest.approx(bound_ms, abs=1e-5)

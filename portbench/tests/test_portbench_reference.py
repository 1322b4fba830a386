"""The frozen reference against the port at toy widths on the CPU: piece by
piece, and as a whole through a run whose program trains in float32 (no
autocast), where the two must agree to float32's rounding. The Conformer's
run replays the recipe's dither, SpecAugment and dropout draws."""

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.harness import Bench
from portbench.reference import data as ref_data
from portbench.reference import deepspeech2 as ref_ds2
from portbench.reference import frontend
from portbench.reference.precision import FLOAT32

from .conftest import run_cell


@pytest.mark.parametrize("cell,loss,grad,change", [
    ("toy-conformer-train", 1e-5, 1e-3, 1e-3),
    ("toy-ds2-train", 1e-4, 1e-3, 1e-3),
])
def test_program_in_float32_equals_the_reference(toy_f32, cell, loss, grad, change):
    rc, result, err = run_cell(toy_f32, cell, seed=2**31 + 11)
    assert rc == 0, err
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert max(checks[f"loss{k}_gap"] for k in (1, 2, 3)) < loss, checks
    assert checks["grad_gap"] < grad and checks["change_gap"] < change, checks
    assert checks["logit_gap"] < 1e-5, checks


def test_kaldi_fbank_with_dither():
    from mindaudio_torch.ops.spectral import kaldi_fbank

    pcm = torch.randint(-3000, 3000, (3, 16000), dtype=torch.int16)
    port = kaldi_fbank(pcm, dither=0.1, generator=torch.Generator().manual_seed(5),
                       device="cpu")
    ref = frontend.kaldi_fbank(pcm, dither=0.1, generator=torch.Generator().manual_seed(5))
    assert torch.allclose(port, ref, atol=2e-4, rtol=1e-4)


def test_spec_augment_draws():
    from mindaudio_torch.ops.specaugment import spec_augment

    feats = torch.randn(4, 300, 80)
    port = spec_augment(feats, generator=torch.Generator().manual_seed(3))
    ref = frontend.spec_augment(feats, 2, 2, 50, 10, torch.Generator().manual_seed(3))
    assert torch.equal(port, ref)


def test_deepspeech2_spectrogram():
    from mindaudio_torch.recipes.deepspeech2.train import device_features

    wavs = torch.rand(2, 32000) - 0.5
    lens = torch.tensor([32000, 20111])
    port, port_lens = device_features(wavs, lens)
    ref, ref_lens = frontend.log_spectrogram(wavs, lens)
    assert torch.equal(port_lens, ref_lens)
    assert torch.allclose(port, ref, atol=1e-4)


def test_lstm_loop_equals_the_fused_call():
    torch.manual_seed(0)
    lstm = ref_ds2.BiLSTM(12, 8)
    for p in lstm.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(3, 17, 12)
    h0 = x.new_zeros(1, 3, 8)
    for d in (0, 1):
        weights = [lstm.weight_ih[d], lstm.weight_hh[d], lstm.bias[d],
                   torch.zeros_like(lstm.bias[d])]
        fused = torch.lstm(x, (h0, h0), weights, True, 1, 0.0, True, False, True)[0]
        assert torch.allclose(lstm.loop(x, d, FLOAT32), fused, atol=1e-6)


@pytest.mark.parametrize("family", ["conformer", "deepspeech2"])
def test_batches_worked_out_again(toy, tmp_path, family):
    """The batches both sides take are the recipe's, value for value: the
    Conformer's, made in memory, as the recipe's collate gives the same
    rows read from WAV files; DeepSpeech2's reference batches as the
    recipe's iterator gives them from the corpus on disk."""
    bench = Bench(toy)
    cell = bench.cell({"conformer": "toy-conformer-train", "deepspeech2": "toy-ds2-train"}[family])
    config = bench.config(cell["config"])
    fam = bench.family(family)
    corpus = fam.corpus(config, cell, 77, torch.device("cpu"), str(tmp_path))
    trainer = fam.Trainer(config, cell, corpus, 77, torch.device("cpu"))
    batches = trainer.batches()
    program = [next(batches)[3] for _ in range(3)]
    if family == "conformer":
        ref = [recipe_collate(config, b, tmp_path) for b in program]
    else:
        ref = ref_data.ds2_batches(corpus["manifest"], 77, config["recipe"]["data"]["batch_size"],
                                   config["frozen"]["frame_buckets"],
                                   config["frozen"]["max_label_len"], 3)
    for p, r in zip(program, ref):
        assert set(r) <= set(p)
        for key, value in r.items():
            np.testing.assert_array_equal(np.asarray(p[key]), value, err_msg=key)


def recipe_collate(config, batch, root):
    """The Conformer recipe's collate of ``batch``'s rows, written out as WAV
    files and transcripts of the vocabulary's characters."""
    from mindaudio_torch.recipes.conformer import dataset
    from mindaudio_torch.utils.tokenizer import CharTokenizer

    vocab = config["model"]["vocab_size"]
    symbols = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(vocab - 3)] + ["<sos/eos>"]
    (root / "lang_char.txt").write_text("".join(f"{s} {i}\n" for i, s in enumerate(symbols)),
                                        encoding="utf-8")
    tokenizer = CharTokenizer.from_file(str(root / "lang_char.txt"))
    utts = []
    for r, (n, k) in enumerate(zip(batch["wav_lens"], batch["label_lens"])):
        path = str(root / f"row{r}.wav")
        traffic.write_wav(path, batch["wavs"][r, :n], 16000)
        text = "".join(symbols[i] for i in batch["labels"][r, :k])
        utts.append(dataset.Utt(f"row{r}", path, n / 16000, text))
    frames = (batch["wavs"].shape[1] - 400) // 160
    return dataset.collate(utts, tokenizer, frames, config["recipe"]["data"]["max_label_len"])

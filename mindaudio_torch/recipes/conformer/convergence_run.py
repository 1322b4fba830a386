"""Convergence run of the Conformer recipe on the card (port of
``examples/conformer/convergence_run.py``): the full 46.2 M-parameter model
on a synthetic audio cipher, with dev-loss-scored checkpoints and averaged
decoding.

The corpus: each of 40 transcript characters maps to a distinct 140 ms
harmonic unit (a fundamental and two partials, a per-utterance pitch scale,
vibrato, amplitude jitter, noise at about 25 dB SNR). The mapping from audio
to text is real, so the CER of the held-out test set measures acoustic
decoding, and ``gen`` writes the same texts, WAVs and CSVs for the same seed
as the JAX package's ``gen``: 4096 train, 128 dev and 128 test utterances,
all in the 227-frame bucket.

Stages (each its own process; ``train`` resumes from the last checkpoint, so
running it again extends the run)::

    python -m mindaudio_torch.recipes.conformer.convergence_run gen    [--root DIR]
    python -m mindaudio_torch.recipes.conformer.convergence_run train  [--root DIR] \\
        [--steps N] [--extra <train flags>]
    python -m mindaudio_torch.recipes.conformer.convergence_run decode [--root DIR] \\
        [--avg N] [--mode M] [--extra <predict flags>]
    python -m mindaudio_torch.recipes.conformer.convergence_run report [--root DIR]
    python -m mindaudio_torch.recipes.conformer.convergence_run protocol [--root DIR]

``protocol`` runs the whole protocol, the stages of ``PROTOCOL`` in order,
each in a process of its own: ``gen`` (skipped when the CSVs exist), CTC
first to step 3000 so that the encoder learns the frame-level acoustics
before the decoder takes the gradient, hybrid to step 6000, then the test
set decoded from the last checkpoint and from the best-5 average, greedy and
rescored. Each ``train`` resumes, so running ``protocol`` again after an
interruption continues where the last checkpoint left off.

``--root`` defaults to ``conformer_convergence_torch`` in the temporary
directory. Decode results collect in ``<root>/results.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from ...data import io

SR = 16000
VOCAB = "的一是不了人我在有他这中大来上国个到说们为子和你地出道也时年得就那要下以生会自着去之过家学对可她里后"[:40]
UNIT_S = 0.14  # seconds per character unit
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "conformer_convergence_torch")


def _unit_wave(char_idx: int, rng: np.random.Generator, pitch_scale: float):
    """One character's unit: f0 and two partials, vibrato, an envelope. The
    f0 grid is geometric (6% a character), so the per-utterance pitch scale
    (1.5% either way) never makes two characters alike."""
    n = int(UNIT_S * SR)
    t = np.arange(n) / SR
    f0 = 300.0 * (1.06 ** char_idx) * pitch_scale
    vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(4, 7) * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0 * vib) / SR
    amp = rng.uniform(0.25, 0.45)
    x = amp * (np.sin(phase) + 0.5 * np.sin(2 * phase + rng.uniform(0, 6.28))
               + 0.25 * np.sin(3 * phase + rng.uniform(0, 6.28)))
    env = np.minimum(np.arange(n) / (0.015 * SR), 1.0)
    env *= np.minimum((n - np.arange(n)) / (0.03 * SR), 1.0)
    return x * env


def synth_utt(text: str, rng: np.random.Generator) -> np.ndarray:
    pitch_scale = rng.uniform(0.985, 1.015)  # the utterance's "speaker"
    parts = [np.zeros(int(rng.uniform(0.05, 0.12) * SR), np.float64)]
    for ch in text:
        parts.append(_unit_wave(VOCAB.index(ch), rng, pitch_scale))
    parts.append(np.zeros(int(rng.uniform(0.05, 0.12) * SR), np.float64))
    x = np.concatenate(parts)
    x += 10 ** (-25 / 20) * rng.standard_normal(len(x))  # ~25 dB SNR
    return (0.9 * x / np.abs(x).max()).astype(np.float32)


def gen(root: str, n_train=4096, n_dev=128, n_test=128, seed=0):
    """Write ``<root>/wavs/*.wav`` and ``<root>/{train,dev,test}.csv``."""
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = {"train": [], "dev": [], "test": []}
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        for i in range(n):
            text = "".join(rng.choice(list(VOCAB), size=rng.integers(6, 13)))
            x = synth_utt(text, rng)
            utt = f"{split}{i:05d}"
            wav = os.path.join(root, "wavs", utt + ".wav")
            io.write(wav, x, SR)
            rows[split].append((utt, len(x) / SR, wav, " ".join(text)))
    for split, items in rows.items():
        with open(os.path.join(root, f"{split}.csv"), "w", encoding="utf-8") as f:
            f.write("ID,duration,wav,transcript\n")
            for utt, dur, wav, text in items:
                f.write(f"{utt},{dur:.3f},{wav},{text}\n")
    hours = sum(r[1] for r in rows["train"]) / 3600
    print(f"generated {n_train}+{n_dev}+{n_test} utts ({hours:.2f} h train audio)")


def _args(root: str, steps: int):
    """The recipe flags of the run, those of the JAX package's run. The two
    bucket flags name keys that ``conformer.yaml`` lacks, so the config
    drops them (as the JAX config does): batches are the default buckets
    scaled by ``data.batch_factor`` 1.34, 128 utterances in the 227-frame
    bucket."""
    return [
        "--data.train_csv", f"{root}/train.csv",
        "--data.dev_csv", f"{root}/dev.csv",
        "--data.test_csv", f"{root}/test.csv",
        "--data.vocab_file", f"{root}/lang_char.txt",
        "--data.cmvn_file", f"{root}/global_cmvn.json",
        "--data.speed_perturb", "false",
        # SpecAugment off: cipher characters are independent, so a 50-frame
        # time mask hides ~3.5 whole characters
        "--features.spec_aug", "false",
        "--data.frame_bucket_limit", "227",
        "--data.batch_bucket_limit", "64",
        "--optim.epochs", "400",
        "--optim.warmup_steps", "500",
        "--optim.lr", "0.002",
        "--model.ctc_weight", "0.5",
        "--train.max_steps", str(steps),
        "--train.log_every_steps", "50",
        "--train.save_every_steps", "250",
        "--train.keep_checkpoint_max", "12",
        "--train.resume", "true",   # running the stage again continues the run
        "--train.ckpt_dir", f"{root}/ckpt",
        "--decode.max_tgt_len", "16",
        "--decode.mode", "ctc_greedy",
        "--decode.result_file", f"{root}/result.txt",
    ]


def train(root: str, steps: int, extra=()):
    from . import compute_cmvn_stats
    from . import train as conformer_train

    argv = _args(root, steps) + list(extra)
    if not os.path.exists(f"{root}/global_cmvn.json"):
        compute_cmvn_stats.main(argv)
    return conformer_train.main(argv)


def decode(root: str, avg: int, mode: str = "ctc_greedy", extra=()):
    from . import predict

    results_path = os.path.join(root, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    cer_val = predict.main(_args(root, 0) + ["--decode.average_num", str(avg),
                                             "--decode.mode", mode] + list(extra))
    key = f"{mode}_avg{avg}" if avg > 1 else f"{mode}_last"
    results[key] = cer_val
    with open(results_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"{key}: CER {cer_val}")
    return cer_val


def report(root: str):
    with open(os.path.join(root, "results.json")) as f:
        print(json.dumps(json.load(f), indent=1))


PROTOCOL = [
    ["gen"],
    ["train", "--steps", "3000", "--extra", "--model.ctc_weight", "0.99", "--optim.lr", "0.002"],
    ["train", "--steps", "6000", "--extra", "--model.ctc_weight", "0.5", "--optim.lr", "0.001"],
] + [["decode", "--avg", avg, "--mode", mode]
     for avg in ("1", "5") for mode in ("ctc_greedy", "attention_rescoring")]


def protocol(root: str):
    """Every stage of ``PROTOCOL`` in a process of its own; a stage that
    fails stops the protocol with its exit code."""
    for stage in PROTOCOL:
        if stage[0] == "gen" and os.path.exists(os.path.join(root, "test.csv")):
            continue
        cmd = [sys.executable, "-m", __spec__.name, stage[0], "--root", root] + stage[1:]
        print("protocol:", " ".join(stage), flush=True)
        rc = subprocess.run(cmd).returncode
        if rc:
            raise SystemExit(f"protocol: stage {' '.join(stage)} exited {rc}")
    report(root)


def _take(argv, flag, default):
    if flag in argv:
        i = argv.index(flag)
        value = argv[i + 1]
        del argv[i:i + 2]
        return value
    return default


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    stage = argv.pop(0)
    root = _take(argv, "--root", DEFAULT_ROOT)
    # everything after --extra goes to the recipe's command line as it is
    extra = []
    if "--extra" in argv:
        i = argv.index("--extra")
        extra, argv = argv[i + 1:], argv[:i]
    os.makedirs(root, exist_ok=True)
    if stage == "gen":
        gen(root)
    elif stage == "train":
        train(root, int(_take(argv, "--steps", 2400)), extra)
    elif stage == "decode":
        decode(root, int(_take(argv, "--avg", 1)), _take(argv, "--mode", "ctc_greedy"), extra)
    elif stage == "report":
        report(root)
    elif stage == "protocol":
        protocol(root)
    else:
        raise SystemExit(f"unknown stage {stage}")


if __name__ == "__main__":
    main()

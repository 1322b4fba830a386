"""Separation convergence (port of ``benchmarks/separation_convergence.py``):
train Conv-TasNet or TasNet at reduced width on a synthetic two-speaker
corpus, then score SI-SNRi and BSS Eval SDRi on its held-out split through
the recipes' eval loop (``eval.evaluate``).

The protocol is the JAX script's: :func:`make_corpus` (24 training and 8
test mixtures of 2 s at 8 kHz; it writes the same WAVs and JSON lists, byte
for byte, as the JAX script's for the same seed and root), batches of 8
from ``separation_batch_iterator`` with seed 1 (the first batch only shapes
the JAX model's init, so it is drawn and not trained on), then ``--steps``
Adam steps at 1e-3 with no clipping, on

- Conv-TasNet: N 128, L 16, bottleneck 64, hidden 128, P 3, X 4, R 2;
- TasNet: N 128, L 40, hidden 128, 2 BiLSTM layers.

The JAX init (``PRNGKey(0)``) cannot be reproduced, so ``--init-seed``
seeds the port's weight generator instead. cuDNN's TF32 is off unless
``--cudnn-tf32`` is given (the JAX run computes in float32 on the CPU).
The run's result is printed as one JSON line and stored in
``<out>/results.json`` under ``"<model> seed <n> tf32 <off|on>"``
(``--out`` defaults to the corpus directory, ``--root``; the committed
results in ``convergence_artifacts/`` beside this file change only when
``--out`` names it), with the device it ran on.

Usage::

    python -m mindaudio_torch.recipes.conv_tasnet.convergence_run \\
        [--model conv_tasnet|tasnet] [--steps 160] [--init-seed 0] [--cudnn-tf32] \\
        [--device cuda] [--root DIR] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from ... import resolve_device
from ...data import io
from ...data.librimix import separation_batch_iterator
from ...loss.separation_loss import pit_si_snr_loss
from ...models.conv_tasnet import ConvTasNet
from ...models.tasnet import TasNet
from ...train.optim import AdamW
from ..tasnet.train import separate_full
from .eval import evaluate
from .train import separate

SR, SECONDS, BATCH, LR, DATA_SEED = 8000, 2.0, 8, 1e-3, 1


def make_corpus(root, n_utts=24, seconds=2.0, sr=8000, seed=0):
    """Synthetic two-speaker mixtures: a harmonic stack with slow amplitude
    modulation against a square wave plus modulated noise, so that the
    separator has real structure to find. Writes ``<root>/{tr,tt}/{mix,s1,
    s2}/u<i>.wav`` and the ``mix.json``/``s1.json``/``s2.json`` lists
    (``n_utts`` training and 8 test mixtures)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    for split, n in (("tr", n_utts), ("tt", 8)):
        for part in ("mix", "s1", "s2"):
            os.makedirs(os.path.join(root, split, part), exist_ok=True)
        entries = {p: [] for p in ("mix", "s1", "s2")}
        for i in range(n):
            f1 = rng.uniform(100, 200)
            f2 = rng.uniform(300, 450)
            s1 = np.sin(2 * np.pi * f1 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t))
            s1 += 0.3 * np.sin(2 * np.pi * 2 * f1 * t)
            s2 = np.sign(np.sin(2 * np.pi * f2 * t)) * 0.5
            s2 += 0.2 * rng.standard_normal(len(t)) * np.sin(2 * np.pi * 0.7 * t)
            s1, s2 = s1.astype(np.float32), s2.astype(np.float32)
            mix = s1 + s2
            for part, x in (("mix", mix), ("s1", s1), ("s2", s2)):
                path = os.path.join(root, split, part, f"u{i}.wav")
                io.write(path, x, sr)
                entries[part].append([path, len(x)])
        for part, ent in entries.items():
            with open(os.path.join(root, split, f"{part}.json"), "w") as f:
                json.dump(ent, f)


def build(model_name, device, init_seed):
    """``(model, separate_fn)`` at the protocol's reduced width, weights
    from ``init_seed``."""
    if model_name == "tasnet":
        model = TasNet(enc_dim=128, frame_len=40, num_spk=2, hidden=128, num_layers=2,
                       device=device)
        separate_fn = separate_full
    else:
        model = ConvTasNet(enc_dim=128, win_len=16, bottleneck=64, hidden=128, kernel_size=3,
                           num_blocks=4, num_repeats=2, num_spk=2, device=device)
        separate_fn = separate
    model.reset_parameters(torch.Generator(device=device).manual_seed(init_seed))
    return model.train(), separate_fn


def device_name(device):
    """The card's name and power limit (``nvidia-smi``), or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("conv_tasnet", "tasnet"), default="conv_tasnet")
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--init-seed", type=int, default=0, help="seed of the weights' generator")
    ap.add_argument("--cudnn-tf32", action="store_true",
                    help="let cuDNN's convolutions and LSTM use TF32 (PyTorch's default)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None, help="corpus directory (a temporary one if unset)")
    ap.add_argument("--out", default=None,
                    help="directory of results.json (the corpus directory if unset)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the protocol; returns the result stored in ``results.json``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = args.cudnn_tf32
    root = args.root or tempfile.mkdtemp(prefix="sep_conv_")
    if not os.path.exists(os.path.join(root, "tt", "mix.json")):
        make_corpus(root, seconds=SECONDS, sr=SR)
    seg = int(SECONDS * SR)

    model, separate_fn = build(args.model, device, args.init_seed)
    optimizer = AdamW(model.named_parameters(), LR, weight_decay=0.0)
    it = separation_batch_iterator(os.path.join(root, "tr"), BATCH, seg, epochs=10_000,
                                   seed=DATA_SEED)
    next(it)  # the batch the JAX script initialises its model on
    loss = None
    for i, (_, batch) in enumerate(it):
        mix, src, lengths = (torch.from_numpy(batch[k]).to(device)
                             for k in ("mix", "src", "lengths"))
        loss, _ = pit_si_snr_loss(separate_fn(model, mix), src, lengths)
        optimizer.step(list(torch.autograd.grad(loss, optimizer.params)))
        if i + 1 >= args.steps:
            break
        if (i + 1) % 40 == 0:
            print(f"step {i + 1}: pit -si_snr {loss.item():.3f}", flush=True)

    scores = evaluate(model, separate_fn, os.path.join(root, "tt"), seg, device)
    result = {"model": args.model, "steps": args.steps, "init_seed": args.init_seed,
              "cudnn_tf32": args.cudnn_tf32, "final_loss": loss.item(),
              "utts": scores["utts"], "si_snri_db": scores["si_snri"],
              "sdri_db_bss_eval": scores["sdri"], "device": device_name(device),
              "torch": torch.__version__}
    print(json.dumps(result), flush=True)
    out = args.out or root
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "results.json")
    stored = json.load(open(path)) if os.path.exists(path) else {}
    key = f"{args.model} seed {args.init_seed} tf32 {'on' if args.cudnn_tf32 else 'off'}"
    stored[key] = result
    with open(path, "w") as f:
        json.dump(stored, f, indent=1)
    return result


if __name__ == "__main__":
    main()

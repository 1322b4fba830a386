"""Generate the quick-start notebook of the PyTorch/CUDA port.

The same tour as ``tutorials/make_notebook.py`` (io -> features -> filters
-> augment -> processing -> spectrum, then the device ops and a model),
through ``import mindaudio_torch as ma`` and the package-level names only.
Its first code cell is ``DEVICE = "cuda"``: the device cells run on the
card, and ``DEVICE = "cpu"`` runs the plain PyTorch versions of the
kernels. ``tests/test_torch_tutorial_notebook.py`` runs every code cell on
the CPU and checks that the committed notebook's sources are what this
script writes.

Usage:
    python tutorials/make_notebook_torch.py [--device cpu] [--out PATH]

Every code cell is executed in one shared namespace and its standard output
embedded in the notebook; ``--device`` replaces the first cell's device for
that run only (the notebook keeps ``DEVICE = "cuda"``).
"""
import argparse
import io as _stdio
import json
import os
import sys
from contextlib import redirect_stdout

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "audio_data_processing_with_mindaudio_torch.ipynb")
DEVICE_CELL = 'DEVICE = "cuda"'

# (kind, text) — code cells are plain source strings
CELLS = [
    ("md", """\
# Audio data processing with mindaudio_torch — quick start

The PyTorch/CUDA port of `mindaudio_tpu`, for NVIDIA Hopper (H100). Its
package-level names are the JAX package's, so `import mindaudio_torch as ma`
stands in for `import mindaudio_tpu as ma`. Every cell runs with no
external data (audio is synthesized in-notebook).

The host `mindaudio_torch.data` layer keeps the reference's function names,
signatures and defaults (NumPy in / NumPy out, re-exported at the package
top level). The `mindaudio_torch.ops` layer is the device path: the same DSP
as PyTorch ops and hand-written CUDA kernels that run inside your train
step.

The device cells run on `DEVICE`. Set it to `"cpu"` to run them without a
card: each kernel then runs its plain PyTorch version.
"""),
    ("code", DEVICE_CELL + "\n"),
    ("md", """\
## 1. API structure

```
mindaudio_torch
├── data            host DSP (NumPy), reference-compatible names
│   ├── io          read / write (WAV, 1–64-bit, RIFX, offset/duration seek),
│   │               pin_memory / recursive_to (onto the card)
│   ├── spectrum    stft / istft / magphase / mel / dB
│   ├── features    fbank / mfcc / deltas / yin f0 / hpss
│   ├── filters     low_pass / notch / peaking / filtfilt …
│   ├── augment     add_noise / add_reverb / speed / drop_chunk / …
│   └── processing  resample / clip / normalize / cmvn / trim / split
├── ops             device DSP: fbank, mfcc, kaldi fbank, the fused log-mel
│                   kernel, SpecAugment — runs inside the step
├── models          Conformer, DeepSpeech2, ECAPA-TDNN, TasNet/Conv-TasNet,
│                   FastSpeech2, WaveGrad
├── loss / metric / scheduler / train / utils
└── parallel        process groups over torch.distributed: DP, ZeRO-1, TP,
                    sequence parallelism, MoE, GPipe
```
"""),
    ("md", "## 2. Quick tour\n\n### 2.1 `io`: read / write"),
    ("code", """\
import os, tempfile
import numpy as np
import mindaudio_torch as ma

workdir = tempfile.mkdtemp(prefix="ma_torch_tutorial_")
sr = 16000
t = np.arange(2 * sr) / sr
wav = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)

path = os.path.join(workdir, "tone.wav")
ma.write(path, wav, sr)
x, sr = ma.read(path)
print("full read:", x.shape, x.dtype, "sr", sr)

x_seg, _ = ma.read(path, offset=0.25, duration=0.5)   # seek-based slice
print("offset/duration read:", x_seg.shape)
"""),
    ("md", "### 2.2 `features`: fbank / mfcc"),
    ("code", """\
feats = ma.fbank(wav, n_mels=40, sample_rate=sr)
print("fbank:", feats.shape)            # (n_mels, T)

mfccs = ma.mfcc(wav, sample_rate=sr)
print("mfcc:", mfccs.shape)
"""),
    ("md", "### 2.3 `filters`"),
    ("code", """\
lp = ma.low_pass_filter(wav, sr, cutoff_freq=1500)
kernel = ma.notch_filter(2 * 440 / sr)        # freq as fraction of Nyquist
notched = np.convolve(wav, kernel.ravel(), mode="same")
print("low-pass rms: %.4f   notch(440 Hz) rms: %.4f   input rms: %.4f"
      % (np.sqrt((lp**2).mean()), np.sqrt((notched**2).mean()),
         np.sqrt((wav**2).mean())))
# notching the tone's own frequency kills most of its energy
"""),
    ("md", """\
### 2.4 `augment`

`add_noise` / `add_reverb` take lists of wav paths (as the reference does
for its CSV-driven pipelines); here we synthesize a noise file and a small
room impulse response.
"""),
    ("code", """\
rng = np.random.default_rng(0)
noise_path = os.path.join(workdir, "background.wav")
ma.write(noise_path, rng.standard_normal(2 * sr).astype(np.float32) * 0.1, sr)

rir = np.zeros(2000, np.float32)
rir[0] = 1.0
rir[[400, 900, 1500]] = [0.6, 0.3, 0.15]      # a few discrete echoes
rir_path = os.path.join(workdir, "rir.wav")
ma.write(rir_path, rir, sr)

noisy = ma.add_noise(wav[None, :], [noise_path], 10, 20, rng=rng)  # SNR ~ U[10,20] dB
wet = ma.add_reverb(wav[None, :], [rir_path], 1.0, rng=rng)
print("noisy:", noisy.shape, " reverbed:", wet.shape)
"""),
    ("md", "### 2.5 `processing`: resample / clip"),
    ("code", """\
x8k = ma.resample(wav, orig_freq=sr, new_freq=8000)
print("resampled:", x8k.shape)              # half the samples

seg = ma.clip(wav, 0.1, 0.5)                 # fractions of total length
print("clip [0.1, 0.5]:", seg.shape)
"""),
    ("md", "### 2.6 `spectrum`: stft / magphase / istft"),
    ("code", """\
spec = ma.stft(wav)                           # librosa conventions
mag, phase = ma.magphase(spec, power=1.0)
recon = ma.istft(spec)
err = np.abs(recon[: len(wav)] - wav[: len(recon)]).max()
print("stft:", spec.shape, " round-trip max err: %.2e" % err)
"""),
    ("md", """\
## 3. The device path

On the card, feature extraction belongs inside the step: no host round
trip, no worker pools. The `ops` functions are the same math as the host
layer as PyTorch ops; each takes `device=`. `ma.pin_memory` moves a nested
batch onto the card through pinned host memory.
"""),
    ("code", """\
import torch
from mindaudio_torch import ops

batch = ma.pin_memory({"wavs": np.stack([wav, np.roll(wav, 123)])}, device=DEVICE)["wavs"]
feats_dev = ops.fbank(batch, n_mels=80, device=DEVICE)
print("device:", feats_dev.device.type, " device fbank:", tuple(feats_dev.shape))
"""),
    ("md", """\
The log-mel front end is one hand-written CUDA kernel (framing, window, DFT,
power, mel projection and log in one pass over the signal). On the CPU it
runs its plain PyTorch version:
"""),
    ("code", """\
logmel = ops.fused_logmel(batch, n_mels=80, device=DEVICE)   # (B, frames, n_mels)
print("fused log-mel:", tuple(logmel.shape), " finite:", bool(torch.isfinite(logmel).all()))
"""),
    ("md", """\
SpecAugment draws its masks from a `torch.Generator` on the data's device,
so augmentation runs inside the step:
"""),
    ("code", """\
from mindaudio_torch.ops import spec_augment

gen = torch.Generator(device=DEVICE).manual_seed(0)
spec_b = feats_dev.transpose(-1, -2)          # (B, n_mels, T) -> (B, T, n_mels)
aug = spec_augment(spec_b, generator=gen)
print("masked frames:", int((aug.sum(-1) == 0).sum()),
      "masked bins:", int((aug.sum(-2) == 0).sum()))
"""),
    ("md", """\
## 4. From features to a model

The model zoo consumes `(B, T, n_mels)` features. One Conformer encoder
forward:
"""),
    ("code", """\
from mindaudio_torch import models

torch.manual_seed(0)
enc = models.ConformerEncoder(input_dim=80, d_model=128, head_num=4,
                              ffn_dim=512, num_layers=2).to(DEVICE).eval()
x_btf = spec_b.contiguous()                    # (B, T, n_mels)
lens = torch.full((x_btf.shape[0],), x_btf.shape[1], dtype=torch.long, device=DEVICE)
with torch.no_grad():
    out, out_mask = enc(x_btf, lens)           # mask: (B, 1, T_out) valid frames
print("encoder out:", tuple(out.shape), " out lens:", out_mask.sum(-1).ravel().tolist())
"""),
    ("md", """\
## 5. Where to go next

- `mindaudio_torch/recipes/<family>/` — train / decode recipes of the port
  (conformer, deepspeech2, ecapa_tdnn, conv_tasnet, tasnet, fastspeech2,
  wavegrad).
- `chip_smoke.py` — drives every path on the card and holds each kernel
  against its plain version.
- `PERF.md` — the kernels' times on the H100 and how they were measured.
"""),
]


def notebook(device=None):
    """The notebook as a dict; its code cells are run with their output
    embedded (the first cell's device replaced by ``device`` when given)."""
    ns, cells = {}, []
    for kind, text in CELLS:
        if kind == "md":
            cells.append({"cell_type": "markdown", "metadata": {},
                          "source": text.splitlines(keepends=True)})
            continue
        run = f'DEVICE = "{device}"\n' if device and text == DEVICE_CELL + "\n" else text
        buf = _stdio.StringIO()
        with redirect_stdout(buf):
            exec(compile(run, "<cell>", "exec"), ns)  # noqa: S102
        out = buf.getvalue()
        outputs = [{"output_type": "stream", "name": "stdout",
                    "text": out.splitlines(keepends=True)}] if out else []
        cells.append({"cell_type": "code", "metadata": {}, "execution_count": None,
                      "outputs": outputs, "source": text.splitlines(keepends=True)})
    return {
        "nbformat": 4, "nbformat_minor": 5,
        "metadata": {"kernelspec": {"display_name": "Python 3", "language": "python",
                                    "name": "python3"},
                     "language_info": {"name": "python"}},
        "cells": cells,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="run the cells on this device (the notebook keeps cuda)")
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, ".."))
    nb = notebook(args.device)
    with open(args.out, "w") as f:
        json.dump(nb, f, indent=1, ensure_ascii=False)
        f.write("\n")
    print("wrote", args.out, f"({len(nb['cells'])} cells)")


if __name__ == "__main__":
    main()

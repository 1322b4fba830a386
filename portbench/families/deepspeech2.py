"""The DeepSpeech2 family: the recipe ``mindaudio_torch.recipes.deepspeech2``
driven through its own entry points (``train.build_model``,
``make_optimizer``, ``make_step`` with ``device_features``, and
``dataset.batch_iterator``), with the benchmark's seeded weights, on a
corpus in LibriSpeech's manifest layout; and its reference
(``reference/deepspeech2.py``). The recipe is float32 with cuDNN's TF32 as
PyTorch leaves it (on).
"""

from __future__ import annotations

import json
import os

import torch

from portbench import traffic as T
from portbench import weights
from portbench.reference import data as ref_data
from portbench.reference import deepspeech2 as ref
from portbench.reference import frontend
from portbench.reference.optim import AdamW, constant, follow
from portbench.reference.precision import Precision
from portbench.work.flops import step_flops

SAMPLE_RATE, HOP = 16000, 160
ALPHABET = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ") * 8 + ["'"]  # letters, a rare apostrophe


def corpus(config, cell, seed, device, root):
    """The cell's utterances as 16-bit WAV files with their transcripts, and
    a manifest in LibriSpeech's layout (``data_path`` and ``samples`` of
    ``wav_path`` / ``txt_path``)."""
    utts = T.generate(cell["traffic"], ALPHABET, seed, device, words=True)
    for sub in ("wav", "txt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    samples = []
    for u in utts:
        wav, txt = f"wav/{u.utt_id}.wav", f"txt/{u.utt_id}.txt"
        T.write_wav(os.path.join(root, wav), u.samples, SAMPLE_RATE)
        with open(os.path.join(root, txt), "w", encoding="utf-8") as f:
            f.write(u.text)
        samples.append({"wav_path": wav, "txt_path": txt})
    manifest = os.path.join(root, "libri_train_manifest.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump({"data_path": root, "samples": samples}, f)
    return {"manifest": manifest, "root": root}


def reference_model(config):
    return ref.DeepSpeech2(**config["model"])


class Trainer:
    """The recipe's model, optimizer, step and batches for one run."""

    def __init__(self, config, cell, corpus, seed, device, control=False):
        """``control``: the model's own bf16 path switched on (its convs and
        LSTM products in bf16, the LSTM frame by frame with a float32 cell
        state), the program's lower precision (``calibrate.py`` alone)."""
        from mindaudio_torch.recipes.deepspeech2 import dataset
        from mindaudio_torch.recipes.deepspeech2 import train as recipe

        cfg, _ = recipe.parse_args(["--device", str(device)])
        for section, values in [("model", config["model"])] + list(
                config["recipe"].items()) + list(cell["recipe"].items()):
            for key, value in values.items():
                cfg[section][key] = value
        cfg.data.train_manifest = corpus["manifest"]
        self.cfg, self.seed, self.dataset = cfg, seed, dataset
        spec = reference_model(config).init_spec()
        self.model = recipe.build_model(cfg, device).train()
        weights.load(self.model, weights.make(spec, seed, device))
        if control:
            self.model.conv.dtype = torch.bfloat16
            for rnn in self.model.rnns():
                rnn.bilstm.dtype = torch.bfloat16
        self.output_module = self.model.fc  # its output: the logits
        self.optimizer = recipe.make_optimizer(cfg, self.model)
        self.step = recipe.make_step(cfg, self.model, self.optimizer)
        self.manifest = corpus["manifest"]
        self.steps_per_epoch = len(dataset.read_manifest(self.manifest)) // int(
            cfg.data.batch_size)

    def batches(self):
        """``(epoch, seconds of audio, shape, batch)`` without end."""
        for epoch, batch in self.dataset.batch_iterator(
                self.manifest, int(self.cfg.data.batch_size), epochs=2**31, seed=self.seed):
            yield epoch, float(batch["wav_lens"].sum()) / SAMPLE_RATE, shape(batch), batch


def shape(batch):
    """Rows, spectrogram frames, the LSTMs' frames (padded and summed over
    the valid ones) and the padded label width."""
    frames = batch["wavs"].shape[1] // HOP + 1
    valid = batch["wav_lens"].astype("int64") // HOP + 1
    return {"rows": int(batch["wavs"].shape[0]), "frames": int(frames),
            "enc_frames": (frames - 1) // 2 + 1,
            "enc_valid": int(((valid - 1) // 2 + 1).sum()),
            "labels": int(batch["labels"].shape[1])}


def flops(config, s):
    """Model FLOPs of one step at shape ``s`` (forward and backward). Every
    product's count is linear in the LSTMs' frame count (the convolutions'
    outputs and the recurrence both grow with it), so the reference is
    counted at 2 and 3 frames and the line through them is read at the
    step's frames: the same number as a count at full length, without
    tracing a thousand-step loop."""
    def count(enc_frames):
        def forward(model):
            frames = 2 * enc_frames - 1
            spect = torch.zeros(s["rows"], frames, config["model"]["n_freq"], device="meta")
            return model.logits(spect, torch.full((s["rows"],), frames, device="meta"))[0]

        return step_flops(lambda: reference_model(config), forward)

    at2 = count(2)
    return at2 + (count(3) - at2) * (s["enc_frames"] - 2)


def reference_readings(config, cell, corpus, seed, device, precision="float32", steps=3,
                       half_rows=False):
    """The reference's readings over the recipe's first ``steps`` batches,
    from the seeded weights, with the first step's logits and their valid
    frames; ``half_rows`` keeps the first half of each
    batch's rows (a planted fault). The batch norms take the whole batch's
    statistics, so a batch runs whole."""
    rc = config["recipe"]
    batches = ref_data.ds2_batches(corpus["manifest"], seed, rc["data"]["batch_size"],
                                   config["frozen"]["frame_buckets"],
                                   config["frozen"]["max_label_len"], steps)
    if half_rows:
        batches = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    model = reference_model(config).to(device)
    spec = model.init_spec()
    weights.load(model, weights.make(spec, seed, device))
    prec = Precision(precision)
    names = [n for n, *_ in spec]
    params = [dict(model.named_parameters())[n] for n in names]

    first = {}

    def loss_and_grads(host):
        b = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        b["feats"], b["feat_lens"] = frontend.log_spectrogram(b["wavs"], b["wav_lens"])
        logits, lens = model.logits(b["feats"], b["feat_lens"], prec)
        if not first:
            first.update(logits=logits.detach().float().cpu(), frames=lens.cpu())
        loss = model.ctc_losses(logits, lens, b).mean()
        return float(loss.detach()), list(torch.autograd.grad(loss, params))

    optim = rc["optim"]
    return dict(follow(model, names, batches, loss_and_grads,
                       lambda ps: AdamW(ps, constant(optim["lr"]),
                                        weight_decay=optim["weight_decay"]),
                       optim["grad_clip"]), **first)

"""The Conformer family: the recipe ``mindaudio_torch.recipes.conformer``
driven through its own entry points (``train.build_model``,
``make_optimizer``, ``make_step`` with ``device_features``), with the
benchmark's seeded weights and generators, on batches made in memory in the
layout the recipe's bucket sampler and collate give (the collate, which
reads WAV files on the host, is not on the timed path: see ``corpus``);
and its reference (``reference/conformer.py``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench import traffic as T
from portbench import weights
from portbench.reference import conformer as ref
from portbench.reference import frontend
from portbench.reference.optim import AdamW, follow, noam
from portbench.reference.precision import Precision
from portbench.work.flops import step_flops

FRAME_LEN, FRAME_SHIFT = 400, 160
IGNORE_ID = -1  # the decoder targets' padding


def generator_seeds(seed):
    """The recipe's two generators (features, dropout), seeded from the
    run's seed."""
    return (seed + 1) % 2**63, (seed + 2) % 2**63


def corpus(config, cell, seed, device, root=None):
    """One epoch of the cell's traffic as the recipe's bucket sampler and
    collate would hand it to the step, made in memory: each utterance in the
    bucket of its Kaldi frame count, each bucket permuted by the seed and cut
    into whole batches of ``batch_bucket_limit * batch_factor`` rows, the
    batches shuffled; audio as 16-bit PCM padded to ``frames * 160 + 400``
    samples (white noise drawn on ``device``, one call a batch, zeros past
    each row), labels as ``chars_per_s`` vocabulary ids a second (no
    ``<blank>``, ``<unk>`` or ``<sos/eos>``) cut to ``max_label_len``, with
    the decoder's ``<sos> y`` / ``y <eos>`` rows. Returns ``{"batches":
    [...], "audio_s": [...]}``."""
    tr, data = cell["traffic"], config["recipe"]["data"]
    rate, limits = int(tr["sample_rate"]), data["frame_bucket_limit"]
    sizes = [max(1, int(b * float(cell["recipe"]["data"]["batch_factor"])))
             for b in data["batch_bucket_limit"]]
    max_label, vocab = int(data["max_label_len"]), int(config["model"]["vocab_size"])
    eos = vocab - 1
    buckets = [[] for _ in limits]
    for d in T.durations(tr):
        n = int(round(d * rate))
        frames = 1 + (n - FRAME_LEN) // FRAME_SHIFT
        buckets[next(i for i, f in enumerate(limits) if frames <= f)].append(n)
    rng = np.random.default_rng(seed)
    plan = []
    for i, lengths in enumerate(buckets):
        if len(lengths) % sizes[i]:
            raise ValueError(f"bucket {limits[i]}: {len(lengths)} utterances are not whole "
                             f"batches of {sizes[i]}")
        lengths = [lengths[k] for k in rng.permutation(len(lengths))]
        plan += [(i, lengths[j:j + sizes[i]]) for j in range(0, len(lengths), sizes[i])]
    rng.shuffle(plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    level = float(tr["level"]) * 32767.0
    cps = float(tr["chars_per_s"])
    batches, audio = [], []
    for i, lengths in plan:
        b, wav_len = len(lengths), limits[i] * FRAME_SHIFT + FRAME_LEN
        lens = torch.tensor(lengths, device=device)
        noise = torch.randn(b, wav_len, generator=gen, device=device) * level
        noise = noise.clamp_(-32768, 32767).to(torch.int16)
        noise *= (torch.arange(wav_len, device=device)[None, :] < lens[:, None])
        label_lens = np.array([min(max(1, round(cps * n / rate)), max_label)
                               for n in lengths], np.int32)
        labels = np.zeros((b, max_label), np.int32)
        ys_in = np.full((b, max_label + 1), eos, np.int32)
        ys_out = np.full((b, max_label + 1), IGNORE_ID, np.int32)
        for r, k in enumerate(label_lens):
            y = rng.integers(2, eos, k)
            labels[r, :k], ys_in[r, 1:1 + k], ys_out[r, :k], ys_out[r, k] = y, y, y, eos
        batches.append({"wavs": noise.cpu().numpy(), "wav_lens": np.array(lengths, np.int32),
                        "labels": labels, "label_lens": label_lens, "ys_in": ys_in,
                        "ys_out": ys_out, "ys_lens": label_lens + 1})
        audio.append(sum(lengths) / rate)
    return {"batches": batches, "audio_s": audio}


def recipe_config(config, cell, device):
    """The recipe's YAML with the configuration's and the cell's values."""
    from mindaudio_torch.recipes.conformer import train as recipe

    cfg, _ = recipe.parse_args(["--device", str(device)])
    model = {k: v for k, v in config["model"].items() if k != "vocab_size"}
    for section, values in [("model", model)] + list(config["recipe"].items()) + list(
            cell["recipe"].items()):
        for key, value in values.items():
            cfg[section][key] = value
    cfg.data.cmvn_file = ""  # no CMVN statistics (see the configuration's assumptions)
    return cfg


def reference_model(config):
    return ref.Conformer(**config["model"])


class Trainer:
    """The recipe's model, optimizer and step for one run, and the
    corpus's batches epoch after epoch."""

    def __init__(self, config, cell, corpus, seed, device):
        from mindaudio_torch.recipes.conformer import train as recipe

        cfg = recipe_config(config, cell, device)
        self.cfg, self.corpus = cfg, corpus
        spec = reference_model(config).init_spec()
        self.model = recipe.build_model(cfg, config["model"]["vocab_size"], device).train()
        weights.load(self.model, weights.make(spec, seed, device))
        features, dropout = generator_seeds(seed)
        self.generators = {"features": torch.Generator(device=device).manual_seed(features),
                           "dropout": torch.Generator(device=device).manual_seed(dropout)}
        self.model.set_dropout_generator(self.generators["dropout"])
        self.output_module = self.model.ctc_proj  # its output: the CTC head's logits
        self.optimizer = recipe.make_optimizer(cfg, self.model)
        self.step, _ = recipe.make_step(cfg, self.model, self.optimizer, self.generators)
        self.steps_per_epoch = len(corpus["batches"])

    def batches(self):
        """``(epoch, seconds of audio, shape, batch)`` without end."""
        for epoch in itertools.count():
            for audio_s, batch in zip(self.corpus["audio_s"], self.corpus["batches"]):
                yield epoch, audio_s, shape(batch), batch


def shape(batch):
    """What the work counts need of a batch: rows, feature frames, the
    encoder's frames (padded and summed over the valid ones) and the padded
    label width."""
    frames = 1 + (batch["wavs"].shape[1] - FRAME_LEN) // FRAME_SHIFT
    valid = 1 + (batch["wav_lens"].astype("int64") - FRAME_LEN) // FRAME_SHIFT
    return {"rows": int(batch["wavs"].shape[0]), "frames": int(frames),
            "enc_frames": ((frames - 1) // 2 - 1) // 2,
            "enc_valid": int((((valid - 1) // 2 - 1) // 2).sum()),
            "labels": int(batch["labels"].shape[1])}


def flops(config, s):
    """Model FLOPs of one step at shape ``s`` (forward and backward)."""
    def forward(model):
        feats = torch.zeros(s["rows"], s["frames"], config["model"]["input_dim"], device="meta")
        lens = torch.full((s["rows"],), s["frames"], device="meta")
        ys = torch.zeros(s["rows"], s["labels"] + 1, dtype=torch.long, device="meta")
        drop = ref.Dropout(0.0, None, s["rows"])
        enc, mask = model.encode(feats, lens, drop)
        dec = model.decode(enc, mask, ys, lens.new_full((s["rows"],), s["labels"] + 1), drop)
        return model.ctc_proj(enc, ref.FLOAT32).sum() + dec.sum()

    return step_flops(lambda: reference_model(config), forward)


def reference_readings(config, cell, corpus, seed, device, precision="float32", steps=3,
                       half_rows=False):
    """The reference's readings over the corpus's first ``steps`` batches,
    from the seeded weights and generators, with the first step's CTC
    logits and their valid frames; ``half_rows`` keeps the first
    half of each batch's rows (a planted fault)."""
    rc = config["recipe"]
    feat, model_cfg = rc["features"], config["model"]
    batches = [{k: v if k == "wavs" else v.astype(np.int64) for k, v in b.items()}
               for b in corpus["batches"][:steps]]
    if half_rows:
        batches = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    model = reference_model(config).to(device)
    spec = model.init_spec()
    weights.load(model, weights.make(spec, seed, device))
    features, dropout = generator_seeds(seed)
    gf = torch.Generator(device=device).manual_seed(features)
    gd = torch.Generator(device=device).manual_seed(dropout)
    prec = Precision(precision)
    names = [n for n, *_ in spec]
    params = [dict(model.named_parameters())[n] for n in names]

    def loss_and_grads(host):
        b = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        with torch.no_grad():
            feats = frontend.kaldi_fbank(b["wavs"], feat["num_mel_bins"],
                                         dither=feat["dither"], generator=gf)
            if feat["spec_aug"]:
                feats = frontend.spec_augment(feats, feat["num_t_mask"], feat["num_f_mask"],
                                              feat["max_t"], feat["max_f"], gf)
        b["feats"], b["feat_lens"] = feats, 1 + (b["wav_lens"] - FRAME_LEN) // FRAME_SHIFT
        rows = b["feats"].shape[0]
        per_block = max(1, int(cell["reference_block_frames"]) // feats.shape[1])
        drop = ref.Dropout(model_cfg["dropout_rate"], gd, rows)
        grads, total = [torch.zeros_like(p) for p in params], 0.0
        keep = [] if not first else None
        for lo in range(0, rows, per_block):
            block = slice(lo, lo + per_block)
            drop.start(block)
            loss = model.row_losses({k: v[block] for k, v in b.items()}, drop, prec,
                                    keep).sum() / rows
            for g, d in zip(grads, torch.autograd.grad(loss, params)):
                g += d
            total += float(loss.detach())
        if keep is not None:
            first.update(logits=torch.cat([k[0] for k in keep]),
                         frames=torch.cat([k[1] for k in keep]))
        return total, grads

    first = {}
    optim = rc["optim"]
    return dict(follow(model, names, batches, loss_and_grads,
                       lambda ps: AdamW(ps, noam(optim["lr"], optim["warmup_steps"]),
                                        weight_decay=optim["weight_decay"]),
                       optim["grad_clip"]), **first)


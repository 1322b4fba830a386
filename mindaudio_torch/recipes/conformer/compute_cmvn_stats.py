"""Global CMVN statistics over the train manifest, from the port's
``kaldi_fbank`` on the card (port of ``examples/conformer/compute_cmvn_stats.py``):
the features are those the train step computes (without dither), so the
stats match what the model sees.

Usage::

    python -m mindaudio_torch.recipes.conformer.compute_cmvn_stats \\
        --config conformer.yaml [--device cuda] [--data.train_csv ...]
"""

from __future__ import annotations

import torch

from ...utils.cmvn import CMVNAccumulator, save_cmvn
from ...utils.tokenizer import CharTokenizer
from .dataset import batch_iterator, read_manifest
from .train import device_features, parse_args


def main(argv=None):
    """Write ``data.cmvn_file``; returns the accumulator."""
    cfg, device = parse_args(argv)
    tok = CharTokenizer.from_transcripts(u.text for u in read_manifest(cfg.data.train_csv))
    acc = CMVNAccumulator(cfg.features.num_mel_bins)
    for _, _, batch in batch_iterator(cfg.data.train_csv, tok, epochs=1, speed_perturb=False,
                                      batch_factor=float(cfg.data.batch_factor)):
        wavs = torch.from_numpy(batch["wavs"]).to(device)
        wav_lens = torch.from_numpy(batch["wav_lens"]).long().to(device)
        with torch.no_grad():
            feats, feat_lens = device_features(cfg, wavs, wav_lens, train=False)
        acc.update(feats.cpu().numpy(), feat_lens.cpu().numpy())
    save_cmvn(cfg.data.cmvn_file, acc)
    print(f"wrote {cfg.data.cmvn_file}: {acc.frame_num} frames")
    return acc


if __name__ == "__main__":
    main()

"""Conv-TasNet evaluation: SI-SNRi and SDRi over the test set (port of
``examples/conv_tasnet/eval.py``).

Each test utterance (batch 1, cut to ``data.segment_seconds`` from its
start) is separated on the card; the best permutation of the PIT loss
reorders the targets there, so that each estimate is scored against its own
source. SI-SNRi and BSS Eval v3's SDRi (``metric/snr``, a 512-tap
projection) are computed on the host over the valid samples. Evaluates the
latest checkpoint under ``train.ckpt_dir``. TasNet's eval
(``recipes/tasnet/eval.py``) runs the same loop on its own forward.

Usage::

    python -m mindaudio_torch.recipes.conv_tasnet.eval [--config conv_tasnet.yaml] \\
        [--device cuda] [--data.test_dir ...] [--train.ckpt_dir ...]
"""

from __future__ import annotations

import torch

from ...data.librimix import separation_batch_iterator
from ...loss.separation_loss import pit_si_snr_loss
from ...metric.snr import cal_SDRi, cal_SISNRi
from ...train.checkpoint import load_model_state, restore_checkpoint
from .train import build_model, parse_args, segment_len, separate


def separate_and_pair(model, separate_fn, mix, src, lengths):
    """``(est (B, C, T), src reordered (B, C, T))`` on the device: the
    targets reordered by the best permutation of the PIT loss."""
    with torch.no_grad():
        est = separate_fn(model, mix)
        _, perm = pit_si_snr_loss(est, src, lengths)
        return est, torch.take_along_dim(src, perm[:, :, None], dim=1)


def evaluate(model, separate_fn, test_dir, seg, device):
    """Mean SI-SNRi and SDRi (dB) of ``model`` over the utterances of
    ``test_dir``: ``{"utts", "si_snri", "sdri"}``."""
    model.eval()
    si_snri, sdri, count = 0.0, 0.0, 0
    for _, batch in separation_batch_iterator(test_dir, 1, seg, epochs=1, shuffle=False):
        est, src = separate_and_pair(
            model, separate_fn, *(torch.from_numpy(batch[k]).to(device)
                                  for k in ("mix", "src", "lengths")))
        n = int(batch["lengths"][0])
        est = est.cpu().numpy()[0, :, :n]
        src = src.cpu().numpy()[0, :, :n]
        mix = batch["mix"][0, :n]
        si_snri += cal_SISNRi(src, est, mix)[0]
        sdri += cal_SDRi(src, est, mix)[0]
        count += 1
    return {"utts": count, "si_snri": float(si_snri) / max(count, 1),
            "sdri": float(sdri) / max(count, 1)}


def report(result):
    print(f"utts={result['utts']} SI-SNRi={result['si_snri']:.2f} dB "
          f"SDRi={result['sdri']:.2f} dB", flush=True)
    return result


def main(argv=None):
    """Evaluate the latest checkpoint; prints and returns ``{"utts",
    "si_snri", "sdri"}`` (dB)."""
    cfg, device = parse_args(argv)
    model = build_model(cfg, device)
    load_model_state(model, restore_checkpoint(cfg.train.ckpt_dir))
    return report(evaluate(model, separate, cfg.data.test_dir, segment_len(cfg), device))


if __name__ == "__main__":
    main()

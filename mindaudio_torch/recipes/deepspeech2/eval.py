"""DeepSpeech2 LibriSpeech evaluation: CTC greedy decode and CER/WER (port of
``examples/deepspeech2/eval.py``).

The spectrogram, the forward (batch norms on their running statistics) and
the argmax run on the card; the repeat/blank collapse and the edit
distances on the host. Decodes the latest checkpoint under
``train.ckpt_dir``.

Usage::

    python -m mindaudio_torch.recipes.deepspeech2.eval [--config deepspeech2.yaml] \\
        [--device cuda] [--data.test_manifest ...] [--train.ckpt_dir ...]
"""

from __future__ import annotations

import torch

from ...metric.wer import cer, wer
from ...train.checkpoint import load_model_state, restore_checkpoint
from ...utils.common import remove_duplicates_and_blank
from .dataset import BLANK_ID, LABELS, batch_iterator
from .train import build_model, device_features, parse_args


def main(argv=None):
    """Decode the test manifest; prints and returns ``{"utts", "cer", "wer"}``
    (fractions, not percents)."""
    cfg, device = parse_args(argv)
    model = build_model(cfg, device)
    load_model_state(model, restore_checkpoint(cfg.train.ckpt_dir))
    model.eval()

    refs, hyps = [], []
    for _, batch in batch_iterator(cfg.data.test_manifest, int(cfg.data.batch_size), epochs=1,
                                   shuffle=False, drop_last=False):
        with torch.no_grad():
            wavs = torch.from_numpy(batch["wavs"]).to(device)
            feats, feat_lens = device_features(wavs, torch.from_numpy(batch["wav_lens"]).to(device))
            logits, out_lens = model(feats, feat_lens)
            best, out_lens = logits.argmax(-1).cpu().numpy(), out_lens.cpu().numpy()
        for i in range(batch["n_valid"]):
            ids = remove_duplicates_and_blank(best[i, : out_lens[i]].tolist(), BLANK_ID)
            hyps.append("".join(LABELS[t] for t in ids))
            n = batch["label_lens"][i]
            refs.append("".join(LABELS[t] for t in batch["labels"][i, :n]))

    result = {"utts": len(refs), "cer": cer(refs, hyps),
              "wer": wer([r.split() for r in refs], [h.split() for h in hyps])}
    print(f"utts={result['utts']} CER={100 * result['cer']:.2f}% "
          f"WER={100 * result['wer']:.2f}%")
    return result


if __name__ == "__main__":
    main()

"""TasNet evaluation: SI-SNRi and SDRi over the test set (port of
``examples/tasnet/eval.py``), through :func:`train.separate_full` and the
Conv-TasNet recipe's eval loop (``recipes/conv_tasnet/eval.py``).

Usage::

    python -m mindaudio_torch.recipes.tasnet.eval [--config tasnet.yaml] [--device cuda] \\
        [--data.test_dir ...] [--train.ckpt_dir ...]
"""

from __future__ import annotations

from ...train.checkpoint import load_model_state, restore_checkpoint
from ..conv_tasnet.eval import evaluate, report
from ..conv_tasnet.train import segment_len
from .train import build_model, parse_args, separate_full


def main(argv=None):
    """Evaluate the latest checkpoint; prints and returns ``{"utts",
    "si_snri", "sdri"}`` (dB)."""
    cfg, device = parse_args(argv)
    model = build_model(cfg, device)
    load_model_state(model, restore_checkpoint(cfg.train.ckpt_dir))
    return report(evaluate(model, separate_full, cfg.data.test_dir, segment_len(cfg), device))


if __name__ == "__main__":
    main()

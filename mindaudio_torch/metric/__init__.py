"""Metrics (port of ``mindaudio_tpu.metric``): the error rates, the equal error
rate and the separation metrics (SI-SNRi, BSS Eval SDRi)."""

from .eer import get_eer, get_eer_from_scores  # noqa: F401
from .snr import bss_eval_sources, cal_SDRi, cal_SISNR, cal_SISNRi  # noqa: F401
from .wer import cer, wer  # noqa: F401

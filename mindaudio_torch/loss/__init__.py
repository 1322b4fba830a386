"""Training objectives of the port: CTC, label-smoothing KL, AAM-softmax, the
permutation-invariant SI-SNR of source separation and FastSpeech2's
multi-term loss."""

from .fastspeech2_loss import fastspeech2_loss  # noqa: F401
from .separation_loss import cal_si_snr, pit_si_snr_loss  # noqa: F401

# the reference's class names of the separation and FastSpeech2 losses, bound
# to the functions as the JAX package's ``loss/__init__.py`` binds them
Separation_Loss = pit_si_snr_loss
Convtasnet_Loss = pit_si_snr_loss
FastSpeech2Loss = fastspeech2_loss

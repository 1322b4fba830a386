"""Training objectives of the port: CTC, label-smoothing KL, AAM-softmax, the
permutation-invariant SI-SNR of source separation and FastSpeech2's
multi-term loss."""

from .aam_softmax import aam_softmax_loss, additive_angular_margin  # noqa: F401
from .ctc_loss import ctc_loss  # noqa: F401
from .fastspeech2_loss import fastspeech2_loss  # noqa: F401
from .label_smoothing_loss import label_smoothing_loss  # noqa: F401
from .separation_loss import cal_si_snr, pit_si_snr_loss  # noqa: F401

# the reference's class names, bound to the loss functions as the JAX
# package's ``loss/__init__.py`` binds them
CTC = ctc_loss
LabelSmoothingLoss = label_smoothing_loss
Separation_Loss = pit_si_snr_loss
Convtasnet_Loss = pit_si_snr_loss
AdditiveAngularMargin = additive_angular_margin
FastSpeech2Loss = fastspeech2_loss

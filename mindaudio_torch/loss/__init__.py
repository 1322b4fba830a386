"""Training objectives of the port: CTC, label-smoothing KL, AAM-softmax and
the permutation-invariant SI-SNR of source separation."""

from .separation_loss import cal_si_snr, pit_si_snr_loss  # noqa: F401

# the reference's class names of the separation loss, bound to the function,
# as the JAX package's ``loss/__init__.py`` binds them
Separation_Loss = pit_si_snr_loss
Convtasnet_Loss = pit_si_snr_loss

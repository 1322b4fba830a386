"""Device ops: the kaldi front-end, SpecAugment, resampling, the fused
log-mel, the CTC dynamic program and the int8 GEMM (port of
``mindaudio_tpu.ops``; kernels under ``csrc/``).

The names are the JAX package's; ``logmel`` is the counterpart of its
``pallas_mel``. Importing this package builds and loads no kernel: each is
built at its first launch (``_build``).
"""

from . import filterbanks, logmel, spectral, specaugment  # noqa: F401
from . import resample as _resample_mod  # noqa: F401
from .logmel import fused_logmel  # noqa: F401
from .resample import resample  # noqa: F401
from .specaugment import mask_along_axis, spec_augment  # noqa: F401
from .spectral import (  # noqa: F401
    amplitude_to_db,
    compute_deltas,
    fbank,
    global_cmvn,
    istft,
    kaldi_fbank,
    melscale,
    melspectrogram,
    mfcc,
    overlap_and_add,
    sliding_window_cmn,
    spectrogram,
    stft,
)

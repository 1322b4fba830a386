"""Host-side data layer (port of ``mindaudio_tpu.data``): WAV I/O, spectral
analysis, features, processing, filters, waveform augmentation and dataset
preparation (AISHELL-1, LibriSpeech, VoxCeleb, and the LibriMix JSON lists in
``data.librimix``).

Every submodule's names are re-exported here, as the JAX package's
``data/__init__.py`` does, so that ``mindaudio_torch.read``,
``mindaudio_torch.stft`` etc. resolve.
"""

from . import aishell, augment, features, filters, io, librispeech, processing, spectrum, voxceleb
from .aishell import prepare_aishell  # noqa: F401
from .augment import *  # noqa: F401,F403
from .features import *  # noqa: F401,F403
from .filters import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .librispeech import prepare_librispeech  # noqa: F401
from .processing import *  # noqa: F401,F403
from .spectrum import *  # noqa: F401,F403
from .voxceleb import prepare_voxceleb  # noqa: F401

__all__ = (
    list(io.__all__)
    + list(spectrum.__all__)
    + list(features.__all__)
    + list(processing.__all__)
    + list(augment.__all__)
    + list(filters.__all__)
    + ["prepare_aishell", "prepare_librispeech", "prepare_voxceleb"]
)

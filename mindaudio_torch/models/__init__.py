"""Model zoo of the port (``nn.Module``s on ``(B, T, D)`` tensors), with the
JAX package's ``models`` names."""

from .asr_model import ASRModel  # noqa: F401
from .conformer import ConformerEncoder, TransformerDecoder  # noqa: F401
from .conv_tasnet import ConvTasNet  # noqa: F401
from .deepspeech2 import DeepSpeechModel  # noqa: F401
from .ecapa_tdnn import Classifier, EcapaTDNN  # noqa: F401
from .fastspeech2 import FastSpeech2, FastSpeech2WithLoss  # noqa: F401
from .greedy_decoder import GreedyCTCDecoder, MSGreedyDecoder  # noqa: F401
from .tasnet import TasNet  # noqa: F401
from .wavegrad import WaveGrad, WaveGradWithLoss  # noqa: F401

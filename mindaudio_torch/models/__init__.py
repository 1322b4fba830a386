"""Model modules of the port (``nn.Module``s on ``(B, T, D)`` tensors)."""

from .wavegrad import WaveGrad, WaveGradWithLoss

__all__ = ["WaveGrad", "WaveGradWithLoss"]

"""Model modules of the port (``nn.Module``s on ``(B, T, D)`` tensors)."""

"""The plain reference: PyTorch and NumPy only, no kernel and nothing of
``mindaudio_torch`` or the JAX package. Frozen copies of the arithmetic the
cells run (front ends, models, losses, AdamW, the recipes' batch order), so
that a later change to the port cannot move the yardstick with it.
"""

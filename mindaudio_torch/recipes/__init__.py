"""Training and decoding recipes of the port (counterparts of ``examples/``)."""

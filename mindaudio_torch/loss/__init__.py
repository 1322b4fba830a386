"""Training objectives of the port: CTC and label-smoothing KL."""

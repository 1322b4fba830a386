"""Training objectives of the port: CTC, label-smoothing KL and AAM-softmax."""

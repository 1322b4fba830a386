"""Training infrastructure of the port: optimizer and train step."""

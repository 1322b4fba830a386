"""Learning-rate schedules of the port: step -> learning rate."""

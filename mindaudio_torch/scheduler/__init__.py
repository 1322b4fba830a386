"""Learning-rate schedules of the port: step -> learning rate."""

from .schedules import (  # noqa: F401
    ASRLearningRate,
    ASRWarmupLR,
    CosineLearningRate,
    asr_warmup_lr,
    cosine_lr,
    cyclic_triangular_lr,
    exponential_decay_lr,
    step_lr,
    warmup_poly_lr,
)

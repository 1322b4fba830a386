"""Training infrastructure of the port: the train step, the optimizer,
checkpointing, config, logging and profiling.

The JAX package's ``TrainState`` has no counterpart: the port trains an
``nn.Module`` with ``train.optim.AdamW`` through :func:`make_train_step`.
"""

from .checkpoint import (  # noqa: F401
    CheckpointManager,
    average_checkpoints,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from .config import Config, get_config, load_config  # noqa: F401
from .log import get_logger  # noqa: F401
from .profiler import StepTimer, annotate, trace  # noqa: F401
from .state import clip_by_global_norm, make_train_step, skip_nonfinite_update  # noqa: F401

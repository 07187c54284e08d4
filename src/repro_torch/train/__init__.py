"""Training substrate of the port: optimizer, trainer loop, checkpointing."""
from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .trainer import TrainConfig, Trainer, make_train_step

__all__ = ["AdamWConfig", "CheckpointManager", "TrainConfig", "Trainer",
           "adamw_update", "init_opt_state", "make_train_step"]

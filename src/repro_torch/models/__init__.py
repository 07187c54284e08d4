"""Model substrate of the port (dense decoder with the ``attn`` block)."""
from .config import ArchConfig
from .lm import (LM, exec_mode, forward, init_params, init_states, lm_loss,
                 xent_loss)

__all__ = ["ArchConfig", "LM", "exec_mode", "forward", "init_params",
           "init_states", "lm_loss", "xent_loss"]

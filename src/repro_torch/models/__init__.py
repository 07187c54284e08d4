"""Model substrate of the port (the ``attn``, ``shared_attn`` and ``mamba2``
blocks: the dense decoders and zamba2)."""
from .config import ArchConfig
from .lm import (LM, exec_mode, forward, init_params, init_states, lm_loss,
                 xent_loss)

__all__ = ["ArchConfig", "LM", "exec_mode", "forward", "init_params",
           "init_states", "lm_loss", "xent_loss"]

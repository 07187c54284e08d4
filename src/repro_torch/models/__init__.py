"""Model substrate of the port (the ``attn``, ``attn_swa``, ``moe``,
``moe_swa``, ``shared_attn``, ``mamba2``, ``mlstm`` and ``slstm`` blocks: the
dense and mixture-of-experts decoders, zamba2 and xlstm)."""
from .config import ArchConfig
from .lm import (LM, exec_mode, forward, init_params, init_states, lm_loss,
                 xent_loss)

__all__ = ["ArchConfig", "LM", "exec_mode", "forward", "init_params",
           "init_states", "lm_loss", "xent_loss"]

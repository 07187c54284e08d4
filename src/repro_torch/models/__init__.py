"""Model substrate of the port: every block kind of ``repro.models.blocks``
(the dense and mixture-of-experts decoders, zamba2, xlstm, the
cross-attention VLM and the whisper encoder-decoder)."""
from .config import ArchConfig
from .encdec import (EncDec, encdec_forward, encdec_loss, encode,
                     init_encdec_params)
from .lm import (LM, exec_mode, forward, init_params, init_states, lm_loss,
                 precompute_cross_states, xent_loss)

__all__ = ["ArchConfig", "EncDec", "LM", "encdec_forward", "encdec_loss",
           "encode", "exec_mode", "forward", "init_encdec_params",
           "init_params", "init_states", "lm_loss", "precompute_cross_states",
           "xent_loss"]

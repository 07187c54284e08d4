"""Post-training quantization: float weights -> W8A8 integer execution.

Port of ``repro.quant.ptq.ptq_quantize_params`` for the int8 policy
(``policy=None``): every GEMM weight (attention wq/wk/wv/wo, MLP
w_in/w_gate/w_out and the ``unembed`` head) becomes per-output-channel
symmetric int8; embeddings and norms stay float.  The reference runs PTQ
eagerly, so ``amax / 127.0`` is a true division here.  Bit-exact against the
reference (``tests/test_torch_models.py``).
"""
from __future__ import annotations

import torch

from ..models.layers import Linear, quantize_weight
from ..models.lm import LM

_QUANT_NAMES = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "unembed")


@torch.no_grad()
def ptq_quantize_params(params: LM, policy: dict | None = None) -> LM:
    """Quantize the model's GEMM weights to int8 IN PLACE (the float weight
    is dropped as each payload is made, so peak memory stays near one
    model) and return the model."""
    if policy is not None:
        raise NotImplementedError("W4A8 policies (int4_gemm) are slice 2 of "
                                  "the port (ROADMAP.md §B)")
    for name, mod in params.named_modules():
        if (isinstance(mod, Linear) and not mod.quantized
                and name.rsplit(".", 1)[-1] in _QUANT_NAMES):
            q = quantize_weight(mod.weight)
            mod.quantize_(q["w_q"], q["scale"])
    return params

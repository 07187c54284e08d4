"""Error-feedback int8 gradient compression (port of
``repro.dist.compression``): the cross-pod all-reduce payload.

Per-tensor symmetric int8 quantization (``core.inumerics``) plus an
error-feedback accumulator.  The wire payload is the int8 tensors + one f32
scale per tensor (a 4x shrink against f32 gradients), and the quantization
error is carried into the next step instead of being dropped — the EF sum
telescopes, so the ACCUMULATED update tracks the true gradient sum even
though each step is coarsely quantized.  Trees are name -> tensor
mappings; the payload and the error state are bit-exact against the
reference's jitted functions (the residual ``c - q*s`` is one FMA there,
``fma_f32`` here).

Contract used by ``train.trainer``:

    err   = init_error_state(params)            # zeros, f32, like params
    payload, err = compress_grads(grads, err)   # payload crosses the wire
    grads = decompress_grads(payload)           # at the receiver
"""
from __future__ import annotations

import torch

from ..core.inumerics import absmax_scale, quantize
from ..kernels.common import fma_f32

F32 = torch.float32


def init_error_state(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Zero residual accumulator shaped like ``params`` (f32)."""
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def compress_grads(grads: dict[str, torch.Tensor],
                   err_state: dict[str, torch.Tensor]):
    """(grads, err) -> (wire payload, new err).

    payload = {"q": int8 tensors, "scale": f32 0-dim tensors}.  The
    corrected gradient g + err is quantized; what the int8 grid cannot
    represent goes back into err for the next step."""
    q, scales, new_err = {}, {}, {}
    for k, g in grads.items():
        c = g.to(F32) + err_state[k]
        s = absmax_scale(c, bits=8)
        qi = quantize(c, s, bits=8).to(torch.int8)
        new_err[k] = fma_f32(-qi.to(F32), s, c)
        q[k], scales[k] = qi, s
    return {"q": q, "scale": scales}, new_err


def decompress_grads(payload: dict) -> dict[str, torch.Tensor]:
    """Wire payload -> f32 gradients (receiver side)."""
    return {k: qi.to(F32) * payload["scale"][k]
            for k, qi in payload["q"].items()}

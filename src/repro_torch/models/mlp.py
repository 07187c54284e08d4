"""Feed-forward block: the plain (non-gated) MLP of ``repro.models.mlp``.

The w8a8 GELU MLP takes the fused up-projection (``linear_gelu_w8a8``: the
GEMM epilogue requantizes and runs the integer GELU in-register).  Gated
(SwiGLU/GeGLU) MLPs are slice 2 (ROADMAP.md §B: ``dual_gemm_gated``).
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ArchConfig
from .layers import ExecMode, Linear, activation, apply_linear, dense_init, \
    linear_gelu_w8a8


class MLP(nn.Module):
    def __init__(self, w_in: Linear, w_out: Linear):
        super().__init__()
        self.w_in, self.w_out = w_in, w_out


def init_mlp_params(gen: torch.Generator, cfg: ArchConfig, device) -> MLP:
    if cfg.activation == "silu":
        raise NotImplementedError("gated (SwiGLU) MLPs are slice 2 of the "
                                  "port (ROADMAP.md §B)")
    d, ff = cfg.d_model, cfg.d_ff
    return MLP(Linear(dense_init(gen, d, ff, device)),
               Linear(dense_init(gen, ff, d, device)))


def mlp(params: MLP, x, cfg: ArchConfig, mode: ExecMode):
    if cfg.activation == "gelu" and mode.integer and params.w_in.quantized:
        h = linear_gelu_w8a8(x, params.w_in.w_q, params.w_in.scale,
                             compute_dtype=mode.compute_dtype)
    else:
        h = apply_linear(x, params.w_in, mode)
        h = activation(h, cfg.activation, mode)
    return apply_linear(h, params.w_out, mode)

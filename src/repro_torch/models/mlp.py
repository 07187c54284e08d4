"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (GELU) MLPs, the
dense MLP of ``repro.models.mlp``.

Integer paths take the fused kernels: the gated hidden is one dual GEMM
over a shared A tile with the integer activation in its epilogue
(``dual_gemm_gated`` at W8A8, ``dual_int4_gemm_gated`` at W4A8); the GELU
MLP's up-projection runs the integer GELU in the GEMM epilogue.  The float
gated hidden is the float ``dual_gemm_gated``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops
from .config import ArchConfig
from .layers import (ExecMode, Linear, QRows, activation, apply_linear,
                     dense_init, linear_gated_w4a8, linear_gated_w8a8,
                     linear_gelu_w4a8, linear_gelu_w8a8)


class MLP(nn.Module):
    def __init__(self, w_in: Linear, w_out: Linear,
                 w_gate: Linear | None = None):
        super().__init__()
        self.w_in, self.w_out, self.w_gate = w_in, w_out, w_gate


def init_mlp_params(gen: torch.Generator, cfg: ArchConfig, device) -> MLP:
    """w_in [d, ff], w_out [ff, d], and w_gate [d, ff] for the SwiGLU
    (``activation == "silu"``) lineage."""
    d, ff = cfg.d_model, cfg.d_ff
    w_in = Linear(dense_init(gen, d, ff, device))
    w_out = Linear(dense_init(gen, ff, d, device))
    w_gate = (Linear(dense_init(gen, d, ff, device))
              if cfg.activation == "silu" else None)
    return MLP(w_in, w_out, w_gate)


def gated_ffn_hidden(params: MLP, x, cfg: ArchConfig, mode: ExecMode,
                     xq: QRows | None = None):
    """``activation(x @ w_gate) * (x @ w_in)``: the fused dual GEMM for
    int4, int8 and float weights; the unfused composition for the mixed
    corners (PTQ'd weights under a float mode, or an integer mode over
    float weights).  ``xq``: x's rows already quantized (the fused norm's),
    shared by both projections."""
    w_in, w_gate = params.w_in, params.w_gate
    if mode.integer and w_in.int4 and w_gate.int4:
        return linear_gated_w4a8(x, w_in, w_gate, cfg.activation,
                                 compute_dtype=mode.compute_dtype, xq=xq)
    if mode.integer and w_in.quantized and not w_in.int4:
        return linear_gated_w8a8(x, w_in.w_q, w_in.scale, w_gate.w_q,
                                 w_gate.scale, cfg.activation,
                                 compute_dtype=mode.compute_dtype, xq=xq)
    if not mode.integer and not w_in.quantized:
        return ops.gated_mlp(x, w_in.weight, w_gate.weight, cfg.activation,
                             mode.compute_dtype)
    h = apply_linear(x, w_in, mode, xq=xq)
    g = apply_linear(x, w_gate, mode, xq=xq)
    return activation(g, cfg.activation, mode) * h


def mlp(params: MLP, x, cfg: ArchConfig, mode: ExecMode,
        xq: QRows | None = None):
    """The MLP of x; ``xq``: x's rows already quantized (the fused norm's)
    for the integer up and gate projections."""
    w_in = params.w_in
    if params.w_gate is not None:
        h = gated_ffn_hidden(params, x, cfg, mode, xq)
    elif cfg.activation == "gelu" and mode.integer and w_in.int4:
        h = linear_gelu_w4a8(x, w_in.w4, w_in.qmul, w_in.scale,
                             compute_dtype=mode.compute_dtype, xq=xq)
    elif cfg.activation == "gelu" and mode.integer and w_in.quantized:
        h = linear_gelu_w8a8(x, w_in.w_q, w_in.scale,
                             compute_dtype=mode.compute_dtype, xq=xq)
    else:
        h = apply_linear(x, w_in, mode, xq=xq)
        h = activation(h, cfg.activation, mode)
    return apply_linear(h, params.w_out, mode)

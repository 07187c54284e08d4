"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (GELU) MLPs, the
dense MLP of ``repro.models.mlp``, and the experts of a MoE layer.

Integer paths take the fused kernels: the gated hidden is one dual GEMM
over a shared A tile with the integer activation in its epilogue
(``dual_gemm_gated`` at W8A8, ``dual_int4_gemm_gated`` at W4A8); the GELU
MLP's up-projection runs the integer GELU in the GEMM epilogue.  The float
gated hidden is the float ``dual_gemm_gated``.

Under serving tensor parallelism a rank holds a column slice of w_in and
w_gate (its d_ff / tp hidden columns) and the whole w_out, which runs behind
``dist.tp.tp_out_projection``.

A MoE layer's experts (``expert_ffn``) are an ``MLP`` whose weights are
stacked over E; where the reference runs ``jax.vmap`` of the gated hidden
and the down projection over them, the port runs each as ONE launch of the
kernels' expert-batched forms over the (E, G*C, D) dispatch rows.
"""
from __future__ import annotations

import torch
from torch import nn

from ..dist.tp import tp_out_projection
from ..kernels import ops
from .config import ArchConfig
from .layers import (GELU_INT_SCALE, SILU_INT_SCALE, ExecMode, Linear, QRows,
                     activation, apply_linear, dense_init, linear_gated_w4a8,
                     linear_gated_w8a8, linear_gelu_w4a8, linear_gelu_w8a8)


class MLP(nn.Module):
    def __init__(self, w_in: Linear, w_out: Linear,
                 w_gate: Linear | None = None):
        super().__init__()
        self.w_in, self.w_out, self.w_gate = w_in, w_out, w_gate


def init_mlp_params(gen: torch.Generator, cfg: ArchConfig, device,
                    d_ff: int | None = None, experts: int = 0) -> MLP:
    """w_in [d, ff], w_out [ff, d], and w_gate [d, ff] for the SwiGLU
    (``activation == "silu"``) lineage; ``d_ff`` overrides cfg.d_ff (a
    shared expert's width); ``experts`` > 0 stacks each weight over E."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    w_in = Linear(dense_init(gen, d, ff, device, experts))
    w_out = Linear(dense_init(gen, ff, d, device, experts))
    w_gate = (Linear(dense_init(gen, d, ff, device, experts))
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
    # serving-TP boundary (dist/tp.py): ``h`` is d_ff-sharded, w_out
    # replicated — full rows are rebuilt (barrier gather or all-to-all
    # token split) before the projection
    return tp_out_projection(
        h, None, lambda hh, _res: apply_linear(hh, params.w_out, mode))


def expert_ffn(params: MLP, xe, cfg: ArchConfig, mode: ExecMode):
    """The gated FFN of every expert: xe (E, R, D) -> (E, R, D), the
    reference's ``jax.vmap(expert_ffn)`` (``repro/models/moe.py:107-114``).
    Integer weights (integer mode): each row quantized once
    (``ops.quant_rows`` over all E * R rows, as the vmapped ``quant_rows``
    quantizes each expert's rows), the gated hidden as one dual-GEMM launch
    over the experts, its rows quantized, the down projection as one GEMM
    launch.  Float weights (float mode): the float dual GEMM over the
    experts, then the batched compute-dtype matmul of the reference's float
    ``apply_linear``.  The mixed corners (an integer mode over float experts,
    PTQ'd experts under a float mode) are not ported."""
    w_in, w_gate, w_out = params.w_in, params.w_gate, params.w_out
    if w_gate is None:
        raise NotImplementedError("MoE experts are gated (SwiGLU/GeGLU)")
    if mode.integer != w_in.quantized or mode.integer != w_out.quantized:
        raise NotImplementedError(
            f"MoE experts at {mode.precision} over "
            f"{'quantized' if w_in.quantized else 'float'} weights")
    if not mode.integer:
        h = ops.gated_mlp_experts(xe, w_in.weight, w_gate.weight,
                                  cfg.activation, mode.compute_dtype)
        cd = mode.compute_dtype
        return h.to(cd) @ w_out.weight.to(cd)
    act_scale = GELU_INT_SCALE if cfg.activation == "gelu" else SILU_INT_SCALE
    xq, xs = ops.quant_rows(xe)
    if w_in.int4 and w_gate.int4:
        h = ops.gated_mlp_w4a8_experts(
            xq, xs, w_in.w4, w_in.qmul, w_in.scale, w_gate.w4, w_gate.qmul,
            w_gate.scale, act=cfg.activation, act_scale=act_scale)
    elif not w_in.int4 and not w_gate.int4:
        h = ops.gated_mlp_w8a8_experts(
            xq, xs, w_in.w_q, w_in.scale, w_gate.w_q, w_gate.scale,
            act=cfg.activation, act_scale=act_scale)
    else:
        raise NotImplementedError("MoE up and gate in different forms")
    h = h.to(mode.compute_dtype)
    hq, hs = ops.quant_rows(h)
    if w_out.int4:
        return ops.gemm_w4a8_experts(hq, hs, w_out.w4, w_out.qmul,
                                     w_out.scale, out_dtype=mode.compute_dtype)
    return ops.gemm_w8a8_experts(hq, hs, w_out.w_q, w_out.scale,
                                 out_dtype=mode.compute_dtype)

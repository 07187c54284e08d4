"""Base layers: Linear (bf16, W8A8 and W4A8 paths), norms, RoPE, embeddings.

Port of ``repro.models.layers``.  ``Linear`` and ``Norm`` are the modules
that hold the weights: a float ``Linear`` keeps its weight in the
reference's [in, out] layout; after PTQ it holds, as buffers, an int8
``w_q`` [in, out] and a per-output-channel f32 ``scale`` [out] (W8A8), or
packed int4 ``w4`` [in/2, out], int8 group multipliers ``qmul``
[in/group, out] and ``scale`` [out] (W4A8, two-level group scales).  A MoE
layer's experts hold one ``Linear`` per projection with every tensor
stacked over a leading expert dimension E ([E, in, out]; ``scale`` [E,
out]), as the reference stacks them.  The functions mirror the reference one
for one.  Where the reference divides by a
Python-float constant under ``jax.jit`` (``/ 127.0``), the port multiplies
by the f32 reciprocal, as XLA does (``kernels/common.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from ..kernels import ops
from ..kernels.common import check, f32, rcp32
from ..kernels.int_gelu import gelu_out_scale
from ..kernels.int_silu import silu_out_scale
from ..kernels.quantize import pack_int4

DEFAULT_DTYPE = torch.bfloat16
F32 = torch.float32

# canonical static activation scale for the integer GELU path (the
# pre-activation clip range [-8, 8] mapped onto int8)
GELU_INT_SCALE = 8.0 / 127.0
# ... and for the integer SiLU (SwiGLU gate): the same clip range
SILU_INT_SCALE = 8.0 / 127.0
_RCP127 = rcp32(127.0)

# ---------------------------------------------------------------------------
# initializers (an explicit torch.Generator; numbers differ from jax.random)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               device, experts: int = 0) -> torch.Tensor:
    """[in, out], or [experts, in, out] stacked for a MoE layer."""
    std = 1.0 / math.sqrt(in_dim)
    shape = (experts, in_dim, out_dim) if experts else (in_dim, out_dim)
    return torch.randn(shape, generator=gen, device=device, dtype=F32) * std


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               device) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, device=device,
                       dtype=F32) * 0.02


# ---------------------------------------------------------------------------
# modules holding the weights
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """One GEMM weight in one of three forms: float ``weight`` [in, out];
    after int8 PTQ ``w_q`` [in, out] + f32 ``scale`` [out]; after int4 PTQ
    ``w4`` [in/2, out] + ``qmul`` [in/group, out] + f32 ``scale`` [out]
    (buffers).  A MoE layer's stacked experts: each with a leading [E]."""

    def __init__(self, weight: torch.Tensor | None = None, *,
                 w_q: torch.Tensor | None = None,
                 w4: torch.Tensor | None = None,
                 qmul: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None):
        super().__init__()
        if sum(t is not None for t in (weight, w_q, w4)) != 1:
            raise ValueError("Linear takes one of a float weight, an int8 "
                             "w_q or a packed int4 w4")
        self.weight = (None if weight is None
                       else nn.Parameter(weight, requires_grad=False))
        self.register_buffer("w_q", w_q)
        self.register_buffer("w4", w4)
        self.register_buffer("qmul", qmul)
        self.register_buffer("scale", scale)

    @property
    def quantized(self) -> bool:
        """True for either integer form (int8 or packed int4)."""
        return self.w_q is not None or self.w4 is not None

    @property
    def int4(self) -> bool:
        """True for the packed int4 form."""
        return self.w4 is not None

    def quantize_(self, payload: dict) -> None:
        """Replace the float weight by a PTQ payload, ``{w_q, scale}`` or
        ``{w4, qmul, scale}`` (in place)."""
        self.weight = None
        for name, t in payload.items():
            setattr(self, name, t)


class Norm(nn.Module):
    """LayerNorm (scale + bias) or RMSNorm (scale) parameters, f32 [d]."""

    def __init__(self, d: int, norm_type: str, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=F32, device=device),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d, dtype=F32, device=device),
                                  requires_grad=False)
                     if norm_type == "layernorm" else None)
        self._int_consts = None

    def int_consts(self):
        """(g_q, b_q, gb_s) of ``quantize_norm`` — the reference refolds
        them every call under jit; the weights are fixed, so the port
        computes them once."""
        if self._int_consts is None:
            self._int_consts = quantize_norm(
                self.scale.float(),
                None if self.bias is None else self.bias.float())
        return self._int_consts


# ---------------------------------------------------------------------------
# Linear: float path + integer path
# ---------------------------------------------------------------------------

class QRows(NamedTuple):
    """Rows quantized once for every integer GEMM that reads them: int8
    ``q`` [..., D] and f32 row scales ``scale`` [..., 1] (``ops.quant_rows``
    of the rows, bit for bit).  The fused norm returns them with its output,
    so q/k/v, the MLP's up and gate, Mamba-2's in_proj and the head quantize
    nothing themselves."""

    q: torch.Tensor
    scale: torch.Tensor


def _quant(x, xq: QRows | None):
    """The activation quant of an integer linear: ``xq`` where the caller
    has it, else ``ops.quant_rows(x)``."""
    return ops.quant_rows(x) if xq is None else xq


def linear(x, w, bias=None, compute_dtype=DEFAULT_DTYPE):
    """Matmul in the compute dtype (f32 accumulation inside)."""
    out = x.to(compute_dtype) @ w.to(compute_dtype)
    if bias is not None:
        out = out + bias.to(compute_dtype)
    return out


def linear_w8a8(x, w_q, w_scale, bias=None, compute_dtype=DEFAULT_DTYPE,
                residual=None, xq: QRows | None = None):
    """W8A8: dynamic per-row activation quant (or ``xq``, x's rows already
    quantized) -> int8 GEMM with the dequant (and optional residual add)
    fused into the epilogue."""
    x_q, x_scale = _quant(x, xq)
    return ops.gemm_w8a8(x_q, x_scale, w_q, w_scale, bias=bias,
                         residual=residual, out_dtype=compute_dtype)


def linear_gelu_w8a8(x, w_q, w_scale, compute_dtype=DEFAULT_DTYPE,
                     xq: QRows | None = None):
    """Fused W8A8 up-projection + integer GELU (MLP hot path), bit-identical
    to ``linear_w8a8`` followed by ``activation(..., "gelu")``."""
    x_q, x_scale = _quant(x, xq)
    out_q = ops.gemm_w8a8(x_q, x_scale, w_q, w_scale,
                          gelu_scale=GELU_INT_SCALE, out_dtype=compute_dtype)
    return (out_q.float() * f32(gelu_out_scale(GELU_INT_SCALE),
                                      x.device)).to(compute_dtype)


def linear_gated_w8a8(x, up_q, up_scale, gate_q, gate_scale, act: str,
                      compute_dtype=DEFAULT_DTYPE, xq: QRows | None = None):
    """Fused W8A8 gated-MLP hidden: one activation quant feeds the dual GEMM
    over a shared A tile; dequant and the integer activation(gate) * up
    finish in the epilogue.  Bit-identical to ``linear_w8a8`` twice, then
    the integer ``activation`` and the multiply."""
    x_q, x_scale = _quant(x, xq)
    act_scale = GELU_INT_SCALE if act == "gelu" else SILU_INT_SCALE
    return ops.gated_mlp_w8a8(x_q, x_scale, up_q, up_scale, gate_q,
                              gate_scale, act=act, act_scale=act_scale,
                              out_dtype=compute_dtype)


def quantize_weight(w: torch.Tensor) -> dict:
    """PTQ a float [..., in, out] weight: per-output-channel symmetric int8,
    the reduction over the input dimension only, so stacked experts keep
    their own channel scales (eager in the reference: a true division by
    127)."""
    wf = w.float()
    amax = torch.clamp(wf.abs().amax(-2), min=1e-8)
    scale = amax / 127.0
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -128,
                      127).to(torch.int8)
    return {"w_q": w_q, "scale": scale.float()}


def quantize_weight_w4(w: torch.Tensor, group: int = 64,
                       clip_ratio: float = 1.0) -> dict:
    """PTQ a float [in, out] weight to packed int4 with two-level group
    scales (eager in the reference: true divisions).

    Per ``group`` contraction rows the raw scale is clip_ratio * absmax / 7;
    the column maximum of those / 127 is the f32 column ``scale``, and each
    group keeps an int8 ratio ``qmul`` in [1, 127] against it.  Weights are
    quantized against the effective scale ``scale * qmul``, so the GEMM's
    group combine stays in int32.  Returns {"w4": [in/2, out], "qmul":
    [in/group, out] int8, "scale": [out] f32}."""
    wf = w.float()
    k, n = wf.shape[-2], wf.shape[-1]
    check(k % group == 0 and k % 2 == 0, f"K={k} is not a multiple of the "
          f"group {group} (and even)")
    wg = wf.reshape(*wf.shape[:-2], k // group, group, n)
    amax = torch.clamp(wg.abs().amax(-2, keepdim=True), min=1e-8)
    raw = (clip_ratio * amax) / 7.0                        # (.., K/g, 1, out)
    col = raw.amax(-3, keepdim=True) / 127.0               # (.., 1, 1, out)
    qmul = torch.clamp(torch.round(raw / col), 1, 127)
    q = torch.clamp(torch.round(wg / (col * qmul)), -8, 7).to(torch.int8)
    return {"w4": pack_int4(q.reshape(wf.shape)),
            "qmul": qmul.squeeze(-2).to(torch.int8),
            "scale": col.squeeze(-2).squeeze(-2).float()}


def linear_w4a8(x, w4, qmul, w_scale, bias=None, compute_dtype=DEFAULT_DTYPE,
                residual=None, xq: QRows | None = None):
    """W4A8: dynamic per-row activation quant (or ``xq``) -> packed-int4
    GEMM with the nibble unpack, group dequant (and residual add) fused
    in."""
    x_q, x_scale = _quant(x, xq)
    return ops.gemm_w4a8(x_q, x_scale, w4, qmul, w_scale, bias=bias,
                         residual=residual, out_dtype=compute_dtype)


def linear_gelu_w4a8(x, w4, qmul, w_scale, compute_dtype=DEFAULT_DTYPE,
                     xq: QRows | None = None):
    """Fused W4A8 up-projection + integer GELU, the twin of
    ``linear_gelu_w8a8``."""
    x_q, x_scale = _quant(x, xq)
    out_q = ops.gemm_w4a8(x_q, x_scale, w4, qmul, w_scale,
                          gelu_scale=GELU_INT_SCALE, out_dtype=compute_dtype)
    return (out_q.float() * f32(gelu_out_scale(GELU_INT_SCALE),
                                      x.device)).to(compute_dtype)


def linear_gated_w4a8(x, up: Linear, gate: Linear, act: str,
                      compute_dtype=DEFAULT_DTYPE, xq: QRows | None = None):
    """Fused W4A8 gated-MLP hidden: one activation quant feeds the dual
    packed-int4 GEMM over a shared A tile, the twin of
    ``linear_gated_w8a8``."""
    x_q, x_scale = _quant(x, xq)
    act_scale = GELU_INT_SCALE if act == "gelu" else SILU_INT_SCALE
    return ops.gated_mlp_w4a8(x_q, x_scale, up.w4, up.qmul, up.scale,
                              gate.w4, gate.qmul, gate.scale, act=act,
                              act_scale=act_scale, out_dtype=compute_dtype)


@dataclasses.dataclass(frozen=True)
class ExecMode:
    """Execution-mode switch threaded through the model."""

    precision: str = "bf16"        # bf16 | w8a8 | w4a8
    compute_dtype: object = DEFAULT_DTYPE

    @property
    def integer(self) -> bool:
        # w4a8 weights may mix int8 and int4 leaves (the head stays int8);
        # both ride the integer datapath and apply_linear dispatches per leaf
        return self.precision in ("w8a8", "w4a8")


def apply_linear(x, p: Linear, mode: ExecMode, bias=None, residual=None,
                 xq: QRows | None = None):
    """Dispatch on the weight the module holds: packed int4 (W4A8 GEMM),
    int8 ``w_q`` (W8A8 GEMM; both with the residual add in the epilogue and
    x's rows quantized once, or taken from ``xq``) or a float weight (its
    matmul with x, through ``ops.gemm_bf16`` at a bf16 compute dtype, then
    the residual add).  A residual in another dtype than
    the compute dtype (whisper's f32 encoder stream) is added after the
    projection's rounding to the compute dtype, as the reference's
    epilogue promotes it."""
    if (p.quantized and residual is not None
            and residual.dtype != mode.compute_dtype):
        return apply_linear(x, p, mode, bias, xq=xq) + residual
    if p.int4:
        return linear_w4a8(x, p.w4, p.qmul, p.scale, bias, mode.compute_dtype,
                           residual=residual, xq=xq)
    if p.quantized:
        return linear_w8a8(x, p.w_q, p.scale, bias, mode.compute_dtype,
                           residual=residual, xq=xq)
    if mode.compute_dtype == torch.bfloat16:
        # the bf16 GEMM kernel on the card (one order of K at any M or N, so
        # TP shards equal tp 1's slices); f32 linears stay torch.matmul
        out = ops.gemm_bf16(x, p.weight, bias)
    else:
        out = linear(x, p.weight.to(mode.compute_dtype), bias,
                     mode.compute_dtype)
    if residual is not None:
        out = out + residual
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def quantize_norm(gamma, beta):
    """int8-range payloads of float gamma/beta on one shared scale:
    (g_q, b_q, gb_s).  ``gb_amax / 127.0`` is the jitted reciprocal
    product; ``gamma / gb_s`` divides by a traced value (true division)."""
    gb_amax = torch.maximum(gamma.abs().max(), f32(1e-8, gamma.device))
    if beta is not None:
        gb_amax = torch.maximum(gb_amax, beta.abs().max())
    gb_s = gb_amax * f32(_RCP127, gamma.device)
    g_q = torch.clamp(torch.round(gamma / gb_s), -128, 127).to(torch.int32)
    b_q = (torch.clamp(torch.round(beta / gb_s), -128, 127).to(torch.int32)
           if beta is not None else torch.zeros_like(g_q))
    return g_q, b_q, gb_s


def norm_int_q(x, g_q, b_q, gb_s, rms_only: bool):
    """Integer norm of x with prequantized gamma/beta payloads, and its
    output's rows quantized for the next integer GEMM: (h in x's dtype,
    ``QRows``), one fused kernel on the card (``ops.norm_quant_rows``)."""
    h, q, s = ops.norm_quant_rows(x, g_q, b_q, gb_s, rms_only=rms_only)
    return h, QRows(q, s)


def norm_int(x, gamma, beta, rms_only: bool):
    """Integer-only norm (paper's ``norm`` kernel) for the w8a8 path:
    quantize the residual stream to int8, integer layernorm, dequantize."""
    g_q, b_q, gb_s = quantize_norm(gamma, beta)
    return norm_int_q(x, g_q, b_q, gb_s, rms_only)[0]


def apply_norm(x, p: Norm, cfg, mode: ExecMode):
    """The block's pre-norm: (h, ``QRows`` of h) in an integer mode, where
    the integer linears that read h take the quantized rows; (h, None) in a
    float mode."""
    if mode.integer:
        return norm_int_q(x, *p.int_consts(),
                          rms_only=cfg.norm_type == "rmsnorm")
    if cfg.norm_type == "layernorm":
        return layernorm(x, p.scale, p.bias, cfg.norm_eps), None
    return rmsnorm(x, p.scale, cfg.norm_eps), None


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation(x, kind: str, mode: ExecMode):
    """The MLP non-linearity: in an integer mode the integer GELU or SiLU
    kernel on the int8 requantization of ``x`` at a static scale (``x /
    scale`` under jit: a product with the f32 reciprocal), dequantized into
    ``x``'s dtype; else the float function."""
    if mode.integer and kind in ("gelu", "silu"):
        s = GELU_INT_SCALE if kind == "gelu" else SILU_INT_SCALE
        inv = f32(rcp32(s), x.device)
        q = torch.clamp(torch.round(x.float() * inv), -128, 127)
        q = q.to(torch.int32)
        if kind == "gelu":
            out, out_scale = ops.gelu_i8(q, s), gelu_out_scale(s)
        else:
            out, out_scale = ops.silu_i8(q, s), silu_out_scale(s)
        return (out.float() * f32(out_scale, x.device)).to(x.dtype)
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="none")
    if kind == "silu":
        return torch.nn.functional.silu(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x [..., S, H, D]; positions [..., S] (broadcastable)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_lookup(tokens, table, compute_dtype=DEFAULT_DTYPE):
    return table[tokens].to(compute_dtype)

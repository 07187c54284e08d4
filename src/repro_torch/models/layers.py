"""Base layers: Linear (bf16 + W8A8 integer path), norms, RoPE, embeddings.

Port of ``repro.models.layers``.  ``Linear`` and ``Norm`` are the modules
that hold the weights: a float ``Linear`` keeps its weight in the
reference's [in, out] layout; after PTQ it holds an int8 ``w_q`` [in, out]
and a per-output-channel f32 ``scale`` [out] as buffers.  The functions
mirror the reference one for one.  Where the reference divides by a
Python-float constant under ``jax.jit`` (``/ 127.0``), the port multiplies
by the f32 reciprocal, as XLA does (``kernels/common.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..kernels import ops
from ..kernels.common import f32, rcp32
from ..kernels.int_gelu import gelu_out_scale, int_gelu_ref

DEFAULT_DTYPE = torch.bfloat16
F32 = torch.float32

# canonical static activation scale for the integer GELU path (the
# pre-activation clip range [-8, 8] mapped onto int8)
GELU_INT_SCALE = 8.0 / 127.0
_RCP127 = rcp32(127.0)

# ---------------------------------------------------------------------------
# initializers (an explicit torch.Generator; numbers differ from jax.random)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               device) -> torch.Tensor:
    std = 1.0 / math.sqrt(in_dim)
    return torch.randn((in_dim, out_dim), generator=gen, device=device,
                       dtype=F32) * std


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               device) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, device=device,
                       dtype=F32) * 0.02


# ---------------------------------------------------------------------------
# modules holding the weights
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """One GEMM weight: float ``weight`` [in, out], or after PTQ int8
    ``w_q`` [in, out] + f32 ``scale`` [out] (buffers)."""

    def __init__(self, weight: torch.Tensor | None = None, *,
                 w_q: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None):
        super().__init__()
        if (weight is None) == (w_q is None):
            raise ValueError("Linear takes a float weight or an int8 w_q")
        self.weight = (None if weight is None
                       else nn.Parameter(weight, requires_grad=False))
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)

    @property
    def quantized(self) -> bool:
        return self.w_q is not None

    def quantize_(self, w_q: torch.Tensor, scale: torch.Tensor) -> None:
        """Replace the float weight by its int8 payload (in place)."""
        self.weight = None
        self.w_q, self.scale = w_q, scale


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

def linear(x, w, bias=None, compute_dtype=DEFAULT_DTYPE):
    """Matmul in the compute dtype (f32 accumulation inside)."""
    out = x.to(compute_dtype) @ w.to(compute_dtype)
    if bias is not None:
        out = out + bias.to(compute_dtype)
    return out


def linear_w8a8(x, w_q, w_scale, bias=None, compute_dtype=DEFAULT_DTYPE,
                residual=None):
    """W8A8: dynamic per-row activation quant -> int8 GEMM with the dequant
    (and optional residual add) fused into the epilogue."""
    x_q, x_scale = ops.quant_rows(x.float())
    return ops.gemm_w8a8(x_q, x_scale, w_q, w_scale, bias=bias,
                         residual=residual, out_dtype=compute_dtype)


def linear_gelu_w8a8(x, w_q, w_scale, compute_dtype=DEFAULT_DTYPE):
    """Fused W8A8 up-projection + integer GELU (MLP hot path), bit-identical
    to ``linear_w8a8`` followed by ``activation(..., "gelu")``."""
    x_q, x_scale = ops.quant_rows(x.float())
    out_q = ops.gemm_w8a8(x_q, x_scale, w_q, w_scale,
                          gelu_scale=GELU_INT_SCALE, out_dtype=compute_dtype)
    return (out_q.float() * f32(gelu_out_scale(GELU_INT_SCALE), x.device)
            ).to(compute_dtype)


def quantize_weight(w: torch.Tensor) -> dict:
    """PTQ a float [in, out] weight: per-output-channel symmetric int8
    (eager in the reference: a true division by 127)."""
    wf = w.float()
    amax = torch.clamp(wf.abs().amax(0), min=1e-8)
    scale = amax / 127.0
    w_q = torch.clamp(torch.round(wf / scale), -128, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale.float()}


@dataclasses.dataclass(frozen=True)
class ExecMode:
    """Execution-mode switch threaded through the model."""

    precision: str = "bf16"        # bf16 | w8a8
    compute_dtype: object = DEFAULT_DTYPE

    @property
    def integer(self) -> bool:
        return self.precision in ("w8a8", "w4a8")


def apply_linear(x, p: Linear, mode: ExecMode, bias=None, residual=None):
    """Dispatch on the weight the module holds: int8 ``w_q`` (W8A8 GEMM,
    residual add in the epilogue) or a float weight (plain matmul, then the
    residual add)."""
    if p.quantized:
        return linear_w8a8(x, p.w_q, p.scale, bias, mode.compute_dtype,
                           residual=residual)
    out = linear(x, p.weight.to(mode.compute_dtype), bias, mode.compute_dtype)
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
    """Integer norm of x with prequantized gamma/beta payloads."""
    x_q, _ = ops.quant_rows(x.float())
    out = ops.layernorm_i8(x_q.to(torch.int32), g_q, b_q, rms_only=rms_only)
    return (out.float() * (gb_s * f32(1.0 / 128.0, x.device))).to(x.dtype)


def norm_int(x, gamma, beta, rms_only: bool):
    """Integer-only norm (paper's ``norm`` kernel) for the w8a8 path:
    quantize the residual stream to int8, integer layernorm, dequantize."""
    g_q, b_q, gb_s = quantize_norm(gamma, beta)
    return norm_int_q(x, g_q, b_q, gb_s, rms_only)


def apply_norm(x, p: Norm, cfg, mode: ExecMode):
    if mode.integer:
        return norm_int_q(x, *p.int_consts(),
                          rms_only=cfg.norm_type == "rmsnorm")
    if cfg.norm_type == "layernorm":
        return layernorm(x, p.scale, p.bias, cfg.norm_eps)
    return rmsnorm(x, p.scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation(x, kind: str, mode: ExecMode):
    if mode.integer and kind == "gelu":
        if x.is_cuda:
            raise NotImplementedError(
                "the stand-alone integer GELU kernel (int_gelu) is not ported "
                "to CUDA yet (ROADMAP.md §B); w8a8 MLPs take the fused GEMM "
                "epilogue instead")
        s = GELU_INT_SCALE
        q = torch.clamp(torch.round(x.float() * f32(rcp32(s), x.device)),
                        -128, 127).to(torch.int32)
        out = int_gelu_ref(q, s)
        return (out.float() * f32(gelu_out_scale(s), x.device)).to(x.dtype)
    if mode.integer and kind == "silu":
        raise NotImplementedError("integer SiLU (int_silu) is slice 2 "
                                  "(ROADMAP.md §B)")
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

"""Integer-only transformer numerics on int32 tensors.

The subset of ``repro.core.inumerics`` that the ported kernels and the
gradient compression rest on: symmetric quantization and its absmax scale,
the shift / 16-bit-multiply / shift requantization, the I-BERT integer exp,
softmax, sigmoid, SiLU and GELU, the Newton integer square root and the integer
LayerNorm / RMSNorm.  Every
function is bit-exact against its JAX counterpart (``tests/test_torch_
inumerics.py``); the formulas are the same, written with torch int32 ops:

* ``>>`` on int32 tensors is an arithmetic shift, as in JAX;
* ``//`` on integer tensors is floor division, as in JAX (C++ ``/``
  truncates — the CUDA kernels write the floor division out);
* a left shift of a possibly negative value is written as a multiply.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

I32 = torch.int32


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric quantization: q = clip(round(x / scale)), int32 payload
    (round half to even, as ``jnp.round``)."""
    qmax = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(I32)


def absmax_scale(x: torch.Tensor, bits: int = 8, dim=None) -> torch.Tensor:
    """Calibration: scale = absmax / qmax (per-tensor, or per ``dim`` kept)
    — the constant divisor as its f32 reciprocal product, as jitted."""
    qmax = 2 ** (bits - 1) - 1
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    return torch.clamp(amax, min=1e-8) * float(np.float32(1) / np.float32(qmax))


# ---------------------------------------------------------------------------
# Requantization: int32 accumulator -> int8 via shift + 16-bit multiply
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RequantParams:
    """out = clip( ((acc >>r s1) * mult) >>r s2 ), >>r = round-half-up shift."""

    s1: int
    mult: int
    s2: int

    @property
    def effective_scale(self) -> float:
        return self.mult / (1 << (self.s1 + self.s2))


def compute_requant_params(multiplier: float, acc_bound: int) -> RequantParams:
    """Derive (s1, mult, s2) such that mult/2^(s1+s2) ~= multiplier; s1 keeps
    the shifted accumulator (|acc| <= ``acc_bound``) inside int16."""
    if multiplier <= 0:
        raise ValueError("requant multiplier must be positive")
    st = 13 - math.floor(math.log2(multiplier))
    mult = int(round(multiplier * (1 << st)))
    if mult >= 1 << 14:
        mult >>= 1
        st -= 1
    need = max(0, math.ceil(math.log2(max(acc_bound, 1))) - 15)
    s1 = min(max(0, st), need) if need > 0 else 0
    s1 = max(s1, need)
    if s1 > st:
        mult = min(mult << (s1 - st), (1 << 15) - 1)
        st = s1
    s2 = st - s1
    return RequantParams(s1=s1, mult=mult, s2=s2)


def rshift_round(x: torch.Tensor, s: int) -> torch.Tensor:
    """Arithmetic right shift by a static ``s`` with round-half-up; s == 0
    is the identity."""
    x = x.to(I32)
    if s <= 0:
        return x
    return (x + (1 << (s - 1))) >> s


def requantize(acc: torch.Tensor, p: RequantParams, bits: int = 8) -> torch.Tensor:
    """int32 accumulator -> int``bits`` value (returned as int32 payload)."""
    qmax = 2 ** (bits - 1) - 1
    t = rshift_round(acc.to(I32), p.s1)
    t = torch.clamp(t, -(1 << 15), (1 << 15) - 1)
    t = t * p.mult
    t = rshift_round(t, p.s2)
    return torch.clamp(t, -qmax - 1, qmax)


# ---------------------------------------------------------------------------
# Integer exp (I-BERT):  exp(x) = 2^(-z) * poly(r),  x = r - z*ln2, r in (-ln2,0]
# ---------------------------------------------------------------------------

_EXP_A, _EXP_B, _EXP_C = 0.35815147, 1.353, 0.344


def exp_consts(scale: float) -> tuple[int, int, int, float]:
    """(q_ln2, q_b, q_c, s_poly) of ``i_exp`` at input scale ``scale``,
    in Python float64 as the reference computes them."""
    q_ln2 = max(int(math.floor(math.log(2.0) / scale)), 1)
    q_b = int(math.floor(_EXP_B / scale))
    q_c = int(math.floor(_EXP_C / (_EXP_A * scale * scale)))
    return q_ln2, q_b, q_c, _EXP_A * scale * scale


def i_exp(q: torch.Tensor, scale: float) -> tuple[torch.Tensor, float]:
    """Integer exp of non-positive fixed-point inputs: exp(q*scale) ~=
    q_out * scale_out.  ``-q`` is non-negative, so ``//`` is the floor
    division of the reference on either side."""
    q = q.to(I32)
    q_ln2, q_b, q_c, s_poly = exp_consts(scale)
    z = (-q) // q_ln2                      # number of halvings
    q_p = q + z * q_ln2                    # remainder in (-q_ln2, 0]
    q_poly = (q_p + q_b) * (q_p + q_b) + q_c
    z = torch.clamp(z, max=30)
    return (q_poly >> z).to(I32), s_poly


# ---------------------------------------------------------------------------
# Integer softmax (ITA-style int8 output, scale 1/127)
# ---------------------------------------------------------------------------

SOFTMAX_OUT_SCALE = 1.0 / 127.0
SOFTMAX_NEG_INF = -(2 ** 24)   # large negative, shift-safe


def exp_rescale_shift(scale: float) -> int:
    """Static right shift bounding ``i_exp`` outputs to 14 bits (softmax
    only needs ratios; without it e*127 overflows int32 at fine scales)."""
    _, q_b, q_c, _ = exp_consts(scale)
    return max(0, int(q_b * q_b + q_c).bit_length() - 14)


def i_softmax(q: torch.Tensor, scale: float, dim: int = -1,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Integer-only softmax.  q: int32 logits with real value q*scale.

    Returns int32 payload in [0, 127]; dequantize with SOFTMAX_OUT_SCALE.
    With ``mask`` (bool, True = keep), masked positions get probability 0.
    The row sum of 14-bit exps and ``e*127`` stay in int32 for rows of up
    to 2^17 entries; ``//`` has non-negative operands throughout."""
    q = q.to(I32)
    if mask is not None:
        q = torch.where(mask, q, SOFTMAX_NEG_INF)
    q_max = q.amax(dim, keepdim=True)
    q_shift = torch.clamp(q - q_max, min=SOFTMAX_NEG_INF)       # <= 0
    q_exp, _ = i_exp(q_shift, scale)
    q_exp = q_exp >> exp_rescale_shift(scale)
    if mask is not None:
        q_exp = torch.where(mask, q_exp, 0)
    q_sum = torch.clamp(q_exp.sum(dim, keepdim=True, dtype=I32), min=1)
    out = (q_exp * 127 + (q_sum >> 1)) // q_sum
    return torch.clamp(out, 0, 127).to(I32)


# ---------------------------------------------------------------------------
# Integer sigmoid / SiLU (for SwiGLU archs)
# ---------------------------------------------------------------------------


def sigmoid_one(scale: float) -> int:
    """1.0 in the exp scale of ``i_sigmoid`` (Python ``round``, as the
    reference)."""
    return max(int(round(1.0 / exp_consts(scale)[3])), 1)


def i_sigmoid(q: torch.Tensor, scale: float) -> torch.Tensor:
    """sigmoid(q*scale) -> int32 payload in [0, 127], scale 1/127."""
    q = q.to(I32)
    q_exp, _ = i_exp(-torch.abs(q), scale)     # exp(-|x|), in (0, 1]
    q_one = sigmoid_one(scale)
    denom = torch.clamp(q_one + q_exp, min=1)
    # sig(-|x|) = e / (1 + e); sig(|x|) = 1 / (1 + e)
    pos = ((q_one * 127) + (denom >> 1)) // denom
    neg = ((q_exp * 127) + (denom >> 1)) // denom
    return torch.clamp(torch.where(q >= 0, pos, neg), 0, 127).to(I32)


def i_silu(q: torch.Tensor, scale: float) -> tuple[torch.Tensor, float]:
    """SiLU(x) = x * sigmoid(x); returns (int32 payload, scale_out).
    |q| <= 2^15 (int8/int16 inputs) keeps the product exact."""
    q = q.to(I32)
    return q * i_sigmoid(q, scale), scale / 127.0


# ---------------------------------------------------------------------------
# Integer erf / GELU (I-BERT polynomial)
# ---------------------------------------------------------------------------

_ERF_A, _ERF_B, _ERF_C = -0.2888, -1.769, 1.0


def i_erf(q: torch.Tensor, scale: float) -> tuple[torch.Tensor, float]:
    """erf(q*scale) ~= q_out * s_out (sign-symmetric clipped polynomial)."""
    q = q.to(I32)
    q_b = int(math.floor(_ERF_B / scale))
    q_c = int(math.floor(_ERF_C / (_ERF_A * scale * scale)))
    sgn = torch.sign(q).to(I32)
    q_abs = torch.clamp(torch.abs(q), max=-q_b)
    q_poly = (q_abs + q_b) * (q_abs + q_b) + q_c
    return sgn * q_poly, _ERF_A * scale * scale


def i_gelu(q: torch.Tensor, scale: float) -> tuple[torch.Tensor, float]:
    """GELU(x) = x * 0.5 * (1 + erf(x / sqrt(2))) in integer arithmetic."""
    q = q.to(I32)
    q_erf, s_erf = i_erf(q, scale / math.sqrt(2.0))
    q_one = int(math.floor(1.0 / s_erf))
    return q * (q_erf + q_one), scale * s_erf / 2.0


def i_gelu_int8(q: torch.Tensor, scale: float) -> tuple[torch.Tensor, float]:
    """GELU with int8 (payload int32) output and positive scale."""
    q_out, s_out = i_gelu(q, scale)
    if s_out < 0:
        q_out, s_out = -q_out, -s_out
    out_scale = max(127.0 * scale, 1e-8) / 127.0
    acc_bound = int(127 * 2 / abs(s_out / scale * 2.0)) + 127
    p = compute_requant_params(s_out / out_scale, acc_bound=acc_bound)
    return requantize(q_out, p), out_scale


# ---------------------------------------------------------------------------
# Integer sqrt (Newton) + LayerNorm / RMSNorm
# ---------------------------------------------------------------------------

_POW2 = [1 << k for k in range(31)]


def _bit_length(n: torch.Tensor) -> torch.Tensor:
    """32 - clz(n) for int32 n >= 1, exactly (no float log2)."""
    pow2 = torch.tensor(_POW2, dtype=I32, device=n.device)
    return (n.unsqueeze(-1) >= pow2).sum(-1).to(I32)


def i_sqrt(n: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """floor(sqrt(n)) for non-negative int32 n, Newton iteration."""
    n = torch.clamp(n.to(I32), min=0)
    bl = _bit_length(torch.clamp(n, min=1))
    x = torch.ones_like(n) << ((bl + 1) // 2)
    for _ in range(iters):
        x = torch.clamp(x, min=1)
        x = torch.minimum(x, (x + n // x) >> 1)
    return torch.where(n == 0, torch.zeros_like(x), x)


_NORM_FRAC_BITS = 7  # fractional bits of the normalized value


def i_layernorm(q: torch.Tensor, scale: float, gamma_q: torch.Tensor,
                beta_q: torch.Tensor, gb_scale: float, rms_only: bool = False
                ) -> tuple[torch.Tensor, float]:
    """Integer-only LayerNorm / RMSNorm over the last axis.

    q: int32 payload (int8-range values).  gamma_q/beta_q: int8-range
    payloads.  Returns (int32 payload, gb_scale / 2^7).
    """
    q = q.to(I32)
    d = q.shape[-1]
    if not rms_only:
        s = q.sum(-1, keepdim=True, dtype=torch.int64).to(I32)
        mean = torch.where(s >= 0, (s + d // 2) // d, -((-s + d // 2) // d))
        c = q - mean
    else:
        c = q
    c = torch.clamp(c, -255, 255)
    vshift = max(0, (d - 1).bit_length() - 15)
    c2 = (c * c) >> vshift
    var_sum = c2.sum(-1, keepdim=True, dtype=torch.int64).to(I32)
    var = (var_sum // d) << vshift
    std16 = torch.clamp(i_sqrt(var << 8), min=1)
    n = (c * (1 << (_NORM_FRAC_BITS + 4))) // std16
    out = n * gamma_q.to(I32)
    if not rms_only:
        out = out + beta_q.to(I32) * (1 << _NORM_FRAC_BITS)
    return out, gb_scale / float(1 << _NORM_FRAC_BITS)

"""Integer GELU (the paper's ``gelu``): the I-BERT erf polynomial on an int32
block, requantized to int8 at a static output scale.

``gelu_block`` is the in-register core the fused GEMM epilogues run
(``int8_gemm`` ``scaled_gelu`` and ``requant_gelu``); its CUDA twin is
``gelu_block`` in ``csrc/int_epilogue.cuh``, fed the constants
``gelu_consts`` derives.  ``int_gelu`` ports the stand-alone Pallas kernel
(``repro/kernels/int_gelu.py:61``) to ``csrc/int_gelu.cu`` (the same block
over a flat payload, bound by bytes); ``int_gelu_ref`` is its plain version.
Bit-exact for any int32 input (where ``q * (q_erf + q_one)`` leaves int32,
both wrap as the reference does).
"""
from __future__ import annotations

import math

import torch

from ..core import inumerics as inum
from .common import launch_elementwise, on_cuda, requant_block

I32 = torch.int32
_ERF_A, _ERF_B, _ERF_C = -0.2888, -1.769, 1.0


def gelu_out_scale(scale: float) -> float:
    return max(127.0 * scale, 1e-8) / 127.0


def gelu_requant_params(scale: float) -> inum.RequantParams:
    """The same tight-bound requant params inumerics.i_gelu_int8 derives."""
    s_in = scale / math.sqrt(2.0)
    s_erf = abs(_ERF_A * s_in * s_in)
    s_out_raw = s_erf * scale / 2.0
    acc_bound = int(127 * 2 / s_erf) + 127
    return inum.compute_requant_params(s_out_raw / gelu_out_scale(scale),
                                       acc_bound=acc_bound)


def _poly_consts(scale: float) -> tuple[int, int, int]:
    s_in = scale / math.sqrt(2.0)
    q_b = int(math.floor(_ERF_B / s_in))
    q_c = int(math.floor(_ERF_C / (_ERF_A * s_in * s_in)))
    q_one = int(math.floor(1.0 / (_ERF_A * s_in * s_in)))
    return q_b, q_c, q_one


def gelu_consts(scale: float) -> tuple[int, int, int, int, int, int]:
    """(q_b, q_c, q_one, s1, mult, s2): the static integers the CUDA
    ``gelu_block`` takes for activation scale ``scale``."""
    p = gelu_requant_params(scale)
    return (*_poly_consts(scale), p.s1, p.mult, p.s2)


def gelu_block(q: torch.Tensor, *, scale: float, s1: int, mult: int,
               s2: int) -> torch.Tensor:
    """Integer GELU of one int32 block -> int8-range int32 values."""
    q_b, q_c, q_one = _poly_consts(scale)
    q = q.to(I32)
    sgn = torch.sign(q).to(I32)
    q_abs = torch.clamp(torch.abs(q), max=-q_b)
    q_erf = sgn * ((q_abs + q_b) * (q_abs + q_b) + q_c)
    acc = -(q * (q_erf + q_one))  # negate: s_out < 0 in the raw formula
    return requant_block(acc, s1, mult, s2)


def int_gelu_ref(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain integer GELU (``ref.int_gelu_ref``): int payload -> int8."""
    q, _ = inum.i_gelu_int8(x.to(I32), scale)
    return q.to(torch.int8)


def int_gelu(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Integer GELU of an int payload of any shape (real value x * scale)
    -> int8 at ``gelu_out_scale(scale)``: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if on_cuda(x):
        return launch_elementwise("int_gelu", "int_gelu", x, torch.int8,
                                  gelu_consts(scale))
    return int_gelu_ref(x, scale)

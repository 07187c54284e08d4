"""Activation quantization (the paper's ``quant``): per-row f32 [M, D] ->
int8 [M, D] + f32 row scale [M, 1] (``quantize_rows``), and the integer
requantization of an int32 payload to int8 (``requantize_i32``).

Port of the Pallas kernel ``repro/kernels/quantize.py:41`` ``quantize_rows``
to the CUDA kernel ``csrc/quantize.cu`` (source note there: bound by bytes
and a launch's fixed time; bf16 or f32 rows read once into registers, a
warp per row up to 1024 values, a block per row past that; the arithmetic
in ``csrc/quant_row.cuh``, which the fused norm form of
``int_layernorm.cu`` shares).  ``quantize_rows_ref`` is its plain version,
the jitted ``repro.kernels.ref.quantize_rows_ref``: the scale is ``amax *
f32(1/127)`` (XLA's form of ``amax / 127.0`` under jit), the division by it
is a true division.  Bit-exact against the kernel, on bf16 rows too (a bf16
value widens to f32 exactly).  The KV cache's per-(token, head)
quantization (``attention._quant_kv``, the reference's ``_quant_kv``) is
the same function over rows of the head dim.

``requantize_i32`` ports ``repro/kernels/quantize.py:111`` to
``csrc/requantize.cu`` (``requant_block``, shift/mul16/shift, bound by
bytes); ``requantize_i32_ref`` is its plain version,
``core.inumerics.requantize``.  Bit-exact, wrapping where the reference's
int32 wraps.

``pack_int4`` builds the W4A8 weight container in plain PyTorch (no kernel:
PTQ packs once; the int4 GEMMs unpack in registers, and
``int8_gemm.unpack_int4_ref`` is the plain unpacker).
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from . import build
from .common import (LAUNCHES, check, check_requant, f32,
                     launch_elementwise, on_cuda, rcp32)

_RCP127 = rcp32(127.0)


def quantize_rows_ref(x: torch.Tensor):
    """Plain version: float [..., D] -> (int8 [..., D], f32 [..., 1])."""
    x = x.float()
    amax = torch.maximum(x.abs().amax(-1, keepdim=True),
                         f32(1e-8, x.device))
    scale = amax * f32(_RCP127, x.device)
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale


def _launch(x: torch.Tensor):
    check(x.dtype in (torch.float32, torch.bfloat16) and x.dim() == 2
          and x.is_contiguous(), f"quantize_rows takes a contiguous f32 or "
          f"bf16 [M, D] tensor, got {x.dtype} {tuple(x.shape)}")
    m, d = x.shape
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = build.entry("quantize", "repro_quantize_rows",
                     [build.VP] * 3 + [build.I] * 3 + [build.VP])
    rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, d,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "quantize_rows")
    LAUNCHES["quantize_rows"] += 1
    return q, s


def quantize_rows(x: torch.Tensor):
    """f32 or bf16 [M, D] -> (int8 [M, D], f32 [M, 1]): the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if on_cuda(x):
        return _launch(x)
    return quantize_rows_ref(x)


def requantize_i32_ref(x: torch.Tensor, params: inum.RequantParams):
    """Plain version (``ref.requantize_i32_ref``): int payload -> int8."""
    return inum.requantize(x.to(torch.int32), params).to(torch.int8)


def requantize_i32(x: torch.Tensor, params: inum.RequantParams):
    """int32 (or int8/int16) payload of any shape -> int8 through
    shift/mul16/shift: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if on_cuda(x):
        check_requant(params)
        return launch_elementwise("requantize", "requantize_i32", x,
                                  torch.int8,
                                  (params.s1, params.mult, params.s2))
    return requantize_i32_ref(x, params)


def pack_int4(w4: torch.Tensor) -> torch.Tensor:
    """int8 [..., K, N] with values in [-8, 7] -> packed int8
    [..., ceil(K/2), N] (``repro.kernels.quantize.pack_int4``'s layout).

    Byte i holds contraction rows 2i (low nibble) and 2i+1 (high nibble);
    an odd K is padded with a zero nibble."""
    check(w4.dtype == torch.int8, f"pack_int4 takes int8, got {w4.dtype}")
    if w4.shape[-2] % 2:
        w4 = torch.cat([w4, torch.zeros_like(w4[..., :1, :])], dim=-2)
    lo = w4[..., 0::2, :].to(torch.int32) & 0xF
    hi = w4[..., 1::2, :].to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8)

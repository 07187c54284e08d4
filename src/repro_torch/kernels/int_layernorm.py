"""Integer LayerNorm / RMSNorm (the paper's ``norm``), in two forms.

``int_layernorm``: int32 [M, D] with int32 gamma/beta payloads [D] -> int32
[M, D] (7 fractional bits), the integer library's ``ops.layernorm_i8``.

``int_layernorm_rows``: the models' norm (``layers.norm_int``) with the
quantization of its output for the next integer GEMM, float rows [M, D] ->
(the normed rows in x's dtype, their int8 payload, f32 row scales): B1 on
x, this norm on the payload, the dequant by ``gb_s / 128`` rounded to x's
dtype, then B1 again on the rounded rows — one launch where the chain of
standalone kernels took two launches, six PyTorch kernels and a host
synchronization.

Port of the Pallas kernel ``repro/kernels/int_layernorm.py:56``
``int_layernorm`` to the CUDA kernels of ``csrc/int_layernorm.cu`` (source
note there: bound by bytes and a launch's fixed time; the fused form holds
its row in registers after one read; both forms share
``csrc/int_norm_row.cuh``, the fused one also ``csrc/quant_row.cuh`` with
``quantize_rows``).  ``int_layernorm_ref`` is the first's plain version,
``core.inumerics.i_layernorm`` as ``repro.kernels.ref.int_layernorm_ref``
calls it; ``int_layernorm_rows_ref`` the second's, the composition of the
plain versions.  Both bit-exact.  The fused form's launches count under
``int_layernorm``: it is B9's form on the main path.
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from . import build
from .common import LAUNCHES, check, f32, on_cuda
from .quantize import quantize_rows_ref

I32 = torch.int32
# what the fused form's C entry returns for rows it cannot hold
_REFUSED = 1  # cudaErrorInvalidValue


def vshift_of(d: int) -> int:
    """The pre-shift that keeps the row's sum of squares in int32."""
    return max(0, (d - 1).bit_length() - 15)


def int_layernorm_ref(x, gamma_q, beta_q, rms_only: bool = False):
    out, _ = inum.i_layernorm(x.to(I32), 1.0, gamma_q.to(I32), beta_q.to(I32),
                              1.0, rms_only=rms_only)
    return out


def _launch(x, gamma_q, beta_q, rms_only: bool):
    check(x.dim() == 2, f"int_layernorm takes [M, D], got {tuple(x.shape)}")
    m, d = x.shape
    x = x.to(I32).contiguous()
    g = gamma_q.to(I32).contiguous()
    b = beta_q.to(I32).contiguous()
    check(g.shape == (d,) and b.shape == (d,),
          f"gamma/beta must be [{d}], got {tuple(g.shape)} {tuple(b.shape)}")
    out = torch.empty((m, d), dtype=I32, device=x.device)
    fn = build.entry("int_layernorm", "repro_int_layernorm",
                     [build.VP] * 4 + [build.I] * 4 + [build.VP])
    rc = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), m, d,
            int(rms_only), vshift_of(d),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "int_layernorm")
    LAUNCHES["int_layernorm"] += 1
    return out


def int_layernorm(x, gamma_q, beta_q, rms_only: bool = False):
    """Integer norm over the last axis of int32 [M, D]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if on_cuda(x, gamma_q, beta_q):
        return _launch(x, gamma_q, beta_q, rms_only)
    return int_layernorm_ref(x, gamma_q, beta_q, rms_only)


def int_layernorm_rows_ref(x, gamma_q, beta_q, gb_s, rms_only: bool = False):
    """Plain version of the fused form: ``quantize_rows_ref`` ->
    ``int_layernorm_ref`` -> ``* (gb_s / 128)`` -> x's dtype ->
    ``quantize_rows_ref``.  Returns (h, h_q, h_scale)."""
    x_q, _ = quantize_rows_ref(x)
    out = int_layernorm_ref(x_q, gamma_q, beta_q, rms_only)
    h = (out.float() * (gb_s * f32(1.0 / 128.0, x.device))).to(x.dtype)
    h_q, h_s = quantize_rows_ref(h)
    return h, h_q, h_s


def _launch_rows(x, gamma_q, beta_q, gb_s, rms_only: bool):
    check(x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16),
          f"int_layernorm_rows takes f32 or bf16 [M, D], got {x.dtype} "
          f"{tuple(x.shape)}")
    check(x.is_contiguous(), "int_layernorm_rows: x must be contiguous")
    m, d = x.shape
    g = gamma_q.to(I32).contiguous()
    b = beta_q.to(I32).contiguous()
    check(g.shape == (d,) and b.shape == (d,),
          f"gamma/beta must be [{d}], got {tuple(g.shape)} {tuple(b.shape)}")
    check(gb_s.dtype == torch.float32 and gb_s.numel() == 1,
          f"gb_s must be one f32 value, got {gb_s.dtype} {tuple(gb_s.shape)}")
    h = torch.empty_like(x)
    h_q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    h_s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = build.entry("int_layernorm", "repro_int_layernorm_rows",
                     [build.VP] * 7 + [build.I] * 5 + [build.VP])
    rc = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), gb_s.data_ptr(),
            h.data_ptr(), h_q.data_ptr(), h_s.data_ptr(), m, d,
            int(x.dtype == torch.bfloat16), int(rms_only), vshift_of(d),
            torch.cuda.current_stream(x.device).cuda_stream)
    # the C entry decides which rows its registers hold (see launch_rows)
    check(rc != _REFUSED,
          f"int_layernorm_rows: the kernel refused {x.dtype} rows of D = {d}: "
          f"it holds rows of 16-byte chunks at 16-byte addresses up to its "
          f"register limit (csrc/int_layernorm.cu, launch_rows)")
    build.check_rc(rc, "int_layernorm_rows")
    LAUNCHES["int_layernorm"] += 1
    return h, h_q, h_s


def int_layernorm_rows(x, gamma_q, beta_q, gb_s, rms_only: bool = False):
    """Fused integer norm and quantization of float rows [M, D] with the
    norm's int32 payloads gamma_q/beta_q [D] and their f32 scale gb_s (a
    0-dim tensor): (h [M, D] in x's dtype, h_q int8 [M, D], h_scale f32
    [M, 1]).  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if on_cuda(x, gamma_q, beta_q, gb_s):
        return _launch_rows(x, gamma_q, beta_q, gb_s, rms_only)
    return int_layernorm_rows_ref(x, gamma_q, beta_q, gb_s, rms_only)

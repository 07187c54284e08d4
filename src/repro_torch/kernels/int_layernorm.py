"""Integer LayerNorm / RMSNorm (the paper's ``norm``): int32 [M, D] with int32
gamma/beta payloads [D] -> int32 [M, D] (7 fractional bits).

Port of the Pallas kernel ``repro/kernels/int_layernorm.py:56``
``int_layernorm`` to the CUDA kernel ``csrc/int_layernorm.cu`` (source note
there: bound by bytes, one block per row, explicit floor division).
``int_layernorm_ref`` is its plain version, ``core.inumerics.i_layernorm``
as ``repro.kernels.ref.int_layernorm_ref`` calls it.  Bit-exact.
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from . import build
from .common import LAUNCHES, check, on_cuda

I32 = torch.int32


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
    vshift = max(0, (d - 1).bit_length() - 15)
    fn = build.entry("int_layernorm", "repro_int_layernorm",
                     [build.VP] * 4 + [build.I] * 4 + [build.VP])
    rc = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), m, d,
            int(rms_only), vshift, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "int_layernorm")
    LAUNCHES["int_layernorm"] += 1
    return out


def int_layernorm(x, gamma_q, beta_q, rms_only: bool = False):
    """Integer norm over the last axis of int32 [M, D]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if on_cuda(x, gamma_q, beta_q):
        return _launch(x, gamma_q, beta_q, rms_only)
    return int_layernorm_ref(x, gamma_q, beta_q, rms_only)

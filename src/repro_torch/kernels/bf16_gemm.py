"""The bf16 float linear, ``bf16_gemm``: x [M, K] @ w [K, N] (+ bias [N])
in bf16 with f32 sums, a kernel the port adds beyond the TPU's.

The reference computes its float linears outside Pallas (XLA's dot in
``repro/models/layers.py`` ``linear``); the port ran them as
``torch.matmul``, whose cuBLAS algorithm, picked by shape, sums K in an
order that changes with M and N.  Tensor-parallel serving shards those
linears by columns (q/k/v) and by rows (the overlap form's ``wo`` and
``w_out`` at M / tp rows), so bf16 TP was not bit-identical to tp 1
(ROADMAP C20).  ``csrc/bf16_gemm.cu`` (source note there) runs
``gemm_mma.cuh``'s BF16 main loop with one weight stream and never splits
K: each output's sum has one order whatever M, N or the tile
(``int8_gemm.bf16_tiling``), so a shard's launch equals its slice of the
unsharded launch bit for bit.  tp 1 runs the same kernel.

``bf16_gemm_ref`` is the plain version: ``layers.linear``'s arithmetic at
bf16 (the f32 sums rounded once to bf16, then the bias added in bf16).  The
kernel sums in another order than the CPU's matmul, so the two agree within
``int8_gemm.DUAL_BF16_RTOL``/``ATOL``, not bit for bit.

Under autograd the launch runs inside ``_Bf16Gemm``, whose backward is
autograd of the plain version recomputed from the saved inputs
(``common.plain_grads``), as the reference differentiates its float linear
with XLA's autodiff (no backward kernel).
"""
from __future__ import annotations

import torch

from . import build
from .common import LAUNCHES, check, on_cuda, plain_grads
from .int8_gemm import _aligned, _stream, bf16_tiling

BF16 = torch.bfloat16


def bf16_gemm_ref(x, w, bias=None):
    """``layers.linear(x, w, bias, bf16)``: the bf16 product (f32 sums,
    one rounding), then + bias in bf16."""
    out = x.to(BF16) @ w.to(BF16)
    if bias is not None:
        out = out + bias.to(BF16)
    return out


def _launch(x, w, bias):
    """One launch over x [M, K] and w [K, N] (bias [N] or None), all bf16
    and contiguous on one card; returns bf16 [M, N]."""
    check(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
          f"bf16_gemm operands: x {tuple(x.shape)}, w {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    for t, what in ((x, "x"), (w, "w"), (bias, "bias")):
        if t is not None:
            check(t.dtype == BF16 and t.is_contiguous(),
                  f"bf16_gemm: {what} must be contiguous bf16, got {t.dtype}"
                  f"{'' if t.is_contiguous() else ' non-contiguous'}")
    if bias is not None:
        check(tuple(bias.shape) == (n,),
              f"bf16_gemm: bias must be [{n}], got {tuple(bias.shape)}")
    out = torch.empty((m, n), dtype=BF16, device=x.device)
    ptrs = (x, w) if bias is None else (x, w, bias)
    vec = int(k % 8 == 0 and n % 8 == 0 and _aligned(*ptrs, out))
    fn = build.entry("bf16_gemm", "repro_bf16_gemm",
                     [build.VP] * 3 + [build.I] * 5 + [build.VP] * 2)
    rc = fn(x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
            m, n, k, bf16_tiling(m, n, k).bm, vec, out.data_ptr(),
            _stream(x.device))
    build.check_rc(rc, "bf16_gemm")
    LAUNCHES["bf16_gemm"] += 1
    return out


class _Bf16Gemm(torch.autograd.Function):
    """x [M, K] @ w [K, N] (+ bias): forward one CUDA launch, backward
    autograd of ``bf16_gemm_ref`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _launch(x, w, bias)

    @staticmethod
    def backward(ctx, dout):
        x, w, bias = ctx.saved_tensors
        if bias is None:
            return plain_grads(bf16_gemm_ref, (x, w), ctx.needs_input_grad[:2],
                               dout) + (None,)
        return plain_grads(bf16_gemm_ref, (x, w, bias), ctx.needs_input_grad,
                           dout)


def bf16_gemm(x, w, bias=None):
    """x [M, K] @ w [K, N] (+ bias [N]) in bf16, f32 sums, bf16 [M, N] out:
    the CUDA kernel (inside ``_Bf16Gemm``) for CUDA tensors, the plain
    version for CPU tensors.  On the card every operand must be bf16, w and
    bias contiguous; x is made contiguous."""
    if on_cuda(x, w, bias):
        check(x.dim() == 2, f"bf16_gemm takes x [M, K], got {tuple(x.shape)}")
        return _Bf16Gemm.apply(x.contiguous(), w, bias)
    return bf16_gemm_ref(x, w, bias)

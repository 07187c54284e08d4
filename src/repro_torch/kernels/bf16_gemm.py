"""The bf16 float linear, ``bf16_gemm``: x [M, K] @ w [K, N] (+ bias [N])
in bf16 with f32 sums, a kernel the port adds beyond the TPU's.

The reference computes its float linears outside Pallas (XLA's dot in
``repro/models/layers.py`` ``linear``); the port ran them as
``torch.matmul``, whose cuBLAS algorithm, picked by shape, sums K in an
order that changes with M and N.  Tensor-parallel serving shards those
linears by columns (q/k/v) and by rows (the overlap form's ``wo`` and
``w_out`` at M / tp rows), so bf16 TP was not bit-identical to tp 1
(ROADMAP C20).  ``csrc/bf16_gemm.cu`` (source note there) is a Hopper
kernel: TMA loads into an ``mbarrier`` ring, ``wgmma`` on the tiles, every
output's f32 sum in one block's registers from k = 0 to K in k16 steps,
never split.  So each output has one sum order whatever M, N or the tiling,
and a shard's launch equals its slice of the unsharded launch bit for bit.
tp 1 runs the same kernel.

What bounds it: the weight bytes at decode rows (and there the chain of
K / 16 dependent ``wgmma`` steps that the one order allows), the bf16
tensor-core rate at scoring and training rows.  ``autotune.bf16_gemm_blocks``
picks the tile (its table: 64-row blocks at decode rows, narrow enough (32
or 64 columns) that the blocks cover the SMs with no split of K, two an
SM, each keeping at least ``BF16_INFLIGHT`` bytes of weight in flight (at
M <= 8 a stage holds 8 rows of x, so the ring is deeper); past 64 rows the
wide tile whose waves cost least).  TMA needs 16-byte row strides and operands:
``_pad`` zero-pads a K or N that is not a multiple of 8 (a zero product
adds nothing to an f32 sum, and the real values keep their k16 groups), an
unaligned operand is copied.

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
import torch.nn.functional as F

from . import autotune, build
from .autotune import Bf16Tiling
from .common import LAUNCHES, cdiv, check, on_cuda, plain_grads
from .int8_gemm import _aligned, _n_sm, _stream

BF16 = torch.bfloat16


def bf16_gemm_ref(x, w, bias=None):
    """``layers.linear(x, w, bias, bf16)``: the bf16 product (f32 sums,
    one rounding), then + bias in bf16."""
    out = x.to(BF16) @ w.to(BF16)
    if bias is not None:
        out = out + bias.to(BF16)
    return out


def _pad(x, w, bias):
    """x [M, K], w [K, N], bias [N] or None with K and N zero-padded to
    multiples of 8 (K to at least 8), as TMA's 16-byte row strides need;
    the padded product's first N columns are the product."""
    k, n = w.shape
    if k and k % 8 == 0 and n % 8 == 0:
        return x, w, bias
    kp, np_ = max(8, cdiv(k, 8) * 8), cdiv(n, 8) * 8
    return (F.pad(x, (0, kp - k)), F.pad(w, (0, np_ - n, 0, kp - k)),
            None if bias is None else F.pad(bias, (0, np_ - n)))


def _launch(x, w, bias, tiling: Bf16Tiling | None = None):
    """One launch over x [M, K] and w [K, N] (bias [N] or None), all bf16
    and contiguous on one card; returns bf16 [M, N].  ``tiling`` (one of
    ``autotune.bf16_gemm_candidates``) replaces the chooser's: chip_smoke's
    gate that every tiling gives the same bits."""
    check(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
          f"bf16_gemm operands: x {tuple(x.shape)}, w {tuple(w.shape)}")
    m = x.shape[0]
    n = w.shape[1]
    for t, what in ((x, "x"), (w, "w"), (bias, "bias")):
        if t is not None:
            check(t.dtype == BF16 and t.is_contiguous(),
                  f"bf16_gemm: {what} must be contiguous bf16, got {t.dtype}"
                  f"{'' if t.is_contiguous() else ' non-contiguous'}")
    if bias is not None:
        check(tuple(bias.shape) == (n,),
              f"bf16_gemm: bias must be [{n}], got {tuple(bias.shape)}")
    fn = build.entry("bf16_gemm", "repro_bf16_gemm",
                     [build.VP] * 3 + [build.I] * 6 + [build.VP] * 2)
    xp, wp, bp = _pad(x, w, bias)
    # an operand TMA cannot address from its own pointer is copied
    xp = xp if _aligned(xp) else xp.clone()
    wp = wp if _aligned(wp) else wp.clone()
    kp, np_ = wp.shape
    dev = x.device
    out = torch.empty((m, np_), dtype=BF16, device=dev)
    tl = tiling or autotune.bf16_gemm_blocks(m, kp, np_, _n_sm(dev))
    rc = fn(xp.data_ptr(), wp.data_ptr(), 0 if bp is None else bp.data_ptr(),
            m, np_, kp, tl.bm, tl.bn, tl.stages, out.data_ptr(),
            _stream(dev))
    build.check_rc(rc, "bf16_gemm")
    LAUNCHES["bf16_gemm"] += 1
    return out if np_ == n else out[:, :n].contiguous()


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

"""Integer 2-D convolution (the paper's ``conv``): int8 x [N, H, W, C]
(NHWC) * int8 w [KH, KW, C, O] (HWIO), stride 1, VALID, + int32 bias [O]
-> int32 [N, OH, OW, O], or int8 through an optional requant.

Port of the Pallas kernel ``repro/kernels/conv2d.py:51`` ``int8_conv2d`` to
the CUDA kernel ``csrc/int8_conv2d.cu`` (source note there: an implicit GEMM
on the integer GEMMs' tiles, C zero-padded to a multiple of 4 for
``__dp4a``).  ``int8_conv2d_ref`` is its plain version,
``repro.kernels.ref.int8_conv2d_ref``: an exact f64 sum over the KH x KW
taps (every partial sum is an integer below 2^53), the bias added in int32
with the reference's wrap-around, then ``core.inumerics.requantize`` (the
int16 clip before the multiply).  Bit-exact.
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from . import build
from .common import LAUNCHES, cdiv, check, check_requant, on_cuda

I32 = torch.int32
BM = 64               # output pixels per block of the CUDA kernel


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, as the reference's int32 add wraps."""
    return (((v + 2 ** 31) % 2 ** 32) - 2 ** 31).to(I32)


def int8_conv2d_ref(x, w, bias, requant_params=None):
    """Plain version: NHWC x HWIO, stride 1, VALID, + bias (int32), then
    ``requantize`` to int8 when ``requant_params`` is given."""
    kh, kw = w.shape[0], w.shape[1]
    oh, ow = x.shape[1] - kh + 1, x.shape[2] - kw + 1
    acc = torch.zeros((x.shape[0], oh, ow, w.shape[3]), dtype=torch.float64,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc += x[:, i:i + oh, j:j + ow, :].double() @ w[i, j].double()
    acc = _wrap32(acc.long() + bias.long())
    if requant_params is None:
        return acc
    return inum.requantize(acc, requant_params).to(torch.int8)


def _check_operands(x, w, bias) -> None:
    check(x.dim() == 4 and w.dim() == 4 and x.shape[3] == w.shape[2],
          f"int8_conv2d operands: x {tuple(x.shape)} (NHWC), w "
          f"{tuple(w.shape)} (HWIO)")
    check(x.dtype == torch.int8 and w.dtype == torch.int8,
          f"int8_conv2d: x and w must be int8, got {x.dtype}, {w.dtype}")
    check(bias.dtype == I32 and tuple(bias.shape) == (w.shape[3],),
          f"int8_conv2d: bias must be int32 [{w.shape[3]}], got {bias.dtype} "
          f"{tuple(bias.shape)}")
    check(1 <= w.shape[0] <= x.shape[1] and 1 <= w.shape[1] <= x.shape[2],
          f"int8_conv2d: a {w.shape[0]}x{w.shape[1]} window over "
          f"{x.shape[1]}x{x.shape[2]}")


def _launch(x, w, bias, requant_params):
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    check(kh * kw * c * 128 * 128 < 2 ** 31,
          f"a {kh}x{kw}x{c} window overflows the int32 sums")
    m = n * (h - kh + 1) * (wd - kw + 1)
    check(cdiv(m, BM) < 2 ** 16, f"{m} output pixels exceed the grid")
    if requant_params is not None:
        check_requant(requant_params)
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    out = torch.empty((n, h - kh + 1, wd - kw + 1, o), device=x.device,
                      dtype=I32 if requant_params is None else torch.int8)
    rq = (0, 0, 0) if requant_params is None else (
        requant_params.s1, requant_params.mult, requant_params.s2)
    vec_x = int(c % 4 == 0 and x.data_ptr() % 4 == 0)
    vec_w = int(o % 4 == 0 and w.data_ptr() % 4 == 0)
    fn = build.entry("int8_conv2d", "repro_int8_conv2d",
                     [build.VP] * 4 + [build.I] * 13 + [build.VP])
    rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h,
            wd, c, kh, kw, o, int(requant_params is not None), *rq, vec_x,
            vec_w, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "int8_conv2d")
    LAUNCHES["int8_conv2d"] += 1
    return out


def int8_conv2d(x, w, bias, requant_params=None):
    """int8 x [N,H,W,C] * w [KH,KW,C,O] + int32 bias [O] -> int32
    [N,OH,OW,O] (int8 with ``requant_params``): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_operands(x, w, bias)
    if on_cuda(x, w, bias):
        return _launch(x, w, bias, requant_params)
    return int8_conv2d_ref(x, w, bias, requant_params)

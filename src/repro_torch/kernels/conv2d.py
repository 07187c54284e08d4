"""Integer 2-D convolution (the paper's ``conv``): int8 x [N, H, W, C]
(NHWC) * int8 w [KH, KW, C, O] (HWIO), stride 1, VALID, + int32 bias [O]
-> int32 [N, OH, OW, O], or int8 through an optional requant.

Port of the Pallas kernel ``repro/kernels/conv2d.py:51`` ``int8_conv2d`` to
the CUDA kernel ``csrc/int8_conv2d.cu`` (source note there).  Bound on the
H100 by bytes at the shapes the port runs (the int32 output dominates).
The kernel is an implicit GEMM on the int8 tensor-core loop of
``csrc/gemm_mma.cuh`` — rows the output pixels, columns the output
channels, depth the KH x KW x C window, the HWIO weight read as the [K, O]
matrix it is — whose A stage gathers the window (``a_offsets`` states its
index map) by 16-byte ``cp.async`` where C % 16 == 0, else by byte loads;
``tiling`` picks the block shape.  ``int8_conv2d_ref`` is its plain
version, ``repro.kernels.ref.int8_conv2d_ref``: an exact f64 sum over the
KH x KW taps (every partial sum is an integer below 2^53), the bias added in
int32 with the reference's wrap-around, then ``core.inumerics.requantize``
(the int16 clip before the multiply).  Bit-exact.
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from . import build
from .common import LAUNCHES, cdiv, check, check_requant, on_cuda

I32 = torch.int32
BK = 64               # window depth a stage of the tensor-core loop holds
# the block shapes (output pixels, output channels) csrc/int8_conv2d.cu
# instantiates, and the threads of each
CONFIGS = {(128, 128): 256, (96, 128): 384, (64, 128): 256, (128, 64): 256,
           (64, 64): 256, (64, 16): 128}


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


def tiling(m: int, o: int) -> tuple[int, int]:
    """The block shape (pixels, channels) of a conv with ``m`` output pixels
    and ``o`` output channels, from every shape of ``CONFIGS`` timed on an
    H100 (``scripts/chip_probe.py conv``; PERF.md gives the times): 64 x 16
    for o <= 16 (Table II's 8 filters), 128 x 64 for o <= 64 (the 3x3 conv
    over 64 channels; the first layer over RGB, where 64 x 64 was 3% faster),
    96 x 128 past it (the ViT-B/16 patch embed's 768: 396 blocks, three an
    SM, where 128 x 128 leaves a third of the SMs a third block)."""
    del m
    if o <= 16:
        return 64, 16
    if o <= 64:
        return 128, 64
    return 96, 128


def a_offsets(n: int, h: int, w: int, c: int, kh: int, kw: int):
    """[M, K] int64: the byte of x (flattened NHWC) that the kernel's
    gathered A stage reads for output pixel m and window depth k, computed
    as ``ConvA`` does: each pixel's base ((img*H + oy)*W + ox)*C once, and
    each 16-byte chunk's place in the window — window row i at seg = i*W*C,
    byte rem of the row's KW*C contiguous bytes — walked from its column's
    first stage by BK a stage, and byte by byte inside the chunk, with no
    division."""
    oh, ow = h - kh + 1, w - kw + 1
    pix = torch.arange(n * oh * ow)
    img, q = pix // (oh * ow), pix % (oh * ow)
    base = ((img * h + q // ow) * w + q % ow) * c
    kwc, wc, k = kw * c, w * c, kh * kw * c
    offs = torch.zeros(k, dtype=torch.int64)
    for c0 in range(0, BK, 16):
        kk, i = c0, c0 // kwc
        seg, rem = i * wc, c0 - i * kwc
        while kk < k:
            s, r = seg, rem
            for b in range(16):
                if kk + b < k:
                    offs[kk + b] = s + r
                r += 1
                if r == kwc:
                    r, s = 0, s + wc
            kk, rem = kk + BK, rem + BK
            while rem >= kwc:
                rem, seg = rem - kwc, seg + wc
    return base[:, None] + offs[None, :]


def _launch(x, w, bias, requant_params):
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    check(kh * kw * c * 128 * 128 < 2 ** 31,
          f"a {kh}x{kw}x{c} window overflows the int32 sums")
    m = n * (h - kh + 1) * (wd - kw + 1)
    bm, bn = tiling(m, o)
    check(m < 2 ** 31 and kh * wd * c < 2 ** 31,
          f"int8_conv2d: {m} output pixels or a {kh}x{wd}x{c} window band "
          f"past int32")
    # output pixels run along the grid's y (at most 2^16 - 1 blocks)
    check(cdiv(m, bm) < 2 ** 16, f"{m} output pixels exceed the grid")
    if requant_params is not None:
        check_requant(requant_params)
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    out = torch.empty((n, h - kh + 1, wd - kw + 1, o), device=x.device,
                      dtype=I32 if requant_params is None else torch.int8)
    rq = (0, 0, 0) if requant_params is None else (
        requant_params.s1, requant_params.mult, requant_params.s2)
    vec_x = int(c % 16 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(o % 16 == 0 and w.data_ptr() % 16 == 0)
    vec_out = int(o % 4 == 0 and out.data_ptr() % 16 == 0)
    fn = build.entry("int8_conv2d", "repro_int8_conv2d",
                     [build.VP] * 4 + [build.I] * 16 + [build.VP])
    rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h,
            wd, c, kh, kw, o, int(requant_params is not None), *rq, bm, bn,
            vec_x, vec_w, vec_out,
            torch.cuda.current_stream(x.device).cuda_stream)
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

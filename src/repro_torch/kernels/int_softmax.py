"""Integer-only softmax (the paper's ``sftmx``): int32 or int8 payload
[M, N] (+ optional keep-mask) -> int8 probabilities [M, N] in [0, 127]
(dequantize with 1/127).

Port of the Pallas kernel ``repro/kernels/int_softmax.py:53``
``int_softmax`` to the CUDA kernel ``csrc/int_softmax.cu`` (source note
there).  Bound on the H100 by bytes: each value, mask byte and probability
crosses device memory once.  The kernel keeps a row in registers up to
``ROW_LIMIT`` values (one warp a row up to 1024, then 2, 4 or 8 warps;
``form``), reads it once by 16-byte loads, computes each exp once and has
no integer division (multiply-highs by exact reciprocals, ``common.rcp``);
longer rows, up to 2^17, stream through a block per row.  A bool mask is
read as it is (one byte of 0 or 1); a mask of [R, N] rows serves x rows r
with mask row r % R, so a mask broadcast over leading dimensions is never
copied (``ops.softmax_i8``).  ``int_softmax_ref`` is its plain version,
``core.inumerics.i_softmax`` as ``repro.kernels.ref.int_softmax_ref`` calls
it.  Bit-exact.

The Pallas kernel clamps the halving count z to 30 BEFORE it forms the
remainder ``qs + z*q_ln2``; the oracle ``i_exp`` forms the remainder with
the unclamped z and clamps only the shift.  For scores more than
``30*q_ln2`` below the row max the Pallas order squares a value past int32
(XLA wraps there; C++ would be undefined).  The port follows the oracle:
the plain version and the kernel form the remainder from the unclamped z.
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from . import build
from .common import LAUNCHES, check, on_cuda, rcp

I32 = torch.int32
NEG_INF = inum.SOFTMAX_NEG_INF
ROW_LIMIT = 8192      # the longest row the kernel holds in registers
MAX_N = 2 ** 17       # the longest row: 14-bit exps keep the row sum in int32
LONG = -1             # ``form`` of the long-row (streaming) kernel


def _exp_consts(scale: float) -> tuple[int, int, int, int]:
    """(q_ln2, q_b, q_c, es) of the integer exp at input scale ``scale``
    (the reference's ``int_softmax._exp_consts``), computed in Python
    (float64) by ``core.inumerics`` and passed to the kernels as ints: never
    recomputed in device code."""
    q_ln2, q_b, q_c, _ = inum.exp_consts(scale)
    return q_ln2, q_b, q_c, inum.exp_rescale_shift(scale)


def exp_max(scale: float) -> int:
    """The largest value the kernels' integer exp (after its ``es`` shift)
    takes at ``scale``: (t^2 + q_c) >> es at either end of t's range
    (q_b - q_ln2, q_b]."""
    q_ln2, q_b, q_c, es = _exp_consts(scale)
    t = max(abs(q_b), abs(q_b - q_ln2 + 1))
    return (t * t + q_c) >> es


def sums_fit(n: int, scale: float) -> bool:
    """True if the kernels' softmax arithmetic is exact over ``n`` values a
    row: every exp is non-negative (q_c >= 0), the row sum l of at most
    ``n`` exps stays in int32, and so does the probability's numerator
    e * 127 + l // 2 (< 2^31, the range of l's and q_ln2's reciprocals;
    q_ln2's numerator -qs is at most -NEG_INF = 2^24 by the clamp)."""
    e, q_c = exp_max(scale), _exp_consts(scale)[2]
    return q_c >= 0 and n * e < 2 ** 31 and 127 * e + (n * e) // 2 < 2 ** 31


def form(n: int) -> int:
    """The kernel's form for rows of ``n`` values: 0 (a warp a row, 16
    values a lane) up to 512; 1, 2, 4, 8 warps a row (32 values a lane) up
    to 1024, 2048, 4096 and ``ROW_LIMIT``; ``LONG`` (a block per row,
    streamed) past it."""
    if n <= 512:
        return 0
    if n > ROW_LIMIT:
        return LONG
    return max(1, 1 << (n - 1).bit_length() - 10)


def int_softmax_ref(x, scale: float, mask=None):
    """Plain version; a mask of R < M rows serves row r with mask row
    r % R (``int_softmax``'s broadcast)."""
    if mask is not None and mask.shape[0] != x.shape[0]:
        rows, n = mask.shape
        out = inum.i_softmax(x.to(I32).reshape(-1, rows, n), scale, mask=mask)
        return out.to(torch.int8).reshape(x.shape)
    return inum.i_softmax(x.to(I32), scale, mask=mask).to(torch.int8)


def _check_ranges(n: int, q_b: int, q_c: int, scale: float) -> None:
    """The ranges the kernel's arithmetic needs: rows of at most 2^17
    values, the largest polynomial (q_b + 0)^2 + q_c in int32, -qs and
    e * 127 + l // 2 below 2^31 (``sums_fit``), where the reciprocals are
    exact."""
    check(n <= MAX_N, f"int_softmax rows of {n} > 2^17 entries overflow "
          f"the int32 row sum")
    check(q_b * q_b + q_c < 2 ** 31, f"scale {scale} too fine for int32 exp")
    check(-NEG_INF < 2 ** 31 and sums_fit(n, scale),
          f"int_softmax: exps at scale {scale} over {n} values leave int32")


def _launch(x, scale: float, mask):
    check(x.dim() == 2, f"int_softmax takes [M, N], got {tuple(x.shape)}")
    check(x.dtype in (torch.int8, I32),
          f"int_softmax takes an int8 or int32 payload, got {x.dtype}")
    m, n = x.shape
    q_ln2, q_b, q_c, es = _exp_consts(scale)
    _check_ranges(n, q_b, q_c, scale)
    check(m < 2 ** 31, f"int_softmax: {m} rows")
    x = x.contiguous()
    rows = m
    if mask is not None:
        rows = mask.shape[0] if mask.dim() == 2 else -1
        check(mask.dim() == 2 and mask.shape[1] == n
              and (rows == m or rows >= 1 and m % rows == 0),
              f"mask {tuple(mask.shape)} vs x {(m, n)}: want [R, {n}] with "
              f"R dividing {m}")
        # a bool mask is one byte of 0 or 1: read as it is
        mask = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
        mask = mask.view(torch.uint8)
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    vec = int(n % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, out, mask) if t is not None))
    fn = build.entry("int_softmax", "repro_int_softmax",
                     [build.VP, build.I, build.VP, build.I, build.U, build.I,
                      build.VP] + [build.I] * 6 + [build.U] + [build.I] * 3
                     + [build.VP])
    rc = fn(x.data_ptr(), int(x.dtype == I32),
            0 if mask is None else mask.data_ptr(), rows, *rcp(max(rows, 1)),
            out.data_ptr(), m, n, q_ln2, q_b, q_c, es, *rcp(q_ln2), form(n),
            vec, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "int_softmax")
    LAUNCHES["int_softmax"] += 1
    return out


def int_softmax(x, scale: float, mask=None):
    """Integer softmax over the last axis of [M, N]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``mask`` (True =
    keep) is [M, N], or [R, N] with R dividing M, row r of x taking mask
    row r % R."""
    if on_cuda(x, mask):
        return _launch(x, scale, mask)
    return int_softmax_ref(x, scale, mask)

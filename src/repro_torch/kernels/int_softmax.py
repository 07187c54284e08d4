"""Integer-only softmax (the paper's ``sftmx``): int32 or int8 payload
[M, N] (+ optional keep-mask) -> int8 probabilities [M, N] in [0, 127]
(dequantize with 1/127).

Port of the Pallas kernel ``repro/kernels/int_softmax.py:53``
``int_softmax`` to the CUDA kernel ``csrc/int_softmax.cu`` (source note
there: bound by bytes, one block per row).  ``int_softmax_ref`` is its plain
version, ``core.inumerics.i_softmax`` as ``repro.kernels.ref.
int_softmax_ref`` calls it.  Bit-exact.

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
from .common import LAUNCHES, check, on_cuda

I32 = torch.int32
NEG_INF = inum.SOFTMAX_NEG_INF


def _exp_consts(scale: float) -> tuple[int, int, int, int]:
    """(q_ln2, q_b, q_c, es) of the integer exp at input scale ``scale``
    (the reference's ``int_softmax._exp_consts``), computed in Python
    (float64) by ``core.inumerics`` and passed to the kernels as ints: never
    recomputed in device code."""
    q_ln2, q_b, q_c, _ = inum.exp_consts(scale)
    return q_ln2, q_b, q_c, inum.exp_rescale_shift(scale)


def int_softmax_ref(x, scale: float, mask=None):
    return inum.i_softmax(x.to(I32), scale, mask=mask).to(torch.int8)


def _launch(x, scale: float, mask):
    check(x.dim() == 2, f"int_softmax takes [M, N], got {tuple(x.shape)}")
    check(x.dtype in (torch.int8, I32),
          f"int_softmax takes an int8 or int32 payload, got {x.dtype}")
    m, n = x.shape
    check(n <= 2 ** 17, f"int_softmax rows of {n} > 2^17 entries overflow "
          f"the int32 row sum")
    x = x.contiguous()
    if mask is not None:
        check(tuple(mask.shape) == (m, n),
              f"mask {tuple(mask.shape)} vs x {(m, n)}")
        mask = mask.to(torch.int8).contiguous()
    q_ln2, q_b, q_c, es = _exp_consts(scale)
    # (q_b + 0)^2 + q_c is the largest polynomial value: it must fit int32
    check(q_b * q_b + q_c < 2 ** 31, f"scale {scale} too fine for int32 exp")
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    fn = build.entry("int_softmax", "repro_int_softmax",
                     [build.VP, build.I, build.VP, build.VP] + [build.I] * 6
                     + [build.VP])
    rc = fn(x.data_ptr(), int(x.dtype == I32),
            0 if mask is None else mask.data_ptr(), out.data_ptr(), m, n,
            q_ln2, q_b, q_c, es, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "int_softmax")
    LAUNCHES["int_softmax"] += 1
    return out


def int_softmax(x, scale: float, mask=None):
    """Integer softmax over the last axis of [M, N]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if on_cuda(x, mask):
        return _launch(x, scale, mask)
    return int_softmax_ref(x, scale, mask)

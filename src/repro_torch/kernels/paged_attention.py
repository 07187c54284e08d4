"""Paged decode attention: one query token per lane against the paged KV
arena (``models/attention.init_paged_cache``), GQA, int8 pages with
per-(token, head) scales dequantized in-register or bf16 pages, f32 online
softmax.  A lane with no valid slot emits exact zeros.

Port of the Pallas kernel ``repro/kernels/paged_attention.py:94``
``paged_decode_attention`` to the CUDA kernel
``csrc/paged_decode_attention.cu`` (source note there: bound by bytes; the
dense kernel's body, split and sum order with the page table read by its
prescan ahead of the copies, so that paged == dense bit for bit on the
card).  The plain version
``paged_decode_attention_ref`` is ``repro.kernels.ref``'s gather-then-attend
oracle: the per-lane view through the page table, the dense decode oracle on
it, zeros for dead lanes.  Kernel and plain version agree within the dense
kernel's tolerance (``int8_kv_decode_attention.RTOL``/``ATOL``), not bit
for bit.  ``paged_decode_attention_rows`` is the multi-row form (the T rows
of a packed t > 1 step, each bit-equal to a T = 1 launch at its position;
the model calls it at every T), counted under the kernel's name and, at
T > 1, under ``paged_decode_attention.rows``.
"""
from __future__ import annotations

import math

import torch

from . import build
from .common import LAUNCHES, check, on_cuda
from .int8_kv_decode_attention import (int8_kv_decode_attention_ref,
                                       launch_rows)


def paged_decode_attention_ref(q, pk, pks, pv, pvs, ppos, pt, qpos,
                               scale=None, window: int = 0):
    """Plain version: ``pks``/``pvs`` None means bf16 pages (no scales)."""
    n_pages, ps = ppos.shape
    ptc = pt.clamp(0, n_pages - 1).long()                   # (B, MP)
    b, mp = ptc.shape
    hkv = pk.shape[2]

    def view(a):
        return a[ptc].reshape(b, mp * ps, hkv, -1)
    ones = torch.ones((n_pages, ps, hkv, 1), dtype=torch.float32,
                      device=q.device)
    pos = ppos[ptc].reshape(b, mp * ps)
    out = int8_kv_decode_attention_ref(
        q, view(pk), view(pks if pks is not None else ones),
        view(pv), view(pvs if pvs is not None else ones), pos, qpos,
        scale=scale, window=window)
    valid = (pos >= 0) & (pos <= qpos[:, None])
    if window:
        valid &= pos > (qpos[:, None] - window)
    live = valid.any(dim=1)
    return torch.where(live[:, None, None], out, torch.zeros_like(out))


def _launch(q, pk, pks, pv, pvs, ppos, pt, qpos, scale, window,
            split_hkv=None):
    b, t, hq, d = q.shape
    n_pages, ps, hkv, d2 = pk.shape
    mp = pt.shape[1]
    int8 = pks is not None
    check(d2 == d and hq % hkv == 0, f"q {tuple(q.shape)} vs pages "
          f"{tuple(pk.shape)}")
    check((pvs is not None) == int8, "pks and pvs come together")
    check(n_pages * ps < 2 ** 31, f"{n_pages} pages of {ps} slots overflow "
          f"the kernel's int32 slot index")
    kdt = torch.int8 if int8 else torch.bfloat16
    operands = [(pk, kdt, (n_pages, ps, hkv, d)), (pv, kdt, (n_pages, ps, hkv, d)),
                (ppos, torch.int32, (n_pages, ps)), (pt, torch.int32, (b, mp))]
    if int8:
        operands += [(pks, torch.float32, (n_pages, ps, hkv, 1)),
                     (pvs, torch.float32, (n_pages, ps, hkv, 1))]
    for x, dt, shape in operands:
        check(x.dtype == dt and tuple(x.shape) == shape and x.is_contiguous(),
              f"paged decode attention operand: want contiguous {dt} {shape}, "
              f"got {x.dtype} {tuple(x.shape)}")
    fn = build.entry("paged_decode_attention", "repro_paged_decode_attention",
                     [build.VP, build.I] + [build.VP] * 4 + [build.I]
                     + [build.VP] * 4 + [build.I] * 7 + [build.F]
                     + [build.I] * 5 + [build.VP] * 2)

    def entry(q, qpos, out, n_split, chunk, t, rows, part):
        return fn(q.data_ptr(), int(q.dtype == torch.bfloat16), pk.data_ptr(),
                  pks.data_ptr() if int8 else None, pv.data_ptr(),
                  pvs.data_ptr() if int8 else None, int(int8), ppos.data_ptr(),
                  pt.data_ptr(), qpos.data_ptr(), out.data_ptr(), b, hq, hkv,
                  n_pages, ps, mp, d, float(scale), int(window), n_split,
                  chunk, t, rows, part.data_ptr(),
                  torch.cuda.current_stream(q.device).cuda_stream)
    out, rc = launch_rows(entry, q, qpos, b, hkv, mp * ps, (pk, pv),
                          1 if int8 else 2, split_hkv)
    build.check_rc(rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    if window > 0:
        LAUNCHES["paged_decode_attention.window"] += 1
    return out


def paged_decode_attention(q, pk, pks, pv, pvs, ppos, pt, qpos, scale=None,
                           window: int = 0):
    """q (B, Hq, D) against the page arena (n_pages, ps, Hkv, D) through the
    page table pt (B, MP) -> (B, Hq, D) in q's dtype: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``pks``/``pvs`` None
    means bf16 pages."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, pk, pks, pv, pvs, ppos, pt, qpos):
        check(tuple(qpos.shape) == (q.shape[0],), f"qpos must be (B,), got "
              f"{tuple(qpos.shape)}")
        return _launch(q[:, None], pk, pks, pv, pvs, ppos, pt, qpos[:, None],
                       scale, window)[:, 0]
    return paged_decode_attention_ref(q, pk, pks, pv, pvs, ppos, pt, qpos,
                                      scale, window)


def paged_decode_attention_rows_ref(q, pk, pks, pv, pvs, ppos, pt, qpos,
                                    scale=None, window: int = 0):
    """Plain version of the multi-row form: row i of q (B, T, Hq, D) through
    the T = 1 plain version at positions qpos[:, i]."""
    return torch.stack([paged_decode_attention_ref(
        q[:, i], pk, pks, pv, pvs, ppos, pt, qpos[:, i], scale, window)
        for i in range(q.shape[1])], dim=1)


def paged_decode_attention_rows(q, pk, pks, pv, pvs, ppos, pt, qpos,
                                scale=None, window: int = 0,
                                split_hkv: int | None = None):
    """The multi-row form: q (B, T, Hq, D) at positions qpos (B, T) against
    the page arena -> (B, T, Hq, D); each row equals a T = 1 launch at its
    position on the card, and the plain version's row on the CPU.
    ``split_hkv`` sizes the cache split (``launch_rows``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, pk, pks, pv, pvs, ppos, pt, qpos):
        out = _launch(q, pk, pks, pv, pvs, ppos, pt, qpos, scale, window,
                      split_hkv)
        if q.shape[1] > 1:
            LAUNCHES["paged_decode_attention.rows"] += 1
        return out
    return paged_decode_attention_rows_ref(q, pk, pks, pv, pvs, ppos, pt, qpos,
                                           scale, window)

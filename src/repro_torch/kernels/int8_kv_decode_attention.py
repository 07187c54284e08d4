"""Decode attention over the int8 KV cache: one query token per lane, GQA,
per-(token, head) scales dequantized in-register, f32 online softmax.

Port of the Pallas kernel ``repro/kernels/int8_kv_decode_attention.py:72``
``int8_kv_decode_attention`` to the CUDA kernel
``csrc/int8_kv_decode_attention.cu`` (source notes there and in
``csrc/decode_tile.cuh``: bound by bytes; a block per (lane, kv head, KV
split) walks the listed tiles of its chunk, their raw rows streamed by
``cp.async`` through a ring and dequantized at the point of use, two tiles
scored per barrier round).  The plain version
``int8_kv_decode_attention_ref`` is ``repro.kernels.ref``'s dequantize-then-
attend oracle.  The two sum in different orders and use their own ``exp``:
they agree within ``|kernel - plain| <= ATOL + RTOL * |plain|``, not bit
for bit.

The multi-row form (``int8_kv_decode_attention_rows``) takes the T rows of a
packed t > 1 step, each at its own position, against the same cache: the
same kernel with a block per tile of rows of one lane (each K/V tile read
once for all of them), and the split of the cache taken from the lanes, as
at T = 1.  Each row is bit-equal to a T = 1 launch at its position, so on
the card a lane's tokens do not depend on how its steps were batched (ROADMAP
C3).  Its plain version applies the T = 1 plain version row by row.  The
model calls it at every T; its launches count under the kernel's name, and
those with T > 1 also under ``<name>.rows``.
"""
from __future__ import annotations

import math

import torch

from . import autotune, build
from .autotune import DECODE_BS as BS
from .common import LAUNCHES, check, on_cuda

NEG = -1e30
# Tolerance of the kernel against its plain version: the f32 results differ
# by summation order and expf (~1e-6 relative), which can flip the final bf16
# rounding by one ulp (2^-7 relative at most); ATOL covers outputs near 0.
RTOL = 2.0 ** -7
ATOL = 1e-3


def int8_kv_decode_attention_ref(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                 scale=None, window: int = 0):
    b, hq, d = q.shape
    hkv = k_q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k = k_q.float() * k_s                                  # (B,S,Hkv,D)
    v = v_q.float() * v_s
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    s_ = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    valid = (pos_ids >= 0) & (pos_ids <= qpos[:, None])
    if window:
        valid &= pos_ids > (qpos[:, None] - window)
    s_ = torch.where(valid[:, None, None, :], s_, torch.full_like(s_, NEG))
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(b, hq, d).to(q.dtype)


ROWS_SMEM = 160 * 1024  # shared memory a multi-row block may take
# the body's constants (``csrc/decode_tile.cuh``): tiles a round, tiles in
# the copy ring, tiles prescanned at once
NR, STAGES, SEG = 2, 4, 16


def block_smem(g: int, d: int, rows: int, kv_bytes: int = 1) -> int:
    """Shared memory of one block of ``rows`` query rows of G heads over
    payloads of ``kv_bytes`` a value (1: int8 with f32 scales, 2: bf16;
    ``smem_bytes`` in ``csrc/decode_tile.cuh``): the ring of STAGES stages,
    each a K tile (rows padded to an odd number of 16-byte chunks) and a V
    tile with their scales; then q, acc, the round's scores, max, sum and
    rescales of every (row, head); then each prescanned key's position and
    slot, the tiles' masks and list, the rows' positions and liveness."""
    rb = d * kv_bytes
    ldk = rb + (16 if (rb // 16) % 2 == 0 else 0)
    sc = 4 * BS if kv_bytes == 1 else 0
    rg = rows * g
    return (STAGES * (BS * ldk + BS * rb + 2 * sc)
            + 4 * (2 * rg * d + rg * NR * BS + 2 * rg + rg * NR)
            + 4 * (2 * SEG * BS + 2 * SEG + 2 * rows + 1))


def rows_per_block(t: int, g: int, d: int, kv_bytes: int = 1) -> int:
    """Rows of one lane that share a block (and each K/V tile read): up to
    16 (at most 32: a tile's rows are one bit mask), halved until the block
    fits ``ROWS_SMEM``; 1 at T = 1.  The bits of a row do not depend on
    it."""
    r = 16
    while r > 1 and block_smem(g, d, r, kv_bytes) > ROWS_SMEM:
        r //= 2
    return max(1, min(r, t))


def launch_rows(entry, q, qpos, b, hkv, s, kv, kv_bytes=1, split_hkv=None):
    """Common part of the dense and paged launches: q (B, T, Hq, D) and
    qpos (B, T) over the payloads ``kv`` (K and V, ``kv_bytes`` a value,
    copied in 16-byte chunks); ``entry(q, qpos, out, n_split, chunk, t,
    rows, part)`` calls the C entry and returns its rc.  ``split_hkv``: the
    kv head count the cache split is sized for (default ``hkv``): a
    tensor-parallel rank holding hkv / tp heads passes the full count, so
    each of its heads is split, and summed, as in the unsharded launch."""
    _, t, hq, d = q.shape
    check(q.dtype in (torch.bfloat16, torch.float32),
          f"q must be bf16 or f32, got {q.dtype}")
    check(tuple(qpos.shape) == (b, t) and qpos.dtype == torch.int32,
          f"qpos must be int32 {(b, t)}, got {qpos.dtype} {tuple(qpos.shape)}")
    check(d * kv_bytes % 16 == 0 and d * kv_bytes <= 256,
          f"head dim {d}: the decode kernels take rows of 16 to 256 bytes "
          f"in 16-byte chunks")
    check(all(x.data_ptr() % 16 == 0 for x in kv),
          "the decode kernels copy K and V in 16-byte chunks: their "
          "payloads must be 16-byte aligned")
    q, qpos = q.contiguous(), qpos.contiguous()
    out = torch.empty_like(q)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    g = hq // hkv
    n_split, chunk = autotune.decode_blocks(b * (split_hkv or hkv), s, d, g,
                                            n_sm)
    rows = rows_per_block(t, g, d, kv_bytes)
    check(block_smem(g, d, rows, kv_bytes) <= 232448, f"G={g} D={d}: a "
          f"decode block does not fit the shared memory")
    # each chunk's (acc, m, l) per (row, head), then the dead rows' V sums
    # and key counts per (lane, kv head, chunk)
    part = torch.empty(b * hkv * n_split * (t * g * (d + 2) + d + 1),
                       dtype=torch.float32, device=q.device)
    return out, entry(q, qpos, out, n_split, chunk, t, rows, part)


def _launch(q, k_q, k_s, v_q, v_s, pos_ids, qpos, scale, window,
            split_hkv=None):
    b, t, hq, d = q.shape
    _, s, hkv, d2 = k_q.shape
    check(d2 == d and hq % hkv == 0, f"q {tuple(q.shape)} vs cache "
          f"{tuple(k_q.shape)}")
    for x, dt, shape in ((k_q, torch.int8, (b, s, hkv, d)),
                         (v_q, torch.int8, (b, s, hkv, d)),
                         (k_s, torch.float32, (b, s, hkv, 1)),
                         (v_s, torch.float32, (b, s, hkv, 1)),
                         (pos_ids, torch.int32, (b, s))):
        check(x.dtype == dt and tuple(x.shape) == shape and x.is_contiguous(),
              f"decode attention operand: want contiguous {dt} {shape}, got "
              f"{x.dtype} {tuple(x.shape)}")
    fn = build.entry("int8_kv_decode_attention",
                     "repro_int8_kv_decode_attention",
                     [build.VP, build.I] + [build.VP] * 7 + [build.I] * 5
                     + [build.F] + [build.I] * 5 + [build.VP] * 2)

    def entry(q, qpos, out, n_split, chunk, t, rows, part):
        return fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(),
                  k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                  pos_ids.data_ptr(), qpos.data_ptr(), out.data_ptr(), b, hq,
                  hkv, s, d, float(scale), int(window), n_split, chunk, t,
                  rows, part.data_ptr(),
                  torch.cuda.current_stream(q.device).cuda_stream)
    out, rc = launch_rows(entry, q, qpos, b, hkv, s, (k_q, v_q),
                          split_hkv=split_hkv)
    build.check_rc(rc, "int8_kv_decode_attention")
    LAUNCHES["int8_kv_decode_attention"] += 1
    if window > 0:
        LAUNCHES["int8_kv_decode_attention.window"] += 1
    return out


def int8_kv_decode_attention(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                             scale=None, window: int = 0):
    """q (B, Hq, D) against the int8 cache (B, S, Hkv, D) -> (B, Hq, D) in
    q's dtype: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, k_q, k_s, v_q, v_s, pos_ids, qpos):
        check(tuple(qpos.shape) == (q.shape[0],), f"qpos must be (B,), got "
              f"{tuple(qpos.shape)}")
        return _launch(q[:, None], k_q, k_s, v_q, v_s, pos_ids, qpos[:, None],
                       scale, window)[:, 0]
    return int8_kv_decode_attention_ref(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                        scale, window)


def int8_kv_decode_attention_rows_ref(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                      scale=None, window: int = 0):
    """Plain version of the multi-row form: row i of q (B, T, Hq, D) through
    the T = 1 plain version at positions qpos[:, i]."""
    return torch.stack([int8_kv_decode_attention_ref(
        q[:, i], k_q, k_s, v_q, v_s, pos_ids, qpos[:, i], scale, window)
        for i in range(q.shape[1])], dim=1)


def int8_kv_decode_attention_rows(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                  scale=None, window: int = 0,
                                  split_hkv: int | None = None):
    """The multi-row form: q (B, T, Hq, D) at positions qpos (B, T) against
    the int8 cache -> (B, T, Hq, D); each row equals a T = 1 launch at its
    position on the card, and the plain version's row on the CPU.  At
    T = 1 it is the single-token launch.  ``split_hkv`` (``launch_rows``)
    sizes the cache split; the plain version does not split."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, k_q, k_s, v_q, v_s, pos_ids, qpos):
        out = _launch(q, k_q, k_s, v_q, v_s, pos_ids, qpos, scale, window,
                      split_hkv)
        if q.shape[1] > 1:
            LAUNCHES["int8_kv_decode_attention.rows"] += 1
        return out
    return int8_kv_decode_attention_rows_ref(q, k_q, k_s, v_q, v_s, pos_ids,
                                             qpos, scale, window)

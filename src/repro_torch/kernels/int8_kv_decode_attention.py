"""Decode attention over the int8 KV cache: one query token per lane, GQA,
per-(token, head) scales dequantized in-register, f32 online softmax.

Port of the Pallas kernel ``repro/kernels/int8_kv_decode_attention.py:72``
``int8_kv_decode_attention`` to the CUDA kernel
``csrc/int8_kv_decode_attention.cu`` (source note there: bound by bytes, one
block per (lane, kv head), a loop over key tiles).  The plain version
``int8_kv_decode_attention_ref`` is ``repro.kernels.ref``'s dequantize-then-
attend oracle.  The two sum in different orders and use their own ``exp``:
they agree within ``|kernel - plain| <= ATOL + RTOL * |plain|``, not bit
for bit.
"""
from __future__ import annotations

import math

import torch

from . import build
from .common import LAUNCHES, cdiv, check, on_cuda

NEG = -1e30
BS = 32  # keys per tile of the CUDA kernel
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


def kv_split(blocks: int, s: int, n_sm: int) -> tuple[int, int]:
    """(n_split, chunk): split the cache into chunks of whole BS-key tiles
    until about two blocks per SM are in flight; every chunk is non-empty."""
    tiles = cdiv(s, BS)
    n_split = max(1, min(tiles, cdiv(2 * n_sm, blocks)))
    chunk = cdiv(tiles, n_split) * BS
    return cdiv(s, chunk), chunk


def _launch(q, k_q, k_s, v_q, v_s, pos_ids, qpos, scale, window):
    b, hq, d = q.shape
    _, s, hkv, d2 = k_q.shape
    check(d2 == d and hq % hkv == 0, f"q {tuple(q.shape)} vs cache "
          f"{tuple(k_q.shape)}")
    check(q.dtype in (torch.bfloat16, torch.float32),
          f"q must be bf16 or f32, got {q.dtype}")
    for t, dt, shape in ((k_q, torch.int8, (b, s, hkv, d)),
                         (v_q, torch.int8, (b, s, hkv, d)),
                         (k_s, torch.float32, (b, s, hkv, 1)),
                         (v_s, torch.float32, (b, s, hkv, 1)),
                         (pos_ids, torch.int32, (b, s)),
                         (qpos, torch.int32, (b,))):
        check(t.dtype == dt and tuple(t.shape) == shape and t.is_contiguous(),
              f"decode attention operand: want contiguous {dt} {shape}, got "
              f"{t.dtype} {tuple(t.shape)}")
    q = q.contiguous()
    out = torch.empty_like(q)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, chunk = kv_split(b * hkv, s, n_sm)
    part = torch.empty(b * hkv * n_split * (hq // hkv) * (d + 2),
                       dtype=torch.float32, device=q.device)
    fn = build.entry("int8_kv_decode_attention",
                     "repro_int8_kv_decode_attention",
                     [build.VP, build.I] + [build.VP] * 7 + [build.I] * 5
                     + [build.F] + [build.I] * 3 + [build.VP] * 2)
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(),
            k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), pos_ids.data_ptr(),
            qpos.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, float(scale),
            int(window), n_split, chunk, part.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(rc, "int8_kv_decode_attention")
    LAUNCHES["int8_kv_decode_attention"] += 1
    return out


def int8_kv_decode_attention(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                             scale=None, window: int = 0):
    """q (B, Hq, D) against the int8 cache (B, S, Hkv, D) -> (B, Hq, D) in
    q's dtype: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, k_q, k_s, v_q, v_s, pos_ids, qpos):
        return _launch(q, k_q, k_s, v_q, v_s, pos_ids, qpos, scale, window)
    return int8_kv_decode_attention_ref(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                        scale, window)

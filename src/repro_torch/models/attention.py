"""Attention: GQA/MQA with a dense ring KV cache (bf16 or int8).

Port of ``repro.models.attention`` for self-attention with a dense cache:

    cache = {"k": (B,S,Hkv,D), "v": (B,S,Hkv,D), "pos_ids": (B,S) int32}
    (+ "k_s"/"v_s": (B,S,Hkv,1) f32 per-(token, head) scales when int8)

``pos_ids`` holds the absolute position stored in each slot (-1 = empty);
masking always derives from it.  RoPE is applied at write time.

Unlike the reference, which returns a new cache, the port writes the cache
IN PLACE: pad tokens (position -1) are dropped before the write, so a lane
that feeds only pads is left untouched — exactly what the reference's
lane-masked commit keeps.

The decode kernel (``ops.decode_attention_int8kv``) runs iff the cache is
int8, the step feeds one token per lane and the cache lies on a CUDA device
— the port's form of the reference's ``ops.backend() == "pallas"`` test.
Everywhere else (CPU, bf16 cache, mixed-depth packed rows) the port takes
the reference's ``jnp``-backend branch: ``_read_cache`` -> ``_sdpa`` in
plain PyTorch.  Cross-attention, paged caches and integer no-cache
attention are later slices (ROADMAP.md §A).
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ..kernels import ops
from ..kernels.common import f32, rcp32
from .config import ArchConfig
from .layers import ExecMode, Linear, apply_linear, apply_rope, dense_init

F32 = torch.float32
NEG = -1e30
_RCP127 = rcp32(127.0)


class Attention(nn.Module):
    """q/k/v/o projections (``Linear``) and the optional qkv biases."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear,
                 bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.register_buffer("bq", bq)
        self.register_buffer("bk", bk)
        self.register_buffer("bv", bv)


def init_attn_params(gen: torch.Generator, cfg: ArchConfig, device) -> Attention:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = Attention(Linear(dense_init(gen, d, nq * hd, device)),
                  Linear(dense_init(gen, d, nkv * hd, device)),
                  Linear(dense_init(gen, d, nkv * hd, device)),
                  Linear(dense_init(gen, nq * hd, d, device)))
    if cfg.qkv_bias:
        p.bq = torch.zeros(nq * hd, dtype=F32, device=device)
        p.bk = torch.zeros(nkv * hd, dtype=F32, device=device)
        p.bv = torch.zeros(nkv * hd, dtype=F32, device=device)
    return p


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, int8: bool,
               dtype=torch.bfloat16, device=None) -> dict:
    """Dense ring cache of ``max_seq`` slots per lane (sliding-window ring
    caches are a later slice)."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, max_seq, hkv, hd)
    cache: dict[str, Any] = {
        "pos_ids": torch.full((batch, max_seq), -1, dtype=torch.int32,
                              device=device)}
    if int8:
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["k_s"] = torch.ones((*shape[:3], 1), dtype=F32, device=device)
        cache["v_s"] = torch.ones((*shape[:3], 1), dtype=F32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _quant_kv(x):
    """per-(token, head) symmetric int8 (``amax / 127.0`` as jitted)."""
    xf = x.float()
    amax = torch.maximum(xf.abs().amax(-1, keepdim=True), f32(1e-8, x.device))
    s = amax * f32(_RCP127, x.device)
    return torch.clamp(torch.round(xf / s), -128, 127).to(torch.int8), s


def cache_writes(positions: torch.Tensor):
    """(lane, row) indices of the non-pad tokens of a (B, T) position batch.
    ``forward`` computes them once per step (one host sync) and every
    layer's ``_write_cache`` reuses them."""
    return torch.nonzero(positions >= 0, as_tuple=True)


def _write_cache(cache: dict, k, v, positions, writes=None) -> dict:
    """Write k/v (B,T,Hkv,D) at ring slots positions % S, in place.

    Negative positions are masked writes: they are dropped (the reference's
    out-of-bounds scatter).  A full-length write (T == S) assigns the whole
    cache, pads included, as the reference does."""
    s = cache["k"].shape[1]
    int8 = "k_s" in cache
    if k.shape[1] == s:
        if int8:
            k_q, k_s = _quant_kv(k)
            v_q, v_s = _quant_kv(v)
            for key, val in (("k", k_q), ("v", v_q), ("k_s", k_s), ("v_s", v_s)):
                cache[key].copy_(val)
        else:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        cache["pos_ids"].copy_(positions)
        return cache
    b_idx, t_idx = cache_writes(positions) if writes is None else writes
    pos = positions[b_idx, t_idx]
    slots = pos % s
    if int8:
        k_q, k_s = _quant_kv(k[b_idx, t_idx])
        v_q, v_s = _quant_kv(v[b_idx, t_idx])
        cache["k"][b_idx, slots] = k_q
        cache["v"][b_idx, slots] = v_q
        cache["k_s"][b_idx, slots] = k_s
        cache["v_s"][b_idx, slots] = v_s
    else:
        cache["k"][b_idx, slots] = k[b_idx, t_idx].to(cache["k"].dtype)
        cache["v"][b_idx, slots] = v[b_idx, t_idx].to(cache["v"].dtype)
    cache["pos_ids"][b_idx, slots] = pos
    return cache


def _read_cache(cache: dict, dtype):
    if "k_s" in cache:
        k = cache["k"].float() * cache["k_s"]
        v = cache["v"].float() * cache["v_s"]
        return k.to(dtype), v.to(dtype)
    return cache["k"].to(dtype), cache["v"].to(dtype)


def _sdpa(q, k, v, qpos, kpos, scale, dtype, *, causal=True, window=0,
          valid=None):
    """Grouped-GQA attention, masks built from positions.

    q (B,Tq,Hq,D), k/v (B,Tk,Hkv,D); qpos (B,Tq), kpos (B,Tk); valid (B,Tk)
    bool or None.  bf16 operands, f32 scores and accumulation, as the
    reference's einsums with ``preferred_element_type=f32``.  The reference
    chunks queries at 1024 rows; serving spans are at most the token budget,
    so the port runs one chunk."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kt = k.transpose(1, 2).float()                          # (B,Hkv,Tk,D)
    vt = v.transpose(1, 2).float()
    qg = q.reshape(b, tq, hkv, g, d).float()
    s = torch.einsum("bthgd,bhkd->bthgk", qg, kt) * scale   # (B,Tq,Hkv,G,Tk)
    m = torch.ones((b, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos[:, None, :] <= qpos[:, :, None]
    if window:
        m &= kpos[:, None, :] > (qpos[:, :, None] - window)
    if valid is not None:
        m &= valid[:, None, :]
    s = torch.where(m[:, :, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bthgk,bhkd->bthgd", p.to(dtype).float(), vt)
    return o.reshape(b, tq, hq, d).to(dtype)


def attention(params: Attention, x, cfg: ArchConfig, mode: ExecMode,
              positions, cache: dict | None = None, window: int = 0,
              residual=None, writes=None):
    """Self-attention of x (B, T, D) at absolute ``positions`` (B, T), with
    the skip connection ``residual`` folded into the out-projection.
    Returns (out, cache); the cache is updated in place."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = apply_linear(x, params.wq, mode, params.bq)
    q = q.reshape(b, t, q.shape[-1] // hd, hd)
    k = apply_linear(x, params.wk, mode, params.bk)
    v = apply_linear(x, params.wv, mode, params.bv)
    k = k.reshape(b, t, k.shape[-1] // hd, hd)
    v = v.reshape(b, t, v.shape[-1] // hd, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    dtype = x.dtype

    if cache is not None:
        cache = _write_cache(cache, k, v, positions, writes)
        if "k_s" in cache and t == 1 and cache["k"].is_cuda:
            # serving hot path: the int8-KV decode kernel (one int8 pass
            # over the cache, in-register dequant)
            out = ops.decode_attention_int8kv(
                q[:, 0], cache["k"], cache["k_s"], cache["v"], cache["v_s"],
                cache["pos_ids"], positions[:, 0].to(torch.int32).contiguous(),
                scale=scale, window=window)[:, None].to(dtype)
        else:
            kc, vc = _read_cache(cache, dtype)              # (B,S,Hkv,D)
            kpos = cache["pos_ids"]
            out = _sdpa(q, kc, vc, positions, kpos, scale, dtype, causal=True,
                        window=window, valid=kpos >= 0)
    elif mode.integer and window == 0:
        raise NotImplementedError(
            "integer attention without a cache runs int8_flash_attention, "
            "which is not ported yet (ROADMAP.md §B); serve with a cache")
    else:
        out = _sdpa(q, k, v, positions, positions, scale, dtype, causal=True,
                    window=window)
    out = out.to(dtype).reshape(b, t, -1)
    # the residual add rides the out-projection (integer path: fused GEMM
    # epilogue — the projection output never round-trips before the skip)
    out = apply_linear(out, params.wo, mode, residual=residual)
    return out, cache

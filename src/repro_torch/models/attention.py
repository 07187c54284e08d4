"""Attention: GQA/MQA over a dense ring KV cache or a paged KV arena
(bf16 or int8), the no-cache causal forward, and cross-attention.

Port of ``repro.models.attention``.  The dense cache:

    cache = {"k": (B,S,Hkv,D), "v": (B,S,Hkv,D), "pos_ids": (B,S) int32}
    (+ "k_s"/"v_s": (B,S,Hkv,1) f32 per-(token, head) scales when int8)

The paged arena (``init_paged_cache``) keeps the same payload per page and a
page table per lane.  ``pos_ids``/``ppos`` hold the absolute position stored
in each slot (-1 = empty); masking always derives from them.  RoPE is
applied at write time.  A sliding-window layer's dense cache is a ring of
window + slack slots, written at ``position % S`` across the seam; its
queries mask keys at or below ``position - window`` (``_sdpa`` and the
decode kernels take the window).

Unlike the reference, which returns a new cache, the port writes the cache
IN PLACE: pad tokens (position -1) are dropped before the write, so a lane
that feeds only pads is left untouched — exactly what the reference's
lane-masked commit keeps.

With a cache, the decode kernels run iff the cache is int8 and lies on a CUDA
device — the port's form of the reference's ``ops.backend() == "pallas"``
test: the decode kernels' multi-row forms (``ops.decode_attention_int8kv_rows``
for the dense cache, ``ops.paged_attention_decode_rows`` for the arena) at
every t, each of a step's rows computed exactly as a one-token step at its
position would compute it (at t = 1 they are the one-token launch), so a
lane's tokens on the card do not depend on how its steps were batched (the
reference's TPU path sends such rows to ``_sdpa``, whose probabilities are
rounded to bf16 before P@V).  Everywhere else (CPU, bf16 cache) the port
takes the reference's ``jnp``-backend branch: ``_read_cache``/``_read_paged``
-> ``_sdpa`` in plain PyTorch.  ``card_order=True`` sends int8-cache rows on
the CPU through the decode kernels' plain versions instead, and the bf16
no-cache rows through flash_attention's, the card's order (a check of the
card against the CPU, not the reference's path).

Without a cache (scoring, ``lm_loss``, calibration) the reference's rule
holds: an integer mode with no window runs ``_int_attention``
(``ops.attention_i8``: the int8_flash_attention kernel on the card, its plain
version on the CPU); otherwise a CUDA tensor with no window and T % 8 == 0
runs ``ops.attention`` (the flash_attention kernel), and everything else
``_sdpa``.

Under serving tensor parallelism (``dist/tp.py``) a rank holds a slice of
the heads: its q/k/v projections are column shards, so the head counts come
from the projected widths, and its caches hold hkv / tp heads; the decode
kernels size their cache split for the full ``cfg.n_kv_heads``, so a rank's
heads are computed as in the unsharded launch.  The out-projection ``wo``
runs behind ``tp_out_projection``, the one collective boundary.

Cross-attention (``kv_source`` features, or their K/V precomputed once per
request by ``cross_kv_proj`` and passed as ``cross_kv``) projects no K/V from
x, applies no RoPE and attends without a mask (every key at position 0)
through ``_sdpa`` in plain PyTorch, as the reference runs XLA's ``_sdpa``
there (no Pallas kernel).  Without either, a cross layer is the reference's
causal self-attention with RoPE on its own weights.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ..dist.tp import tp_out_projection
from ..kernels import ops
from ..kernels.common import f32, rcp32
from ..kernels.int8_flash_attention import head_shift
from .config import ArchConfig
from .layers import (ExecMode, Linear, QRows, apply_linear, apply_rope,
                     dense_init)

F32 = torch.float32
NEG = -1e30

# canonical static int8 scale for activations entering integer attention
ATTN_INT_SCALE = 1.0 / 16.0


class Attention(nn.Module):
    """q/k/v/o projections (``Linear``) and the optional qkv biases."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear,
                 bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        # parameters like every float weight: the reference trains them
        self.bq, self.bk, self.bv = (
            None if b is None else nn.Parameter(b, requires_grad=False)
            for b in (bq, bk, bv))


def init_attn_params(gen: torch.Generator, cfg: ArchConfig, device,
                     cross: bool = False) -> Attention:
    """q/k/v/o (and qkv biases); a cross-attention layer (``cross``) has
    the same weights, as in the reference."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    bias = ([torch.zeros(n * hd, dtype=F32, device=device)
             for n in (nq, nkv, nkv)] if cfg.qkv_bias else [None] * 3)
    return Attention(Linear(dense_init(gen, d, nq * hd, device)),
                     Linear(dense_init(gen, d, nkv * hd, device)),
                     Linear(dense_init(gen, d, nkv * hd, device)),
                     Linear(dense_init(gen, nq * hd, d, device)), *bias)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, int8: bool,
               window: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Dense ring cache per lane: ``max_seq`` slots, or with a ``window``
    (a sliding-window layer's window plus its slack) min(window, max_seq)
    slots that positions overwrite modulo their count."""
    s = min(window, max_seq) if window else max_seq
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, s, hkv, hd)
    cache: dict[str, Any] = {
        "pos_ids": torch.full((batch, s), -1, dtype=torch.int32,
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
    """per-(token, head) symmetric int8 (``amax / 127.0`` as jitted): the
    row quantization over rows of the head dim, ``ops.quant_rows`` (the
    quantize_rows kernel on the card, reading x's bf16 rows as they are)."""
    return ops.quant_rows(x)


def cache_writes(positions: torch.Tensor, cache: dict | None = None):
    """The write indices of a (B, T) position batch, computed once per step
    (one host sync) and reused by every layer's cache write.

    Dense cache (or ``cache`` None): the (lane, row) indices of the non-pad
    tokens.  Paged arena: (lane, row, physical page, slot) of the tokens
    that land in a mapped page — slot = (pt[lane, pos // ps], pos % ps);
    pads and null-page targets are dropped (the reference routes them out
    of bounds).  Every layer's arena shares one page table, so one layer's
    cache speaks for all."""
    if cache is None or "pt" not in cache:
        return torch.nonzero(positions >= 0, as_tuple=True)
    pt = cache["pt"]
    ps = cache["ppos"].shape[-1]
    live = positions >= 0
    logical = torch.where(live, positions // ps, 0).clamp(0, pt.shape[1] - 1)
    phys = torch.gather(pt, 1, logical.long())
    b_idx, t_idx = torch.nonzero(live & (phys > 0), as_tuple=True)
    return (b_idx, t_idx, phys[b_idx, t_idx].long(),
            positions[b_idx, t_idx].long() % ps)


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


def rollback_cache(cache: dict, keep: torch.Tensor) -> dict:
    """Speculative-decode KV rewind of the DENSE layout, in place: every
    slot holding a position >= its lane's ``keep`` bound ((B,) int; lanes
    with nothing to withdraw pass a bound above ``max_seq``) is marked
    empty again.  Masking derives from ``pos_ids`` everywhere, so the stale
    payload is unreadable and the next write at that slot reclaims it, as
    if the rejected tokens had never been fed.  On a window layer's ring of
    S = window + slack slots a rejected write overwrote the key S positions
    before it, which is outside the window of every later query (the slack
    is at least the span), so the rewind is exact there too, as in the
    reference (``attention.py:210-228``)."""
    pos = cache["pos_ids"]
    pos.masked_fill_(pos >= keep.to(pos.device, pos.dtype)[:, None], -1)
    return cache


def _read_cache(cache: dict, dtype):
    if "k_s" in cache:
        k = cache["k"].float() * cache["k_s"]
        v = cache["v"].float() * cache["v_s"]
        return k.to(dtype), v.to(dtype)
    return cache["k"].to(dtype), cache["v"].to(dtype)


# ---------------------------------------------------------------------------
# the paged KV arena
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ArchConfig, batch: int, n_pages: int,
                     page_size: int, pages_per_lane: int, *, int8: bool,
                     dtype=torch.bfloat16, device=None, pt=None) -> dict:
    """Paged KV arena: ONE physical pool of ``n_pages`` fixed-size pages
    shared by every lane, plus the per-lane page table.

        cache = {"pk"/"pv": (n_pages, ps, Hkv, D),          # page payload
                 "pks"/"pvs": (n_pages, ps, Hkv, 1) f32,    # int8 scales
                 "ppos": (n_pages, ps) int32,               # -1 = empty slot
                 "pt":   (B, max_pages) int32}              # page table

    Page 0 is the permanent null page (``serve/kv_pool.py``): unmapped
    table entries point at it and its ``ppos`` stays -1.  Logical page j of
    a lane covers absolute positions [j*ps, (j+1)*ps); with ps | max_seq
    the gathered per-lane view is element-for-element the dense
    ``init_cache`` layout.  ``pt`` passes a page table to share: the
    engine gives every layer the same tensor and updates it in place once
    per step (the reference broadcasts a fresh table into every leaf)."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (n_pages, page_size, hkv, hd)
    cache: dict[str, Any] = {
        "ppos": torch.full((n_pages, page_size), -1, dtype=torch.int32,
                           device=device)}
    if int8:
        cache["pk"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["pv"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["pks"] = torch.ones((*shape[:3], 1), dtype=F32, device=device)
        cache["pvs"] = torch.ones((*shape[:3], 1), dtype=F32, device=device)
    else:
        cache["pk"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["pv"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["pt"] = (torch.zeros((batch, pages_per_lane), dtype=torch.int32,
                               device=device) if pt is None else pt)
    return cache


def _write_paged(cache: dict, k, v, positions, writes=None) -> dict:
    """Scatter k/v (B,T,Hkv,D) into the page arena through the page table,
    in place: slot = (pt[lane, pos // ps], pos % ps).  Pad tokens (position
    -1) and null-page targets are dropped (``cache_writes``); the engine
    backs every real write with a lane-owned page
    (``kv_pool.ensure_writable``).  The int8 quantization is ``_quant_kv``,
    the dense cache's."""
    b_idx, t_idx, phys, slot = (cache_writes(positions, cache)
                                if writes is None else writes)
    if "pks" in cache:
        k_q, k_s = _quant_kv(k[b_idx, t_idx])
        v_q, v_s = _quant_kv(v[b_idx, t_idx])
        cache["pk"][phys, slot] = k_q
        cache["pv"][phys, slot] = v_q
        cache["pks"][phys, slot] = k_s
        cache["pvs"][phys, slot] = v_s
    else:
        cache["pk"][phys, slot] = k[b_idx, t_idx].to(cache["pk"].dtype)
        cache["pv"][phys, slot] = v[b_idx, t_idx].to(cache["pv"].dtype)
    cache["ppos"][phys, slot] = positions[b_idx, t_idx].to(torch.int32)
    return cache


def _read_paged(cache: dict, dtype):
    """Gather the per-lane dense view (B, MP*ps, Hkv, D) + positions.

    With ps | max_seq this view is element-for-element what ``_read_cache``
    returns for the dense cache (null/empty slots carry pos -1 and are
    masked by position), so the attention math downstream is unchanged."""
    npg, ps = cache["ppos"].shape
    pt = cache["pt"].clamp(0, npg - 1).long()               # (B, MP)
    b, mp = pt.shape
    kpos = cache["ppos"][pt].reshape(b, mp * ps)
    if "pks" in cache:
        k = cache["pk"][pt].float() * cache["pks"][pt]
        v = cache["pv"][pt].float() * cache["pvs"][pt]
    else:
        k, v = cache["pk"][pt], cache["pv"][pt]
    shape = (b, mp * ps) + tuple(k.shape[3:])
    return k.to(dtype).reshape(shape), v.to(dtype).reshape(shape), kpos


# the leaves of one layer's arena; the page axis is 0 (the port keeps one
# cache per layer, where the reference stacks them per period)
_PAGE_KEYS = ("pk", "pv", "pks", "pvs", "ppos")


def gather_pages(cache: dict, page_ids) -> dict:
    """Pull whole pages' payloads off the arena — the device side of KV
    swap-OUT.  Returns ``{pk, pv[, pks, pvs], ppos}`` sliced to
    ``page_ids`` along the page axis; pure data movement (no dequant, no
    cast), so a gather -> ``scatter_pages`` round trip is bit-identical
    whatever physical pages the content comes back to."""
    idx = torch.as_tensor(page_ids, dtype=torch.long,
                          device=cache["ppos"].device)
    return {k: cache[k].index_select(0, idx) for k in _PAGE_KEYS if k in cache}


def scatter_pages(cache: dict, page_ids, payload: dict) -> dict:
    """Write gathered page payloads back into (possibly DIFFERENT) physical
    pages, in place — the device side of swap-IN.  ``ppos`` is absolute,
    so only the page table needs to name the new pages.  (The reference
    pads ``page_ids`` with out-of-bounds ids to keep one compiled shape;
    the port passes exactly the pages.)"""
    dev = cache["ppos"].device
    idx = torch.as_tensor(page_ids, dtype=torch.long, device=dev)
    for k, val in payload.items():
        cache[k].index_copy_(0, idx, val.to(dev, cache[k].dtype))
    return cache


# query-chunked softmax (the reference's 1024 rows), each chunk also cut so
# that its f32 scores stay under SDPA_CHUNK_ELEMS (scoring cross-attention:
# 4 x 1024 queries x 64 heads x 1601 keys)
ATTN_Q_CHUNK = 1024
SDPA_CHUNK_ELEMS = 1 << 28


def _sdpa(q, k, v, qpos, kpos, scale, dtype, *, causal=True, window=0,
          valid=None):
    """Grouped-GQA attention, masks built from positions.

    q (B,Tq,Hq,D), k/v (B,Tk,Hkv,D); qpos (B,Tq), kpos (B,Tk); valid (B,Tk)
    bool or None.  bf16 operands, f32 scores and accumulation, as the
    reference's einsums with ``preferred_element_type=f32``.  Queries run in
    chunks of at most ``ATTN_Q_CHUNK`` rows (fewer where the chunk's scores
    would pass ``SDPA_CHUNK_ELEMS``); each row's result does not depend on
    the chunking."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kt = k.transpose(1, 2).float()                          # (B,Hkv,Tk,D)
    vt = v.transpose(1, 2).float()
    chunk = max(1, min(ATTN_Q_CHUNK, SDPA_CHUNK_ELEMS // (b * hq * tk)))

    def attend(qc, qp):
        tc = qc.shape[1]
        qg = qc.reshape(b, tc, hkv, g, d).float()
        s = torch.einsum("bthgd,bhkd->bthgk", qg, kt) * scale  # (B,Tc,Hkv,G,Tk)
        if causal or window or valid is not None:
            m = torch.ones((b, tc, tk), dtype=torch.bool, device=q.device)
            if causal:
                m &= kpos[:, None, :] <= qp[:, :, None]
            if window:
                m &= kpos[:, None, :] > (qp[:, :, None] - window)
            if valid is not None:
                m &= valid[:, None, :]
            s = s.masked_fill_(~m[:, :, None, None, :], NEG)
        p = torch.softmax(s, dim=-1)
        del s
        o = torch.einsum("bthgk,bhkd->bthgd", p.to(dtype).float(), vt)
        return o.reshape(b, tc, hq, d).to(dtype)

    if tq <= chunk:
        return attend(q, qpos)
    return torch.cat([attend(q[:, i:i + chunk], qpos[:, i:i + chunk])
                      for i in range(0, tq, chunk)], dim=1)


def _int_attention(q, k, v, causal: bool = True):
    """Integer no-cache attention (the paper's path): static-scale int8 q/k,
    V in int8 with per-(token, head) scales dequantized EXACTLY in the PV
    pass — the only error left against float attention is the input
    quantization itself.  q (B,T,Hq,D), k/v (B,T,Hkv,D) -> f32 (B,T,Hq,D)."""
    # x / ATTN_INT_SCALE under jit: a product with the f32 reciprocal (16.0)
    inv = f32(rcp32(ATTN_INT_SCALE), q.device)
    qi = torch.clamp(torch.round(q.float() * inv), -128, 127).to(torch.int8)
    ki = torch.clamp(torch.round(k.float() * inv), -128, 127).to(torch.int8)
    vi, v_s = _quant_kv(v)                        # per-(token, head) scales
    out = ops.attention_i8(qi.transpose(1, 2), ki.transpose(1, 2),
                           vi.transpose(1, 2),
                           scale=int_score_scale(q.shape[-1]), causal=causal,
                           v_scale=v_s.transpose(1, 2))    # (B,H,T,D) f32
    return out.transpose(1, 2)


def int_score_scale(hd: int) -> float:
    """Real value of one unit of the integer attention's scores: q and k at
    ATTN_INT_SCALE, after the power-of-two part of 1/sqrt(hd) is folded
    into the scores as a shift; the residual sqrt factor is folded here."""
    return ATTN_INT_SCALE * ATTN_INT_SCALE * (2.0 ** head_shift(hd)) / math.sqrt(hd)


def _card_route(cache_leaf, card_order: bool) -> bool:
    """True where int8-cache rows take the decode kernels: a cache on the
    card, or any cache with ``card_order`` (module note)."""
    return cache_leaf.is_cuda or card_order


def cross_kv_proj(params: Attention, kv_source, cfg: ArchConfig,
                  mode: ExecMode):
    """Cross-attention K/V of source features (B, Sv, d), each (B, Sv, Hkv,
    D) in the compute dtype: projected once per request."""
    b, sv = kv_source.shape[:2]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    xq = QRows(*ops.quant_rows(kv_source)) if params.wk.quantized else None
    k = apply_linear(kv_source, params.wk, mode, params.bk, xq=xq)
    v = apply_linear(kv_source, params.wv, mode, params.bv, xq=xq)
    return k.reshape(b, sv, hkv, hd), v.reshape(b, sv, hkv, hd)


def attention(params: Attention, x, cfg: ArchConfig, mode: ExecMode,
              positions, cache: dict | None = None, window: int = 0,
              residual=None, writes=None, card_order: bool = False,
              xq: QRows | None = None, kv_source=None, cross_kv=None):
    """Attention of x (B, T, D) at absolute ``positions`` (B, T), with the
    skip connection ``residual`` (when given) folded into the
    out-projection.  Returns (out, cache); the cache is updated in place.
    ``card_order``: int8-cache rows take the decode kernels, and bf16
    no-cache rows flash_attention, on any device (module note).  ``xq``: x's rows already quantized (the fused norm's),
    which q, k and v share.  ``kv_source`` (B, Sv, d) features or
    ``cross_kv`` (their precomputed (xk, xv)) make it cross-attention."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    cross = kv_source is not None or cross_kv is not None
    q = apply_linear(x, params.wq, mode, params.bq, xq=xq)
    q = q.reshape(b, t, q.shape[-1] // hd, hd)
    if cross_kv is not None:
        # static cross KV, computed once per request (the state's dtype)
        k, v = cross_kv[0].to(x.dtype), cross_kv[1].to(x.dtype)
    elif cross:
        k, v = cross_kv_proj(params, kv_source, cfg, mode)
    else:
        k = apply_linear(x, params.wk, mode, params.bk, xq=xq)
        v = apply_linear(x, params.wv, mode, params.bv, xq=xq)
        k = k.reshape(b, t, k.shape[-1] // hd, hd)
        v = v.reshape(b, t, v.shape[-1] // hd, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    dtype = x.dtype

    if cross:
        # static KV, no mask: every source position is valid
        kpos = torch.zeros((b, k.shape[1]), dtype=torch.int32,
                           device=x.device)
        out = _sdpa(q, k, v, positions, kpos, scale, dtype, causal=False)
    elif cache is not None and "pt" in cache:
        # paged serving path: scatter through the page table, then the
        # paged decode kernel (on the card, int8 pages) or
        # the gathered view — element-identical to the dense cache — into
        # the same _sdpa the dense path runs
        cache = _write_paged(cache, k, v, positions, writes)
        if "pks" in cache and _card_route(cache["pk"], card_order):
            args = (cache["pk"], cache["pks"], cache["pv"], cache["pvs"],
                    cache["ppos"], cache["pt"])
            out = ops.paged_attention_decode_rows(
                q, *args, positions.to(torch.int32).contiguous(),
                scale=scale, window=window,
                split_hkv=cfg.n_kv_heads).to(dtype)
        else:
            kc, vc, kpos = _read_paged(cache, dtype)
            out = _sdpa(q, kc, vc, positions, kpos, scale, dtype, causal=True,
                        window=window, valid=kpos >= 0)
    elif cache is not None:
        cache = _write_cache(cache, k, v, positions, writes)
        if "k_s" in cache and _card_route(cache["k"], card_order):
            # serving hot path: the int8-KV decode kernel (one int8 pass
            # over the cache, in-register dequant), each row at its position
            args = (cache["k"], cache["k_s"], cache["v"], cache["v_s"],
                    cache["pos_ids"])
            out = ops.decode_attention_int8kv_rows(
                q, *args, positions.to(torch.int32).contiguous(),
                scale=scale, window=window,
                split_hkv=cfg.n_kv_heads).to(dtype)
        else:
            kc, vc = _read_cache(cache, dtype)              # (B,S,Hkv,D)
            kpos = cache["pos_ids"]
            out = _sdpa(q, kc, vc, positions, kpos, scale, dtype, causal=True,
                        window=window, valid=kpos >= 0)
    elif mode.integer and window == 0:
        # no-cache forward (scoring, lm_loss, calibration), integer path
        out = _int_attention(q, k, v)
    elif (q.is_cuda or card_order) and window == 0 and t % 8 == 0:
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            scale=scale).transpose(1, 2)
    else:
        out = _sdpa(q, k, v, positions, positions, scale, dtype, causal=True,
                    window=window)
    out = out.to(dtype).reshape(b, t, -1)
    # the residual add rides the out-projection (integer path: fused GEMM
    # epilogue — the projection output never round-trips before the skip).
    # Under serving TP this is the collective boundary: ``out`` is
    # head-sharded, wo is replicated, and dist/tp.py rebuilds full rows
    # (barrier all-gather, or the all-to-all token split) first
    out = tp_out_projection(
        out, residual,
        lambda h, res: apply_linear(h, params.wo, mode, residual=res))
    return out, cache

"""Tile choices of the port's kernels: a measured cache over table rules
(port of ``repro.kernels.autotune``).

Every launch whose C entry takes a free tiling asks a chooser here for it.
The order, as in the reference (``autotune.py:40-103``):

  1. **Measured cache**: a JSON file of choices timed on this machine
     (``REPRO_AUTOTUNE_CACHE``, default ``.autotune/measured.json`` at the
     repo root, which the reference reads too).  ``measure`` times
     candidates and ``record`` keeps the fastest; an exact key hit wins.
     A hit that is not one of the shape's candidates (an entry from
     another build) is ignored, so a launch never asks for an
     instantiation the ``.cu`` files do not compile.
  2. **The table**: the rule each kernel launched with before the cache
     existed, tuned on the card (PERF.md §6).  No cache, no change.

The families, the reference's names where the family is the same:

  gemm_blocks            int8_gemm (W8, one stream)         -> MmaTiling
  gated_mlp_blocks       dual_gemm_gated, int8 and bf16     -> MmaTiling
  gemm_w4a8_blocks       int4_gemm                          -> MmaTiling
  gatedmlp_w4a8_blocks   dual_int4_gemm_gated               -> MmaTiling
  bf16_gemm_blocks       bf16_gemm (the port's float linear) -> Bf16Tiling
  decode_blocks          B7/B8's cache split                -> (n_split, chunk)

Each candidate set is the instantiations the C entries compile
(``MMA_CONFIGS``, ``BF16_GEMM_TILINGS``) times the splits of K the
integer forms may take (any split is exact there: int32 partials).  The
gates the card holds them to: an integer form's output is ``torch.equal``
under every candidate; a bf16 form never splits K (C20), and its
candidates give the same bits; the decode split changes the f32 combine's
order, so its key holds no row count and no tensor-parallel rank (the
blocks are B x the full Hkv, ``launch_rows``' ``split_hkv``): the T = 1
and multi-row launches, the dense and paged kernels and every TP rank
read one entry.

Hopper tile costs (``core.costmodel``: waves, bytes at the rate the
blocks in flight draw, L2 reuse, the split-K combine, ring fill and
epilogue) take the place of the reference's TPU tile costs.  Their argmin
over the same candidates does not give today's table at every shape of
PERF.md §6 (``scripts/autotune_table.py`` lists where they part), and the
costs are not fitted to the card's times, so no launch reads them: the
table keeps the rules, which were measured.  The families with nothing to
tune: the reference's
``packed_blocks`` and ``paged_blocks`` choose Pallas blocks for attention
the port leaves to plain PyTorch (``models/attention.py``'s ``_sdpa``);
``attention_blocks`` and ``attention_pv_blocks``: B12 and B11 run fixed
tiles (``csrc/flash_attention.cu``, ``csrc/int8_flash_attention.cu``);
``rowwise_blocks`` and ``elementwise_blocks``: the row and elementwise
kernels take a row (or a warp a row) a block by the row's length alone.
``moe_group_size`` and ``tp_serving_overlap`` are tables only
(``core.costmodel``'s copies of the reference's rules): the port measures
neither, and a ``moe/...`` entry in the shared file is the reference's,
timed under JAX — the group size sets capacity and dropped tokens, so
reading it would change the port's outputs.
"""
from __future__ import annotations

import functools
import json
import os
from typing import NamedTuple

from ..core import costmodel
from .common import cdiv

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def cache_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(_REPO_ROOT, ".autotune", "measured.json"))


_MEASURED: dict[str, dict] | None = None


def _measured() -> dict:
    global _MEASURED
    if _MEASURED is None:
        try:
            with open(cache_path()) as f:
                _MEASURED = json.load(f)
        except (OSError, ValueError):
            _MEASURED = {}
    return _MEASURED


def record(key: str, blocks, us: float) -> None:
    """Persist a measured (key -> blocks) entry; keeps the fastest."""
    cache = _measured()
    prev = cache.get(key)
    if prev is not None and prev.get("us", float("inf")) <= us:
        return
    cache[key] = {"blocks": list(blocks), "us": us}
    path = cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _clear_choosers()


def _clear_choosers() -> None:
    for fn in (gemm_blocks, gated_mlp_blocks, gemm_w4a8_blocks,
               gatedmlp_w4a8_blocks, bf16_gemm_blocks, decode_blocks):
        fn.cache_clear()


def reset_measured_cache() -> None:
    """Drop the in-process view of the measured cache (tests/env changes)."""
    global _MEASURED
    _MEASURED = None
    _clear_choosers()


def measure(key: str, candidates, timer) -> tuple[int, ...]:
    """Time ``timer(blocks) -> us`` over candidates, record + return best."""
    best, best_us = None, float("inf")
    for blocks in candidates:
        us = timer(blocks)
        if us < best_us:
            best, best_us = tuple(blocks), us
    assert best is not None, "no candidates"
    record(key, best, best_us)
    return best


def _hit(key: str):
    ent = _measured().get(key)
    return tuple(ent["blocks"]) if ent else None


# ---------------------------------------------------------------------------
# the tensor-core GEMM loop (csrc/gemm_mma.cuh): int8_gemm, int4_gemm and
# the gated dual GEMMs
# ---------------------------------------------------------------------------

# K per stage of each weight kind (W4 packed int4, W8 int8, BF16), stages in
# the ring, and the rows of a weight stage (an integer kind's stage holds 64
# rows of 128 bytes of each stream: W4 BK/2 packed rows, W8 BK)
W4_BK, W8_BK, BF16_BK = 128, 64, 64
W4_STAGES, MMA_STAGE_ROWS = 4, 64
# every launched instantiation: (kind, streams, bm) -> (bn, blocks an SM
# that ``__launch_bounds__`` asks for)
MMA_CONFIGS = {("w4", 1, 16): (128, 1), ("w4", 1, 64): (128, 2),
               ("w4", 2, 16): (128, 1), ("w4", 2, 32): (128, 2),
               ("w8", 1, 16): (128, 1), ("w8", 1, 64): (128, 2),
               ("w8", 1, 128): (128, 1),
               ("w8", 2, 16): (128, 1), ("w8", 2, 64): (128, 2),
               ("bf16", 2, 16): (64, 1), ("bf16", 2, 64): (128, 1),
               ("bf16", 2, 128): (128, 1),
               ("bf16", 1, 16): (64, 1), ("bf16", 1, 64): (128, 1),
               ("bf16", 1, 128): (128, 1)}
# the table's rows at or below which the decode shapes run (int4_gemm and
# int8_gemm: one block over all rows of a bucket-64 step ran slower than
# four 16-row blocks; the dual GEMMs: 64-row blocks won at M = 64), and the
# weight bytes each SM should have in flight there
W4_DECODE_M, W4_INFLIGHT = 64, costmodel.INFLIGHT_PER_SM
DUAL_DECODE_M = 32
# int8_gemm's tiles, from both tilings timed at starcoder2-3b's and
# codeqwen1.5-7b's projections on an H100 (``scripts/chip_probe.py tiles``):
# 16-row decode blocks up to M = 64 while the weight fits W8_DECODE_BYTES
# (they read it once per 16 rows: at M = 64, 0.029 against 0.049 ms for
# starcoder's q_proj, 0.072 against 0.079 for codeqwen's 55 MB mlp_down),
# else 64-row blocks from the first row (codeqwen's 378 MB head: 0.204
# against 0.569 ms at M = 64); 128 x 128 blocks (one an SM) where K >=
# W8_WIDE_K at M >= W8_WIDE_M (the down projections at M = 4096: 0.617
# against 0.770 ms, 0.877 against 1.142; 64 x 128 won for K <= 4096 and at
# M = 256)
W8_DECODE_M, W8_DECODE_BYTES = 64, 64 << 20
W8_WIDE_K, W8_WIDE_M = 8192, 1024


class MmaTiling(NamedTuple):
    """One launch of ``gemm_mma.cuh``: block rows (16: the decode shape; 32,
    64 or 128: the prefill shapes) and columns, the split of K and each
    block's K range, the output tiles (split-K counters) and the int32
    workspace the split needs ([streams][M][N])."""
    bm: int
    bn: int
    split: int
    k_len: int
    tiles: int
    workspace: int


def split_k(m: int, n: int, k: int, n_sm: int, align: int = W8_BK, *,
            bm: int = 64, bn: int = 128,
            want: int | None = None) -> tuple[int, int]:
    """(split, k_len): split K across blocks of ``bm`` x ``bn`` output (by
    default the prefill tile of the tensor-core loop) until about ``want``
    blocks are in flight (default: two per SM); k_len is a multiple of
    ``align`` (a stage's K, or the W4 group when larger) and every split is
    non-empty."""
    tiles = cdiv(m, bm) * cdiv(n, bn)
    steps = cdiv(k, align)
    split = max(1, min(steps, cdiv(2 * n_sm if want is None else want, tiles)))
    k_len = cdiv(steps, split) * align
    return cdiv(k, k_len), k_len


def _tiling(m: int, n: int, k: int, bm: int, bn: int, split: int,
            k_len: int, streams: int) -> MmaTiling:
    return MmaTiling(bm, bn, split, k_len, cdiv(m, bm) * cdiv(n, bn),
                     streams * m * n if split > 1 else 0)


def _mma_table(m: int, n: int, k: int, align: int, n_sm: int,
               streams: int = 1, decode_m: int = W4_DECODE_M,
               prefill_bm: int = 64) -> MmaTiling:
    """The table's tile and split of an integer GEMM [m, k] x ``streams``
    weights [k, n].  Decode (m <= ``decode_m``): blocks of 16 rows x 128
    columns, K split until each SM has about ``W4_INFLIGHT`` bytes of
    weight in flight ((W4_STAGES - 1) stages of a block's [MMA_STAGE_ROWS,
    128] tile of every stream); prefill: ``prefill_bm`` x 128, K split only
    until each SM has two blocks."""
    decode = m <= decode_m
    bm, bn = (16 if decode else prefill_bm), 128
    in_flight = (W4_STAGES - 1) * MMA_STAGE_ROWS * bn * streams
    want = cdiv(W4_INFLIGHT, in_flight) * n_sm if decode else 2 * n_sm
    split, k_len = split_k(m, n, k, n_sm, align, bm=bm, bn=bn, want=want)
    return _tiling(m, n, k, bm, bn, split, k_len, streams)


def _w8_table(m: int, n: int, k: int, n_sm: int, streams: int) -> MmaTiling:
    """int8_gemm (one stream: decode up to W8_DECODE_M where the weight
    fits W8_DECODE_BYTES, prefill blocks of 64 rows, or 128 at deep K and
    scoring rows) and dual_gemm_gated's int8 form (two: decode up to
    DUAL_DECODE_M); K ranges on multiples of W8_BK."""
    if streams == 2:
        return _mma_table(m, n, k, W8_BK, n_sm, 2, DUAL_DECODE_M)
    wide = k >= W8_WIDE_K and m >= W8_WIDE_M
    return _mma_table(m, n, k, W8_BK, n_sm, 1,
                      W8_DECODE_M if k * n <= W8_DECODE_BYTES else 0,
                      128 if wide else 64)


def _w4_table(m: int, n: int, k: int, g: int, n_sm: int,
              streams: int) -> MmaTiling:
    """int4_gemm (one stream: decode up to M = 64, prefill blocks of 64
    rows) and dual_int4_gemm_gated (two: decode up to DUAL_DECODE_M,
    prefill blocks of 32 rows): K ranges on multiples of max(W4_BK, g), so
    they start and end on group boundaries."""
    if streams == 1:
        return _mma_table(m, n, k, max(W4_BK, g), n_sm)
    return _mma_table(m, n, k, max(W4_BK, g), n_sm, 2, DUAL_DECODE_M, 32)


def _bf16_dual_table(m: int, n: int, k: int) -> MmaTiling:
    """dual_gemm_gated's bf16 form: never a split of K (f32 sums would
    depend on the blocks' arrival order), so its decode blocks (up to
    DUAL_DECODE_M) are 16 x 64 (210 at N = 13440 for 132 SMs); then 64 x 128
    up to M = 128 and 128 x 128 past it."""
    bm = 16 if m <= DUAL_DECODE_M else 64 if m <= 128 else 128
    return _tiling(m, n, k, bm, MMA_CONFIGS[("bf16", 2, bm)][0], 1, k, 2)


def mma_candidates(kind: str, streams: int, m: int, k: int, n: int,
                   n_sm: int, group: int = 0) -> list[MmaTiling]:
    """Every tiling the C entry takes at this shape: each instantiated block
    shape of the kind, unsplit, and for the integer kinds split until about
    one, two or four blocks an SM are in flight (K ranges on multiples of a
    stage, or of the W4 group when larger); the bf16 kind never splits."""
    align = max(W4_BK, group) if kind == "w4" else W8_BK
    out = []
    for (kd, st, bm), (bn, _) in MMA_CONFIGS.items():
        if kd != kind or st != streams:
            continue
        if kind == "bf16":
            out.append(_tiling(m, n, k, bm, bn, 1, k, streams))
            continue
        splits = [split_k(m, n, k, n_sm, align, bm=bm, bn=bn, want=w)
                  for w in (1, n_sm, 2 * n_sm, 4 * n_sm)]
        out += [_tiling(m, n, k, bm, bn, split, k_len, streams)
                for split, k_len in dict.fromkeys(splits)]
    return out


def _mma_choice(key: str, table: MmaTiling, kind: str, streams: int, m: int,
                k: int, n: int, n_sm: int, group: int = 0) -> MmaTiling:
    hit = _hit(key)
    if hit:
        for t in mma_candidates(kind, streams, m, k, n, n_sm, group):
            if (t.bm, t.bn, t.split, t.k_len) == hit:
                return t
    return table


def mma_key(family: str, m: int, k: int, n: int, tag: str,
            n_sm: int) -> str:
    """The measured cache's key of a tensor-core GEMM launch: ``family`` as
    the chooser's (gemm, gatedmlp, gemm_w4a8, gatedmlp_w4a8), ``tag`` the
    weight's dtype or W4 group."""
    return f"{family}/{m}x{k}x{n}/{tag}/cuda/sm{n_sm}"


@functools.lru_cache(maxsize=4096)
def gemm_blocks(m: int, k: int, n: int, n_sm: int) -> MmaTiling:
    """int8_gemm's tiling of [m, k] x [k, n] on ``n_sm`` SMs (an
    expert-batched launch's share of them)."""
    return _mma_choice(mma_key("gemm", m, k, n, "int8", n_sm),
                       _w8_table(m, n, k, n_sm, 1), "w8", 1, m, k, n, n_sm)


@functools.lru_cache(maxsize=4096)
def gated_mlp_blocks(m: int, k: int, n: int, dtype: str,
                     n_sm: int) -> MmaTiling:
    """dual_gemm_gated's tiling ("int8" or "bf16" weights)."""
    kind = "w8" if dtype == "int8" else "bf16"
    table = (_w8_table(m, n, k, n_sm, 2) if kind == "w8"
             else _bf16_dual_table(m, n, k))
    return _mma_choice(mma_key("gatedmlp", m, k, n, dtype, n_sm), table,
                       kind, 2, m, k, n, n_sm)


@functools.lru_cache(maxsize=4096)
def gemm_w4a8_blocks(m: int, k: int, n: int, group: int,
                     n_sm: int) -> MmaTiling:
    """int4_gemm's tiling at scale group ``group``."""
    return _mma_choice(mma_key("gemm_w4a8", m, k, n, f"g{group}", n_sm),
                       _w4_table(m, n, k, group, n_sm, 1), "w4", 1, m, k, n,
                       n_sm, group)


@functools.lru_cache(maxsize=4096)
def gatedmlp_w4a8_blocks(m: int, k: int, n: int, group: int,
                         n_sm: int) -> MmaTiling:
    """dual_int4_gemm_gated's tiling at scale group ``group``."""
    return _mma_choice(mma_key("gatedmlp_w4a8", m, k, n, f"g{group}", n_sm),
                       _w4_table(m, n, k, group, n_sm, 2), "w4", 2, m, k, n,
                       n_sm, group)


# ---------------------------------------------------------------------------
# bf16_gemm (csrc/bf16_gemm.cu: TMA + wgmma, K never split)
# ---------------------------------------------------------------------------

BF16_DECODE_M = 64        # rows up to which one 64-row block covers M
BF16_INFLIGHT = 32 << 10  # weight bytes a decode block keeps in flight


class Bf16Tiling(NamedTuple):
    """One launch: block rows (64 per consumer warpgroup) and columns (the
    ``wgmma`` width), the ring's stages, the rows of x a stage holds (bm,
    or 8 for M <= 8), each block's K range (all of K: never split) and the
    blocks."""
    bm: int
    bn: int
    stages: int
    x_rows: int
    k_len: int
    blocks: int


# (bm, bn, stages, x_rows) the C entry takes: M <= 8's two and decode's two
# (two blocks an SM), then the wider ones (one block an SM)
BF16_GEMM_TILINGS = ((64, 32, 20, 8), (64, 64, 12, 8), (64, 32, 9, 64),
                     (64, 64, 6, 64), (64, 128, 6, 64), (128, 128, 6, 128),
                     (128, 256, 4, 128))
# the wide tiles' rates relative to 128 x 256's where the waves are whole
# (``scripts/bf16_tilings.py`` on an H100: 128 x 128 0.79-0.80, 64 x 128
# 0.70)
BF16_WIDE_RATES = {(128, 256): 1.0, (128, 128): 0.8, (64, 128): 0.7}


def _bf16(m: int, n: int, k: int, bm: int, bn: int, stages: int,
          x_rows: int) -> Bf16Tiling:
    return Bf16Tiling(bm, bn, stages, x_rows, k, cdiv(m, bm) * cdiv(n, bn))


def bf16_gemm_candidates(m: int, k: int, n: int) -> list[Bf16Tiling]:
    """Every tiling the entry takes at this shape (the 8-row ones only for
    M <= 8): each gives the same bits (chip_smoke phase 3 holds them
    equal)."""
    return [_bf16(m, n, k, *t) for t in BF16_GEMM_TILINGS
            if m <= t[3] or t[3] == t[0]]


def _bf16_gemm_table(m: int, n: int, k: int, n_sm: int) -> Bf16Tiling:
    """Decode rows (m <= BF16_DECODE_M): 64 x 64 blocks where they fill the
    SMs, else 64 x 32 (two blocks an SM either way), over a ring of 1 KB of
    x and the weight a stage for m <= 8.  Past that the wide tiling whose
    waves (blocks / n_sm, rounded up) of tiles cost least at its rate
    (``BF16_WIDE_RATES``): 128 x 256 where the waves come out
    whole, 128 x 128 or 64 x 128 where the wider tile would leave SMs
    idle."""
    t = BF16_GEMM_TILINGS
    if m <= BF16_DECODE_M:
        narrow, wide = t[:2] if m <= 8 else t[2:4]
        return _bf16(m, n, k, *(wide if cdiv(n, 64) >= n_sm else narrow))

    def cost(tl):
        bm, bn = tl[:2]
        return (cdiv(cdiv(m, bm) * cdiv(n, bn), n_sm) * bm * bn
                / BF16_WIDE_RATES[(bm, bn)])
    return _bf16(m, n, k, *min((t[6], t[5], t[4]), key=cost))


def bf16_gemm_key(m: int, k: int, n: int, n_sm: int) -> str:
    return f"bf16_gemm/{m}x{k}x{n}/cuda/sm{n_sm}"


@functools.lru_cache(maxsize=4096)
def bf16_gemm_blocks(m: int, k: int, n: int, n_sm: int) -> Bf16Tiling:
    """bf16_gemm's tiling of [m, k] x [k, n] (K and N already padded to
    multiples of 8)."""
    hit = _hit(bf16_gemm_key(m, k, n, n_sm))
    if hit:
        for t in bf16_gemm_candidates(m, k, n):
            if t[:4] == hit:
                return t
    return _bf16_gemm_table(m, n, k, n_sm)


# ---------------------------------------------------------------------------
# the decode attention's cache split (csrc/decode_tile.cuh: B7 and B8)
# ---------------------------------------------------------------------------

DECODE_BS = 32  # keys per tile of the decode kernels


def _kv_split(blocks: int, s: int, n_split: int) -> tuple[int, int]:
    """(n_split, chunk) with chunks of whole DECODE_BS-key tiles, every
    chunk non-empty."""
    tiles = cdiv(s, DECODE_BS)
    n_split = max(1, min(tiles, n_split))
    chunk = cdiv(tiles, n_split) * DECODE_BS
    return cdiv(s, chunk), chunk


def decode_candidates(blocks: int, s: int, n_sm: int) -> list[tuple]:
    """The splits the decode entry takes: none, and splits until about one,
    two or four blocks an SM are in flight."""
    return list(dict.fromkeys(
        [_kv_split(blocks, s, 1)]
        + [_kv_split(blocks, s, cdiv(w, blocks))
           for w in (n_sm, 2 * n_sm, 4 * n_sm)]))


def decode_key(blocks: int, s: int, d: int, g: int, n_sm: int) -> str:
    """No row count, no tensor-parallel rank (module note)."""
    return f"decode/{blocks}x{s}x{d}x{g}/cuda/sm{n_sm}"


@functools.lru_cache(maxsize=4096)
def decode_blocks(blocks: int, s: int, d: int, g: int,
                  n_sm: int) -> tuple[int, int]:
    """(n_split, chunk) of the decode kernels over ``blocks`` = B x Hkv (the
    full Hkv on a TP rank) and an ``s``-slot cache of head dim ``d``, ``g``
    query heads a kv head.  Table: split the cache into chunks of whole
    tiles until about two blocks per SM are in flight.  Neither the key nor
    the table reads a row count or a rank."""
    hit = _hit(decode_key(blocks, s, d, g, n_sm))
    if hit and hit in decode_candidates(blocks, s, n_sm):
        return hit
    return _kv_split(blocks, s, cdiv(2 * n_sm, blocks))


# ---------------------------------------------------------------------------
# the reference's MoE group-size and TP boundary tables
# ---------------------------------------------------------------------------

# GShard group-size candidates for the MoE dispatch (tokens per group)
_MOE_GROUP_CANDIDATES = (128, 256, 512, 1024, 2048, 4096, 8192)


@functools.lru_cache(maxsize=4096)
def moe_group_size(t: int, d: int, ff: int, e: int, k: int,
                   capacity_factor: float) -> int:
    """Tokens per GShard dispatch group for a ``t``-token MoE forward: the
    cost model's argmin over the candidates that divide ``t`` (one
    whole-batch group when none does)."""
    cands = [sg for sg in _MOE_GROUP_CANDIDATES
             if sg <= t and t % sg == 0] or [t]
    best, best_cost = cands[0], float("inf")
    for sg in cands:
        c = costmodel.moe_dispatch_cost(t, d, ff, e, k, capacity_factor, sg)
        if c < best_cost:
            best, best_cost = sg, c
    return best


@functools.lru_cache(maxsize=4096)
def tp_serving_overlap(rows: int, d_model: int, d_ff: int, heads_dim: int,
                       tp: int) -> str:
    """``"overlap"`` or ``"barrier"`` for the serving-TP row-GEMM boundary
    (``dist/tp.py``) of a step with ``rows`` packed tokens: the sum of the
    two boundaries a block crosses (attention out: heads dim -> d_model; MLP out: d_ff ->
    d_model) under each variant by ``costmodel.tp_boundary_cost``, the
    cheaper one."""
    if tp <= 1:
        return "barrier"

    def total(overlap: bool) -> float:
        return (costmodel.tp_boundary_cost(rows, heads_dim, d_model, tp,
                                           overlap)
                + costmodel.tp_boundary_cost(rows, d_ff, d_model, tp,
                                             overlap))

    return "overlap" if total(True) < total(False) else "barrier"

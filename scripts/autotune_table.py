#!/usr/bin/env python3
"""The port's tile tables at the served shapes of PERF.md §6, and where the
Hopper tile costs' argmin parts from them.

For each family of ``kernels/autotune.py`` it prints how many served
shapes the cost model's argmin over the candidates agrees with the
table at, and with ``-v`` each shape where they part, with both estimates.
Arithmetic on the CPU only: no card, no measured cache.

    PYTHONPATH=src python3 scripts/autotune_table.py [-v]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

SMS = 132
ROWS = (8, 64, 256, 4096)
# PERF.md §6's shapes: (m, k, n) with the W4 group and the experts of an
# expert-batched launch (its n_sm is an E-th of the card's)
INT8_GEMM = [(m, k, n, 1) for k, n, rows in (
    (3072, 3072, ROWS), (3072, 256, ROWS), (3072, 12288, ROWS),
    (12288, 3072, ROWS), (3072, 49152, (8, 256)), (4096, 4096, ROWS),
    (13440, 4096, ROWS), (4096, 92416, ROWS), (100, 70, (5, 37)),
    (6144, 6144, (8, 256, 4096)), (6144, 1024, (8, 256, 4096)),
    (16384, 6144, (8, 256, 4096)), (6144, 92544, (8, 256, 4096)),
    (7168, 64000, (8, 256, 4096)), (20480, 7168, (8, 256, 4096)),
    (2048, 8, (8, 256, 4096)), (768, 768, (8, 6000, 12000)),
    (768, 3072, (8, 6000)), (3072, 768, (8, 6000)), (28672, 8192, (8, 256)),
    (8192, 128256, (8, 256)), (3072, 1536, (8, 2048)),
    (3072, 128, (8, 2048)), (3072, 6144, (8, 2048)), (3072, 3072, (4, 1024)),
    (12288, 3072, (4, 1024)), (64, 32, (32,))) for m in rows] + [
    (4, 1408, 2048, 60), (160, 1408, 2048, 60), (4, 14336, 4096, 8),
    (640, 14336, 4096, 8)]
INT4_GEMM = [(m, k, n, g, 1) for k, n, g, rows in (
    (4096, 4096, 64, ROWS), (13440, 4096, 64, ROWS),
    (3072, 12288, 64, (8, 256)), (2560, 10448, 64, (4096,)),
    (5120, 2560, 64, (4096,)), (2560, 10240, 64, (4096,)),
    (10240, 2560, 64, (4096,)), (96, 70, 32, (5, 37)),
    (4096, 4096, 32, (8, 256)), (13440, 4096, 32, (8, 256)),
    (4096, 4096, 128, (8, 256)), (13440, 4096, 128, (8, 256)),
    (7168, 7168, 64, (8, 256, 4096)), (7168, 1024, 64, (8, 256, 4096)),
    (2048, 8, 64, (8, 256, 4096)), (8192, 8192, 64, (8, 256)),
    (8192, 1024, 64, (8, 256, 12808)), (4096, 2048, 64, (8, 2048)),
    (4096, 1024, 64, (8, 2048)), (4096, 4096, 64, (4, 2, 1024, 512)),
    (13440, 4096, 64, (4, 2, 1024, 512))) for m in rows] + [
    (4, 14336, 4096, 64, 8), (640, 14336, 4096, 64, 8),
    (4, 1408, 2048, 64, 60), (160, 1408, 2048, 64, 60)]
DUAL_INT4 = [(m, k, n, g, 1) for k, n, g, rows in (
    (4096, 13440, 64, ROWS), (4096, 13440, 32, (8, 256)),
    (4096, 13440, 128, (8, 256)), (7168, 20480, 64, (8, 256, 4096)),
    (8192, 28672, 64, (8, 256)), (4096, 6720, 64, (8, 2048)),
    (4096, 3360, 64, (8, 2048)), (96, 70, 32, (5, 37))) for m in rows] + [
    (4, 4096, 14336, 64, 8), (640, 4096, 14336, 64, 8),
    (4, 2048, 1408, 64, 60), (160, 2048, 1408, 64, 60)]
DUAL_INT8 = ([(m, 4096, 13440, 1) for m in ROWS]
             + [(m, 6144, 16384, 1) for m in (8, 256, 4096)]
             + [(m, 96, 70, 1) for m in (5, 37)]
             + [(4, 2048, 1408, 60), (160, 2048, 1408, 60),
                (4, 4096, 14336, 8), (640, 4096, 14336, 8)])
DUAL_BF16 = ([(m, 4096, 13440, 1) for m in ROWS]
             + [(m, 96, 70, 1) for m in (5, 37)]
             + [(4, 4096, 14336, 8), (640, 4096, 14336, 8),
                (4, 2048, 1408, 60), (160, 2048, 1408, 60),
                (1280, 4096, 14336, 8), (320, 2048, 1408, 60),
                (8, 4096, 6720, 1), (2048, 4096, 6720, 1)])
# bf16_gemm: codeqwen's and starcoder's linears, their tp 2 / 4 column
# shards and row blocks, and the padded ragged N and K
BF16_GEMM = [(m, k, n) for k, n0 in (
    (4096, 4096), (13440, 4096), (3072, 3072), (3072, 256), (3072, 12288),
    (12288, 3072)) for m0 in ROWS for m, n in (
    (m0, n0), (m0, n0 // 2), (m0, n0 // 4), (m0 // 2, n0), (m0 // 4, n0))
] + [(8, 768, 51872), (256, 768, 51872), (8, 776, 768), (256, 776, 768)]
# the decode split: (B x the full Hkv, cache slots, head dim, G)
DECODE = [(256, 1024, 128, 1), (256, 1024, 128, 1), (16, 1024, 128, 12),
          (64, 4352, 128, 4), (64, 1024, 128, 6), (64, 1024, 128, 7),
          (96, 1024, 64, 1), (64, 1024, 128, 8), (64, 8192, 128, 4),
          (8, 1024, 128, 12)]


def _sm(e: int) -> int:
    return -(-SMS // e)


def families():
    """(family, shape, table's choice, model's choice, estimate fn) at every
    served shape, with no measured cache: the model's choice is the Hopper
    tile costs' argmin over the shape's candidates."""
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import autotune as at

    def mma(kind, streams, m, k, n, s, g=0):
        def est(t):
            return cm.mma_gemm_tile_cost(
                m, k, n, kind, streams, t.bm, t.bn, t.split, t.k_len,
                at.MMA_CONFIGS[(kind, streams, t.bm)][1], g, s)
        return min(at.mma_candidates(kind, streams, m, k, n, s, g),
                   key=est), est

    for m, k, n, e in INT8_GEMM:
        yield ("gemm_blocks", (m, k, n, e), at.gemm_blocks(m, k, n, _sm(e)),
               *mma("w8", 1, m, k, n, _sm(e)))
    for m, k, n, e in DUAL_INT8:
        yield ("gated_mlp_blocks int8", (m, k, n, e),
               at.gated_mlp_blocks(m, k, n, "int8", _sm(e)),
               *mma("w8", 2, m, k, n, _sm(e)))
    for m, k, n, e in DUAL_BF16:
        yield ("gated_mlp_blocks bf16", (m, k, n, e),
               at.gated_mlp_blocks(m, k, n, "bf16", _sm(e)),
               *mma("bf16", 2, m, k, n, _sm(e)))
    for m, k, n, g, e in INT4_GEMM:
        yield ("gemm_w4a8_blocks", (m, k, n, g, e),
               at.gemm_w4a8_blocks(m, k, n, g, _sm(e)),
               *mma("w4", 1, m, k, n, _sm(e), g))
    for m, k, n, g, e in DUAL_INT4:
        yield ("gatedmlp_w4a8_blocks", (m, k, n, g, e),
               at.gatedmlp_w4a8_blocks(m, k, n, g, _sm(e)),
               *mma("w4", 2, m, k, n, _sm(e), g))
    for m, k, n in BF16_GEMM:
        def est(t, m=m, k=k, n=n):
            return cm.bf16_gemm_tile_cost(
                m, k, n, *t[:4], SMS,
                rate=at.BF16_WIDE_RATES.get(t[:2], 1.0))
        yield ("bf16_gemm_blocks", (m, k, n), at.bf16_gemm_blocks(m, k, n, SMS),
               min(at.bf16_gemm_candidates(m, k, n), key=est), est)
    for b, s, d, g in DECODE:
        def est(c, b=b, s=s, d=d, g=g):
            return cm.decode_split_cost(b, s, d, g, *c, SMS)
        yield ("decode_blocks", (b, s, d, g), at.decode_blocks(b, s, d, g, SMS),
               min(at.decode_candidates(b, s, SMS), key=est), est)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-v", action="store_true", help="list each parting shape")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "none.json")
        from repro_torch.kernels import autotune as at
        at.reset_measured_cache()
        tally: dict[str, list[int]] = {}
        for fam, shape, table, model, est in families():
            agree = model == table
            tally.setdefault(fam, [0, 0])
            tally[fam][0] += agree
            tally[fam][1] += 1
            if args.v and not agree:
                print(f"  {fam} {shape}: table {tuple(table)[:4]} "
                      f"{est(table) * 1e6:.1f} us, model {tuple(model)[:4]} "
                      f"{est(model) * 1e6:.1f} us")
    for fam, (agree, total) in tally.items():
        print(f"{fam}: the model's argmin is the table's at {agree} of "
              f"{total} served shapes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time every tiling of the port's bf16_gemm (``autotune.BF16_GEMM_TILINGS``)
at a few shapes on one NVIDIA card, beside the tiling
``autotune.bf16_gemm_blocks`` picks: the data behind
``autotune.BF16_WIDE_RATES``.  Each launch's output is held
``torch.equal`` to the rule's (the one K order), and the times are CUDA
events around one launch with a cold L2 (chip_smoke's ``Timer``).

    python3 scripts/bf16_tilings.py            # the default shapes
    python3 scripts/bf16_tilings.py 4096x4096x4096 8x4096x4096
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
SHAPES = ("4096x4096x4096", "4096x3072x12288", "256x4096x4096",
          "8x4096x4096")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("shapes", nargs="*", default=SHAPES,
                    help="MxKxN, x [M, K] @ w [K, N]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_tilings: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import bf16_gemm as bg
    from repro_torch.kernels.int8_gemm import _n_sm
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in args.shapes:
        m, k, n = (int(v) for v in shape.split("x"))
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
             ).bfloat16()
        rule = at.bf16_gemm_blocks(m, k, n, _n_sm(dev))
        want = bg._launch(x, w, None, rule)
        times = {}
        for tl in at.bf16_gemm_candidates(m, k, n):
            if not torch.equal(bg._launch(x, w, None, tl), want):
                raise AssertionError(f"{shape}: tiling {tl[:4]} differs")
            times[tl[:4]] = timer(lambda: bg._launch(x, w, None, tl))
        best = min(times.values())
        for t, ms in times.items():
            print(f"[{m},{k}]x[{k},{n}] bm {t[0]} bn {t[1]} stages {t[2]} "
                  f"x_rows {t[3]}: {ms:.4f} ms, rate {best / ms:.2f}"
                  + ("  <- the rule's" if t == rule[:4] else ""))
        del x, w, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

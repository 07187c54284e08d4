#!/usr/bin/env python3
"""The router's top-k margins of chip_smoke's reduced MoE training check,
seed by seed, on one NVIDIA card and on the CPU.

For mixtral-8x7b and qwen2-moe-a2.7b at their reduced configs, each seed
builds chip_smoke's ``reduced_tree`` and runs the training loss's forward
(``reduced_train_loss``) three ways: on the card (the kernels), on the CPU
in the card's order and on the CPU in its own order.  For each it prints
the least gap between any token's k-th and (k+1)-th router probabilities
over every MoE layer, and whether each of the two CPU runs routes every
token as the card does.  chip_smoke calls a gap below ``NEAR_TIE`` a
near-tie (ROADMAP C12) and skips that seed; elsewhere it requires the
card's choices.

Usage:  python3 scripts/router_gaps.py [--seeds 0 1 2 3]
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCHS = ("mixtral-8x7b", "qwen2-moe-a2.7b")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("router_gaps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.convert import from_reference
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build_all(("flash_attention", "dual_gemm_gated"))
    dev = torch.device("cuda", 0)
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        for seed in args.seeds:
            tree, (tok, lab, feats) = cs.reduced_tree(cfg, seed)
            runs = {name: cs.routing(lambda: cs.reduced_train_loss(
                        from_reference(tree, cfg, where), cfg,
                        tok.to(where), lab.to(where), feats, order))
                    for name, where, order in (("card", dev, False),
                                               ("cpu_card_order", "cpu", True),
                                               ("cpu_own_order", "cpu", False))}
            card = runs["card"][1]
            same = {name: all(torch.equal(a, b) for a, b in zip(ch, card))
                    for name, (_, ch) in runs.items() if name != "card"}
            print(f"{arch}-reduced seed {seed}: least gaps "
                  + ", ".join(f"{name} {gap:.6f}"
                              for name, (gap, _) in runs.items())
                  + f" (NEAR_TIE {cs.NEAR_TIE}); routes as the card: "
                  + ", ".join(f"{name} {v}" for name, v in same.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

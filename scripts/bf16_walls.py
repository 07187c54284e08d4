#!/usr/bin/env python3
"""The walls of the port's bf16 paths on one NVIDIA card, for one tree of
the port (``--src``): what the bf16 float linears cost, through
``torch.matmul`` or through bf16_gemm.

* chip_smoke phase 6's bf16 ``lm_loss``: codeqwen1.5-7b and starcoder2-3b
  at full width and depth, 4 x 1024 tokens, three forwards each (the
  first warms up);
* phases 7 and 8's training step ms: each path of ``TRAIN_PATHS`` and
  ``TRAIN_ARCH_PATHS`` for 4 steps (median of steps 3-4), unprofiled, the
  loss not required to fall in 4 steps;
* phase 9's bf16 cell: codeqwen1.5-7b bf16, 32 layers, 8 x 16 dense at tp 1
  and at tp 2 (barrier, overlap; two ranks sharing the card over gloo),
  TPOT p50 and the token and forward-logit differences from tp 1 (reported,
  not required: a tree before bf16_gemm differs).

Every number is the host clock around work that ends in a synchronize,
beside the card's name and power limit.  Compare two trees in one call, in
turns (parent, change, change, parent), each with its own build
directory:

    python3 scripts/bf16_walls.py --src build/parent/src --out chiprun_out/p1.json
    python3 scripts/bf16_walls.py --out chiprun_out/n1.json
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
LM_ARCHS = ("codeqwen1.5-7b", "starcoder2-3b")
STEPS = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_walls: no CUDA device", file=sys.stderr)
        return 2
    src = str(args.src.resolve())
    sys.path.insert(0, src)
    # the spawned TP ranks import the same tree
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [src, str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "")
                            .split(os.pathsep) if p])
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi} | {src}", flush=True)
    build.build_all()
    dev = torch.device("cuda", 0)
    out = {"card": smi, "src": src, "lm_loss": {}, "train": {}}
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        params = init_params(cfg, seed=args.seed, device=dev)
        tokens = torch.from_numpy(np.random.default_rng(
            [args.seed, 5]).integers(2, cfg.vocab_size,
                                     size=(cs.NC_B, cs.NC_T))).to(dev)
        runs = [cs.no_cache_loss(params, cfg, dev, tokens, profiled=False)
                for _ in range(3)]
        out["lm_loss"][arch] = {"walls_s": [r["wall_s"] for r in runs],
                                "loss": runs[-1]["loss"]}
        print(f"{arch} bf16 lm_loss walls {out['lm_loss'][arch]}", flush=True)
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
    for arch, n_layers, b, t, _, _ in cs.TRAIN_PATHS + cs.TRAIN_ARCH_PATHS:
        r = cs.train_full(dev, args.seed, arch, n_layers, b, t, steps=STEPS,
                          falls=False, profiled=False)
        label = f"{arch}{'' if n_layers is None else f' {n_layers}L'}"
        out["train"][label] = {k: r[k] for k in ("step_ms", "step_ms_all",
                                                 "losses", "peak_mem_gib")}
        print(f"{label} train step ms {r['step_ms']:.1f} "
              f"({[round(x, 1) for x in r['step_ms_all']]})", flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    cs.TP_CELLS = tuple(dict(c, exact=False) for c in cs.TP_CELLS
                        if c["precision"] == "bf16")
    t0 = time.perf_counter()
    tp = cs.serve_tp(dev, args.seed)
    out["tp"] = {k: {f: v[f] for f in ("tokens_differ", "forwards_differ",
                                       "tp1", "generated_tok_per_s")
                     if f in v} | {"tpot_p50_ms": v["metrics"]["tpot_p50_ms"]}
                 for k, v in tp["drains"].items()}
    out["tp"]["step_logits"] = tp["step_logits"]
    out["tp_s"] = time.perf_counter() - t0
    print(json.dumps(out["tp"]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({"lm_loss": out["lm_loss"], "train": {
        k: v["step_ms"] for k, v in out["train"].items()}}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The losses of chip_smoke phase 7's full-width training runs under a few
AdamW schedules, on one NVIDIA card: starcoder2-3b (30 layers) and
codeqwen1.5-7b cut to 8 layers, seed 0, 8 steps of 4 x 1024
``TokenPipeline`` tokens, remat on, each schedule from a fresh
initialisation.  It shows how far Adam's first sign-like steps throw a
random full-width model at each peak learning rate, which is what picks
``chip_smoke.TRAIN_LR``.

Usage:  python3 scripts/train_lr_sweep.py
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (peak lr, warmup steps) of AdamWConfig(total_steps=8)
SCHEDULES = ((3e-4, 2), (1e-4, 2), (3e-5, 2), (3e-4, 5))
PATHS = (("starcoder2-3b", None), ("codeqwen1.5-7b", 8))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build_all(("flash_attention", "dual_gemm_gated"))
    dev = torch.device("cuda", 0)
    for arch, n_layers in PATHS:
        cfg = get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        for lr, warmup in SCHEDULES:
            params = init_params(cfg, seed=0, device=dev)
            tr = Trainer(cfg, TrainConfig(optimizer=AdamWConfig(
                lr=lr, warmup_steps=warmup, total_steps=8), log_every=100),
                params, device=dev)
            data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=1024, global_batch=4,
                                            seed=0))
            hist = tr.run(data, 8, log_fn=lambda s: None)
            data.close()
            print(f"{cfg.name} layers={cfg.n_layers} lr={lr:g} "
                  f"warmup={warmup}: losses "
                  f"{[round(h['loss'], 4) for h in hist]}", flush=True)
            del tr, params, hist
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

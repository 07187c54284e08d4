"""Training launcher of the port: config registry -> parameters -> data
pipeline -> Trainer loop -> checkpoints, with restore; on the card unless
``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch codeqwen1.5-7b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir CKPT [--resume]
  python -m repro_torch.launch.train --arch zamba2-2.7b --steps 8 \\
      --batch 4 --seq 1024          # full width on the card

Flags mirror ``repro.launch.train`` (``--device`` added, as in
``launch/serve.py``).  Training is the bf16 path, on the card for every
arch whose full-width training state fits it (zamba2-2.7b's ssd_scan and
the MoE archs' expert-batched gated GEMM launch inside their autograd
Functions, ``kernels.common.GRAD_KERNELS``); an integer precision raises.
As the reference's launcher, it trains ``lm_loss`` alone: an
encoder-decoder arch trains its decoder, a VLM its text path without
vision features.
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..data import DataConfig, TokenPipeline
from ..models import init_params
from ..train import AdamWConfig, CheckpointManager, TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    params = init_params(cfg, seed=args.seed, device=args.device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"batch={args.batch} seq={args.seq}")

    train_cfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                              total_steps=args.steps),
        accum_steps=args.accum,
        grad_compression=args.grad_compression,
        checkpoint_every=args.ckpt_every,
    )
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(cfg, train_cfg, params, ckpt_manager=ckpt,
                      device=args.device)

    start_step = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        step = ckpt.latest_step()
        meta = trainer.restore(step)
        trainer.step = start_step = step
        print(f"resumed from step {step} (arch={meta['arch']})")

    data = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed), start_step=start_step)
    history = trainer.run(data, args.steps - start_step)
    data.close()
    losses = [h["loss"] for h in history]
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"stragglers flagged: {trainer.watchdog.flagged}")


if __name__ == "__main__":
    main()

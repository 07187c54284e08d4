"""Serving launcher of the port: the continuous-batching engine (packed
token-budget forward; chunked and tokenwise schedules as fallbacks), on the
card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \\
      --w4a8 --int8-kv --requests 16 --max-new 32 --lanes 8 --max-seq 1024 \\
      --token-budget 256 [--paged --page-size 16 --pool-pages 0]

``--arch`` takes every arch of ``repro_torch.configs.ARCH_IDS``
(starcoder2-3b, codeqwen1.5-7b, internlm2-20b, yi-34b, zamba2-2.7b,
xlstm-350m, mixtral-8x7b, qwen2-moe-a2.7b, whisper-small,
llama-3.2-vision-90b; ``--reduced`` for the small same-family config).
llama-3.2-vision-90b's lanes cross-attend to stub vision tokens drawn from
``--seed`` (``frontend.vision_tokens_stub``).  As in the reference, the
launcher builds whisper-small's decoder alone and feeds it no encoder
output, so its cross-attention reads the zero cross K/V of
``init_states`` (ROADMAP C17); ``encode`` and the engine's ``kv_source``
serve it meaningfully.  ``--w8a8`` quantizes every
GEMM weight to int8; ``--w4a8`` applies the reference's default W4 policy
(attention and MLP projections — a MoE layer's experts too — packed int4
at group 64, the lm head int8), each block as it is built.  ``--token-budget 0 --prefill-chunk N`` serves
chunked (both 0: tokenwise; the recurrent archs, ``--arch zamba2-2.7b``
and ``--arch xlstm-350m``, always serve tokenwise).  ``--temperature T``
samples on the reference's threefry streams from ``--seed``; ``--spec-k K`` turns on self-speculation
(greedy engines only).  ``--stream-gap-ms G`` replays the requests through
``run_stream`` with exponential arrival gaps of mean G ms drawn from
``--seed`` and prints the serving metrics.  ``--paged`` serves from the
paged KV pool (prefix sharing, copy-on-write, preempt/swap under pressure)
and prints its pool line.  ``--tp N`` serves tensor-parallel: N ranks
(spawned processes) each build their shard a block at a time and run the
engine in one ``--tp-backend`` group (``launch/mesh.py``: ``gloo`` — every
rank on ``--device``, the CPU or one shared card — or ``nccl``, rank r on
``cuda:r``); rank 0 prints the ``tensor parallel:`` line and the stats, and
its tokens are the ``--tp 1`` tokens.  The kernels are built once, before
the ranks start.  Flags mirror ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import get_config
from ..dist.tp import validate_tp_serving
from ..kernels import build, ops
from ..models import init_params
from ..models.frontend import vision_tokens_stub
from ..serve import ServeConfig, ServingEngine
from .mesh import make_tp_mesh, run_ranks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--w8a8", action="store_true")
    ap.add_argument("--w4a8", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--token-budget", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=0)
    ap.add_argument("--queue-limit", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--tp-overlap", default="auto",
                    choices=("auto", "overlap", "barrier"))
    ap.add_argument("--tp-backend", default="gloo", choices=("gloo", "nccl"),
                    help="the TP group's transport: gloo (every rank on "
                    "--device) or nccl (rank r on cuda:r)")
    ap.add_argument("--stream-gap-ms", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs (default: the card)")
    args = ap.parse_args(argv)

    if args.w8a8 and args.w4a8:
        raise SystemExit("--w8a8 and --w4a8 are exclusive")
    if args.tp > 1:
        if args.tp_backend == "nccl" and args.device != "cuda":
            raise SystemExit("--tp-backend nccl puts rank r on cuda:r")
        validate_tp_serving(_config(args), args.tp)
        if args.device == "cuda":
            build.build_all()         # once, before the ranks
        run_ranks(_serve_rank, args.tp, args)
        return
    serve(args)


def _config(args):
    precision = "w4a8" if args.w4a8 else "w8a8" if args.w8a8 else "bf16"
    return get_config(args.arch, precision=precision, reduced=args.reduced)


def _serve_rank(rank: int, port: int, args) -> None:
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.tp))
    mesh = make_tp_mesh(args.tp, args.tp_backend, rank=rank, port=port,
                        device=None if args.tp_backend == "nccl"
                        else args.device)
    serve(args, mesh)


def serve(args, mesh=None) -> None:
    """Build the model (a rank's shard under ``mesh``), serve the requests,
    print the results (rank 0 only under TP)."""
    cfg = _config(args)
    precision = cfg.precision
    device = args.device if mesh is None else mesh.device
    # quantized a block at a time: the float model never exists whole
    params = init_params(cfg, seed=args.seed, device=device,
                         precision=precision,
                         shard=(0, 1) if mesh is None
                         else (mesh.rank, mesh.size))
    kv_source = None
    if cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        kv_source = vision_tokens_stub(gen, args.lanes, cfg.n_vision_tokens,
                                       cfg.d_model, device=device)
    engine = ServingEngine(
        params, cfg,
        ServeConfig(batch_lanes=args.lanes, max_seq=args.max_seq,
                    int8_kv=args.int8_kv, temperature=args.temperature,
                    token_budget=args.token_budget,
                    prefill_chunk=args.prefill_chunk, seed=args.seed,
                    paged=args.paged, page_size=args.page_size,
                    pool_pages=args.pool_pages, queue_limit=args.queue_limit,
                    spec_k=args.spec_k, tp=args.tp,
                    tp_overlap=args.tp_overlap),
        device=device, kv_source=kv_source, mesh=mesh)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    if mesh is not None:
        say(f"tensor parallel: tp={args.tp} over {engine.tp_mesh.devices} "
            f"({mesh.backend}, boundary={engine.tp_overlap_resolved})")

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(2, cfg.vocab_size, size=rng.integers(4, 12)).tolist()
        reqs.append(dict(prompt=prompt, max_new=args.max_new, request_id=i))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if args.stream_gap_ms > 0:
        offs = np.cumsum(rng.exponential(args.stream_gap_ms / 1e3,
                                         size=args.requests))
        done, rejected = engine.run_stream(
            [(float(t), kw) for t, kw in zip(offs, reqs)])
        if rejected:
            say(f"rejected at admission (queue_limit="
                f"{args.queue_limit}): {rejected}")
    else:
        for kw in reqs:
            engine.submit(**kw)
        done = engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(d["tokens"]) for d in done)
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu (plain versions)")
    say(f"served {len(done)} requests, {total_tokens} tokens "
        f"in {dt:.1f}s ({total_tokens / dt:.1f} tok/s on {where}, "
        f"int8_kv={args.int8_kv}, precision={precision}, "
        f"mode={engine.mode}, buckets={engine.chunk_buckets})")
    say(engine.stats_summary())
    if args.stream_gap_ms > 0:
        m = engine.serving_metrics()
        say(f"ttft p50/p99 = {m['ttft_p50_ms']}/{m['ttft_p99_ms']} ms, "
            f"tpot p50/p99 = {m['tpot_p50_ms']}/{m['tpot_p99_ms']} ms, "
            f"queue_peak={m['queue_peak']} preempt={m['preemptions']} "
            f"swap_pages={m['swap_out_pages']}/{m['swap_in_pages']} "
            f"rejected={m['rejected']}")
    if engine.paged:
        m = engine.serving_metrics()
        say(f"paged pool: {engine.pool.n} pages of {engine.pool.ps} slots, "
            f"peak {engine.pool.stats['pages_peak']} in use, "
            f"preemptions={m['preemptions']} resumes={m['resumes']} "
            f"swap_pages={m['swap_out_pages']}/{m['swap_in_pages']}")
    say(f"kernel launches: {ops.launch_counts()}")


if __name__ == "__main__":
    main()

"""Where a serving-TP step's time goes when N ranks share one card.

Spawns groups of 2 and 4 gloo ranks on card 0 (as ``chip_smoke.py`` phase 9
does) and times, per rank, ``ITERS`` rounds of each of:

* ``work``: one decode-sized segment of GPU work (three bf16 [8, 4096] x
  [4096, 4096] matmuls) and a stream synchronize;
* ``work+gather``: the same segment, then ``dist.tp._collective``'s
  all-gather of its [8, 4096] bf16 output (staged through host buffers);
* ``gather``: the all-gather alone (the input already on the card);
* ``gather cpu``: the all-gather of a CPU tensor (gloo alone);
* ``work+gather 1 thread``: as ``work+gather`` with
  ``torch.set_num_threads(1)``.

Prints one JSON line per group: for each case the ranks' mean ms a round,
and the part of it spent in the device-to-host copy of the staging (the
wait for the rank's work), in gloo and in the host-to-device copy.

    python3 scripts/tp_transport_probe.py
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ITERS = 200


def _rank(rank: int, port: int, tp: int) -> dict:
    import torch.distributed as dist

    from repro_torch.dist import tp as tpmod
    from repro_torch.launch.mesh import make_tp_mesh
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // tp))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_tp_mesh(tp, "gloo", rank=rank, port=port, device=dev)
    ctx = tpmod.TPServing(group=mesh.group, size=tp, rank=rank)
    g = torch.Generator(device=dev).manual_seed(rank)
    w = [torch.randn(4096, 4096, device=dev, generator=g,
                     dtype=torch.bfloat16) for _ in range(3)]
    x = torch.randn(8, 4096, device=dev, generator=g, dtype=torch.bfloat16)
    parts = {"d2h": 0.0, "gloo": 0.0, "h2d": 0.0}
    real_cpu, real_to = torch.Tensor.cpu, torch.Tensor.to

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            parts[name] += time.perf_counter() - t0
            return out
        return run

    def work():
        y = x
        for m in w:
            y = y @ m
        return y

    def gather(y):
        tpmod._collective(ctx, "all_gather", y)

    cases = {
        "work": lambda: (work(), torch.cuda.synchronize()),
        "work+gather": lambda: gather(work()),
        "gather": lambda: gather(x),
        "gather cpu": lambda: gather(x.cpu()),
    }
    out = {}
    for name, fn in [*cases.items(), ("work+gather 1 thread",
                                      cases["work+gather"])]:
        if name.endswith("1 thread"):
            torch.set_num_threads(1)
        for _ in range(10):
            fn()
        dist.barrier()
        torch.cuda.synchronize()
        for k in parts:
            parts[k] = 0.0
        torch.Tensor.cpu = timed("d2h", real_cpu)
        torch.Tensor.to = timed("h2d", real_to)
        ag = dist.all_gather
        dist.all_gather = timed("gloo", ag)
        t0 = time.perf_counter()
        try:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        finally:
            torch.Tensor.cpu, torch.Tensor.to = real_cpu, real_to
            dist.all_gather = ag
        wall = time.perf_counter() - t0
        out[name] = {"ms": wall / ITERS * 1e3,
                     **{k: v / ITERS * 1e3 for k, v in parts.items()}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import run_ranks
    for tp in (2, 4):
        ranks = run_ranks(_rank, tp, tp)
        print(json.dumps({"tp": tp, "cases": {
            name: {k: [round(r[name][k], 3) for r in ranks]
                   for k in ranks[0][name]} for name in ranks[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

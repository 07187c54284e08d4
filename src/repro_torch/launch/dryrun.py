"""Dry-run plans of every (arch x shape x mesh) cell, and the pipeline and
serving-TP cells over gloo.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step over 256 / 512 placeholder TPU devices and reads XLA's memory
and cost analyses.  The port compiles nothing: ``run_cell`` builds the
cell's parameters, optimizer state (train), states and inputs on the meta
device (shapes, no data), binds the cell's plan (``specs.make_cell_plan``
on the production mesh's shape, 16 x 16 or 2 x 16 x 16, with the cards
named as placeholders) and records each rank's bytes of them under the
plan's specs (``dist.param_specs``, ``specs.state_specs``; inputs on the
batch axes), the model FLOPs a card (``roofline.model_flops``) and whether
the bytes fit one H100's 80 GB.  These bytes stand in for the argument part
of the reference's ``memory_analysis``: temporaries (activations, the
gathered FSDP weights, workspace) are not counted, so "fits" is a floor.
Serving cells count float matrices at bf16 (the reference's serving cast).

``run_pipeline_cell`` runs ``dist.pipeline.pipeline_apply`` (GPipe) over a
group of ranks and holds it equal to the unpipelined stack;
``run_tp_serve_cell`` serves a reduced codeqwen1.5-7b through ``dist/tp.py``
with every summing collective refused, and checks each boundary's
collectives (barrier: all-gathers only; overlap: all-to-alls too), as the
reference checks its compiled HLO.  Both run on the card unless the caller
asks for the CPU (``--device cpu``, the tests): over gloo with every rank
on the one card, or over NCCL (``--backend nccl``) with rank r on cuda:r.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--single-pod-only | --multi-pod-only] [--precision w8a8]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --pipeline \
        [--device cuda|cpu] [--backend gloo|nccl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --tp-serve \
        [--device cuda|cpu] [--backend gloo|nccl]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import traceback

import numpy as np
import torch

from ..configs import ARCH_IDS, SHAPES, cells, get_config
from ..convert import LeafShape, reference_shapes
from ..dist.sharding import map_with_path, param_specs, set_axis_env
from ..kernels import build
from ..kernels.common import resolve_device
from .mesh import make_production_mesh, make_tp_mesh, run_ranks
from .roofline import RESULTS_DIR, model_flops
from .specs import (abstract_params, input_specs, make_cell_plan,
                    stacked_states, state_specs)

CARD_BYTES = 80 * 10 ** 9      # one H100's device memory
PLACEHOLDERS = 512             # the cards a plan may name, as the reference


def _leaves(tree):
    out = []
    map_with_path(tree, lambda path, leaf: out.append((path, leaf)))
    return out


def _shard_bytes(leaf: LeafShape, spec: tuple, sizes: dict) -> int:
    """A rank's bytes of ``leaf`` under ``spec``: each dim cut by the
    product of its axes."""
    n = 1
    for dim, entry in zip(leaf.shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n * leaf.dtype.itemsize


def rank_bytes(shapes, specs, sizes: dict) -> int:
    """A rank's bytes of a tree of ``LeafShape``s under its spec tree."""
    return sum(_shard_bytes(leaf, spec, sizes) for (_, leaf), (_, spec)
               in zip(_leaves(shapes), _leaves(specs)))


def _serving_cast(shapes):
    """Float matrices at bf16: serving reads the checkpoint cast at load."""
    return map_with_path(shapes, lambda _, x: LeafShape(
        x.shape, torch.bfloat16) if (x.dtype == torch.float32
                                     and len(x.shape) >= 2) else x)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             precision: str = "bf16", int8_kv: bool = False,
             fsdp: bool = True, save: bool = True,
             variant: str = "baseline") -> dict:
    cfg = get_config(arch, precision=precision)
    shape = SHAPES[shape_name]
    kind = shape["kind"]
    mesh = make_production_mesh(multi_pod=multi_pod, n_devices=PLACEHOLDERS)
    plan = make_cell_plan(cfg, mesh, kind, shape["global_batch"], fsdp=fsdp,
                          variant=variant)
    set_axis_env(plan.env)
    sizes = mesh.shape
    params = abstract_params(cfg, precision if precision != "bf16" else None)
    shapes = reference_shapes(params, cfg)
    if kind != "train" and precision == "bf16":
        shapes = _serving_cast(shapes)
    pspecs = param_specs(params, cfg)
    nbytes = {"params": rank_bytes(shapes, pspecs, sizes), "optimizer": 0,
              "states": 0, "inputs": 0}
    if kind == "train":
        # AdamW's mu and nu: f32 mirrors of the parameters, sharded alike
        f32 = map_with_path(shapes, lambda _, x: LeafShape(x.shape,
                                                           torch.float32))
        nbytes["optimizer"] = 2 * rank_bytes(f32, pspecs, sizes) + 4
    b = plan.batch_axes or None
    for name, x in input_specs(cfg, kind, shape["seq_len"],
                               shape["global_batch"], int8_kv).items():
        if name == "states":
            st = stacked_states(x, cfg)
            nbytes["states"] = rank_bytes(st, state_specs(x, plan, cfg),
                                          sizes)
        else:
            leaf = LeafShape(tuple(x.shape), x.dtype)
            spec = (b,) + (None,) * (len(leaf.shape) - 1)
            nbytes["inputs"] += _shard_bytes(leaf, spec, sizes)
    nbytes["total"] = sum(nbytes.values())
    record = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size, "precision": precision, "int8_kv": int8_kv,
        "plan": {"batch_axes": list(plan.batch_axes),
                 "kv_heads_on_model": plan.kv_heads_on_model,
                 "ep_mode": plan.ep_mode,
                 "seq_axes_kv": list(plan.seq_axes_kv),
                 "fsdp": fsdp and kind == "train"},
        "bytes_per_device": nbytes,
        "temporaries": "not counted (no compiled program)",
        "model_flops_per_device": model_flops(cfg, shape) / mesh.size,
        "fits": nbytes["total"] <= CARD_BYTES,
    }
    if save:
        sub = os.path.join(RESULTS_DIR, record["mesh"])
        os.makedirs(sub, exist_ok=True)
        suffix = "" if precision == "bf16" else f"__{precision}"
        with open(os.path.join(sub, f"{arch}__{shape_name}{suffix}.json"),
                  "w") as f:
            json.dump(record, f, indent=1)
    return record


# ---------------------------------------------------------------------------
# the pipeline and serving-TP cells: process groups on the card (or the CPU)
# ---------------------------------------------------------------------------

def _tanh_layer(w, h):
    return torch.tanh(h @ w)


def _rank_device(backend: str, device):
    """The ``device`` a rank of ``make_tp_mesh`` takes: nccl places rank r
    on cuda:r itself; gloo puts every rank on ``device`` (the card unless
    the caller asks for the CPU)."""
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError("backend='nccl' runs on the cards: rank r on "
                             "cuda:r")
        return None
    return str(resolve_device(device))


def _pipeline_rank(rank: int, port: int, n_stages: int, backend: str,
                   device, layers, xs):
    """One stage.  Returns its pipelined outputs and whether they equal
    this process's own unpipelined stack on the same device, a microbatch
    at a time (the GEMMs of the same shapes).  Tensors travel as numpy (a
    spawned rank's torch tensors would cross the pipe as shared memory its
    exit frees)."""
    from ..dist.pipeline import pipeline_apply, split_stages
    torch.set_num_threads(1)
    mesh = make_tp_mesh(n_stages, backend, rank=rank, port=port,
                        device=device)
    layers = torch.from_numpy(layers).to(mesh.device)
    xs = torch.from_numpy(xs).to(mesh.device)
    out = pipeline_apply(_tanh_layer, split_stages(layers, n_stages)[rank],
                         xs, mesh.group)
    want = []
    for h in xs:
        for w in layers:
            h = _tanh_layer(w, h)
        want.append(h)
    return (out.cpu().numpy(), str(mesh.device),
            torch.equal(out, torch.stack(want)))


def run_pipeline_cell(n_stages: int = 4, n_microbatches: int = 8,
                      n_layers: int = 8, d_model: int = 512,
                      microbatch: int = 4, seed: int = 0, device=None,
                      backend: str = "gloo") -> dict:
    """GPipe over ``n_stages`` ranks of a ``backend`` group (gloo: every
    rank on ``device``, by default the card, ``"cpu"`` for the CPU; nccl:
    rank r on cuda:r), every rank's outputs ``torch.equal`` to the
    unpipelined stack of ``n_layers`` tanh layers and to each other's."""
    from ..dist.pipeline import bubble_fraction
    assert n_stages >= 2, "the point is a MULTI-stage schedule"
    device = _rank_device(backend, device)
    gen = torch.Generator().manual_seed(seed)
    layers = torch.randn(n_layers, d_model, d_model,
                         generator=gen) * d_model ** -0.5
    xs = torch.randn(n_microbatches, microbatch, d_model, generator=gen)
    ranks = run_ranks(_pipeline_rank, n_stages, n_stages, backend, device,
                      layers.numpy(), xs.numpy())
    equal = all(r[2] for r in ranks) and all(
        np.array_equal(r[0], ranks[0][0]) for r in ranks)
    assert equal, "a rank's pipelined outputs differ from the plain stack"
    return {"kind": "pipeline", "backend": backend,
            "devices": [r[1] for r in ranks], "n_stages": n_stages,
            "n_microbatches": n_microbatches, "n_layers": n_layers,
            "d_model": d_model, "microbatch": microbatch,
            "schedule_steps": n_microbatches + n_stages - 1,
            "bubble_fraction": bubble_fraction(n_stages, n_microbatches),
            "ranks_equal_unpipelined": equal}


# the collectives that sum partial products (never in the exact TP step)
_SUMS = ("all_reduce", "reduce_scatter", "reduce_scatter_tensor", "reduce")
TP_PROMPTS = ([5, 6, 7, 8] * 4, [11, 12, 13] * 5)


def _tp_rank(rank: int, port: int, tp: int, overlap: str, backend: str,
             device):
    import torch.distributed as dist

    from ..dist import COLLECTIVES
    from ..models import init_params
    from ..serve import ServeConfig, ServingEngine
    torch.set_num_threads(1)
    mesh = make_tp_mesh(tp, backend, rank=rank, port=port, device=device)
    for name in _SUMS:
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"the sharded step called {_name}")
        setattr(dist, name, refuse)
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b", reduced=True),
                              n_heads=8, n_kv_heads=8)
    params = init_params(cfg, device=mesh.device, shard=(rank, tp))
    eng = ServingEngine(params, cfg, ServeConfig(
        batch_lanes=2, max_seq=64, token_budget=8, tp=tp, tp_overlap=overlap),
        device=mesh.device, mesh=mesh)
    COLLECTIVES.clear()
    for i, p in enumerate(TP_PROMPTS):
        eng.submit(list(p), max_new=4, request_id=i)
    toks = {d["id"]: d["tokens"] for d in eng.run_until_drained()}
    return toks, dict(COLLECTIVES), str(mesh.device)


def run_tp_serve_cell(overlap: str, tp: int = 2, device=None,
                      backend: str = "gloo") -> dict:
    """Serve reduced codeqwen1.5-7b (8 / 8 heads) at ``tp`` (gloo: every
    rank on ``device``, by default the card; nccl: rank r on cuda:r) and
    check the collective structure: no summing collective (each raises in
    the ranks), all-gathers only under ``barrier``, all-to-alls and
    all-gathers under ``overlap``; every rank's tokens equal."""
    device = _rank_device(backend, device)
    if backend == "nccl" or torch.device(device).type == "cuda":
        build.build_all()             # once, before the ranks
    ranks = run_ranks(_tp_rank, tp, tp, overlap, backend, device)
    toks, cc, _ = ranks[0]
    assert all(r[0] == toks for r in ranks), "the ranks' tokens differ"
    if overlap == "barrier":
        assert cc.get("all_gather", 0) >= 1 and not cc.get("all_to_all"), cc
    else:
        assert cc.get("all_to_all", 0) >= 1 and cc.get("all_gather", 0) >= 1, cc
    return {"kind": "tp_serve", "tp": tp, "overlap": overlap,
            "backend": backend, "devices": [r[2] for r in ranks],
            "collective_counts": cc, "tokens": toks}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "w8a8"])
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="run the GPipe schedule over 2 and 4 ranks")
    ap.add_argument("--tp-serve", action="store_true",
                    help="serve at tp 2, barrier and overlap, and check the "
                         "collectives")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the --pipeline and --tp-serve ranks run "
                         "with gloo (default: the card)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="their group's transport: gloo (every rank on "
                         "--device) or nccl (rank r on cuda:r)")
    args = ap.parse_args()

    jobs = []
    where = f"{args.backend}, {args.device}"
    if args.tp_serve:
        jobs = [(f"[tp-serve] tp=2 {o} ({where})",
                 lambda o=o: run_tp_serve_cell(o, device=args.device,
                                               backend=args.backend))
                for o in ("barrier", "overlap")]
    elif args.pipeline:
        jobs = [(f"[pipeline] {s} stages x {m} microbatches ({where})",
                 lambda s=s, m=m: run_pipeline_cell(
                     s, m, device=args.device, backend=args.backend))
                for s, m in ((2, 4), (4, 8))]
    else:
        meshes = [False, True]
        if args.single_pod_only:
            meshes = [False]
        if args.multi_pod_only:
            meshes = [True]
        for multi_pod in meshes:
            for arch in [args.arch] if args.arch else ARCH_IDS:
                names = [args.shape] if args.shape else cells(arch)
                if args.precision == "w8a8":
                    # W8A8 is the paper's inference mode: no train cells
                    names = [s for s in names if SHAPES[s]["kind"] != "train"]
                for name in names:
                    tag = (f"[{'2x16x16' if multi_pod else '16x16'}] {arch} "
                           f"x {name} ({args.precision})")
                    jobs.append((tag, lambda a=arch, s=name, p=multi_pod:
                                 run_cell(a, s, p, args.precision,
                                          args.int8_kv)))
    n_fail = 0
    for tag, job in jobs:
        try:
            rec = job()
        except Exception as e:          # report every cell, then fail
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            n_fail += 1
            continue
        if "bytes_per_device" in rec:
            gib = {k: v / 2 ** 30 for k, v in rec["bytes_per_device"].items()}
            print(f"OK   {tag}: params {gib['params']:.2f}, optimizer "
                  f"{gib['optimizer']:.2f}, states {gib['states']:.2f}, "
                  f"inputs {gib['inputs']:.3f}, total {gib['total']:.2f} "
                  f"GiB/card; fits 80 GB: "
                  f"{'yes' if rec['fits'] else 'no'}; "
                  f"{rec['model_flops_per_device']:.3e} model flops/card",
                  flush=True)
        else:
            print(f"OK   {tag}: {json.dumps(rec, default=str)}", flush=True)
    print(f"\ndry-run complete: {len(jobs) - n_fail} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

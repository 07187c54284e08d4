"""The rank side of ``tests/test_torch_tp.py``: what each spawned process of
a gloo CPU group runs.  It imports the port only (a rank starts from a fresh
interpreter; the reference's trees arrive as numpy)."""
import itertools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import from_reference
from repro_torch.dist import COLLECTIVES, shard_params
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.serve import ServeConfig, ServingEngine

# the reference smoke's prompts (scripts/tp_equiv_smoke.py): cyclic, so the
# n-gram proposer engages under spec_k > 0
PROMPTS = [([5, 6, 7, 8] * 6)[:20], ([11, 12, 13] * 7)[:18],
           ([3, 4] * 8)[:14], [9, 3, 11, 4, 2, 30, 31]]
MAX_NEW = 12
BASE = dict(batch_lanes=2, max_seq=64, token_budget=8)
# (label, ServeConfig overrides, stats that must be > 0): the smoke's four
# settings; the pressure run packs 4 speculating lanes onto a pool too
# small for them, forcing preempt + swap mid-drain
SETTINGS = [
    ("greedy/dense/k0", dict(), ()),
    ("greedy/paged/k4/pressure",
     dict(batch_lanes=4, token_budget=16, paged=True, page_size=8,
          pool_pages=8, spec_k=4),
     ("preemptions", "resumes", "swap_in_pages", "spec_accepted")),
    ("sampled/paged/k0", dict(paged=True, page_size=8, temperature=0.8), ()),
    ("greedy/paged/k0", dict(paged=True, page_size=8), ()),
]
STATS = ("preemptions", "resumes", "swap_in_pages", "spec_accepted")
# one packed step: two lanes prefilling 8 and 6 tokens
STEP_TOK = np.array([PROMPTS[0][:8], PROMPTS[1][:6] + [0, 0]], np.int32)
STEP_POS = np.array([list(range(8)), list(range(6)) + [-1, -1]], np.int32)
STEP_LAST = np.array([7, 5], np.int64)
# the collectives the sharded step may run; anything that sums raises
_SUMS = ("all_reduce", "reduce_scatter", "reduce_scatter_tensor", "reduce",
         "all_reduce_coalesced")


def scfg(precision: str, overrides: dict, **kw) -> ServeConfig:
    """The setting's ServeConfig: the integer precisions serve from the
    int8 KV cache (its scales shard with its heads), bf16 from a bf16
    cache."""
    return ServeConfig(**{**BASE, **overrides, **kw},
                       int8_kv=precision != "bf16")


def drain(engine) -> tuple[dict, dict]:
    engine._clock = itertools.count().__next__   # stats off the wall clock
    for i, p in enumerate(PROMPTS):
        engine.submit(list(p), max_new=MAX_NEW, request_id=i)
    toks = {d["id"]: d["tokens"] for d in engine.run_until_drained()}
    return toks, {k: engine.stats[k] for k in STATS}


def step_logits(engine) -> np.ndarray:
    """Logits (B, 1, V) of one packed prefill step on a fresh engine."""
    return engine._forward(STEP_TOK, STEP_POS, STEP_LAST,
                           np.ones(2, bool), True, 1).numpy()


def rank_drains(rank: int, port: int, tp: int, cfgs: dict, trees: dict):
    """Every precision's settings at both boundaries on this rank's shard
    of the converted reference tree; one packed step's logits and the
    collectives it ran (a summing collective raises)."""
    torch.set_num_threads(1)
    mesh = make_tp_mesh(tp, "gloo", rank=rank, port=port, device="cpu")
    for name in _SUMS:
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"the sharded step called {_name}")
        setattr(dist, name, refuse)
    out = {}
    for precision, tree in trees.items():
        cfg = cfgs[precision]
        shard = shard_params(from_reference(tree, cfg, device="cpu"), rank,
                             tp)
        for overlap in ("barrier", "overlap"):
            res = out[precision, overlap] = {}
            for label, over, _ in SETTINGS:
                eng = ServingEngine(shard, cfg, scfg(
                    precision, over, tp=tp, tp_overlap=overlap),
                    device="cpu", mesh=mesh)
                res[label] = drain(eng)
            eng = ServingEngine(shard, cfg, scfg(precision, {}, tp=tp,
                                                 tp_overlap=overlap),
                                device="cpu", mesh=mesh)
            COLLECTIVES.clear()
            res["logits"] = step_logits(eng)
            res["collectives"] = dict(COLLECTIVES)
            res["resolved"] = eng.tp_overlap_resolved
    # timed arrivals on each rank's own wall clock: rank 0's decide
    # (dist.tp.agree), so the group's schedules, and tokens, stay equal
    eng = ServingEngine(shard, cfg, scfg(precision, {}, tp=tp,
                                         tp_overlap="overlap"),
                        device="cpu", mesh=mesh)
    done, _ = eng.run_stream([
        (0.05 * i, dict(prompt=list(p), max_new=MAX_NEW, request_id=i))
        for i, p in enumerate(PROMPTS)])
    out["stream", precision] = {d["id"]: d["tokens"] for d in done}
    return out

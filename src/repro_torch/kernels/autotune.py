"""The MoE group-size table and the serving-TP boundary choice of
``repro.kernels.autotune`` (``moe_group_size`` and
``_MOE_GROUP_CANDIDATES``, ``autotune.py:214-241``; ``tp_serving_overlap``,
``:381``), table path only.

The reference first consults a cache of tile choices measured on its TPU
(``REPRO_AUTOTUNE_CACHE``); the port has no measurements of its own yet
(ROADMAP.md §A), so it takes the reference's table rule: the argmin of the
dispatch cost model (``core.costmodel``) over the candidate group sizes
that divide the token count, and the cheaper TP boundary by the cost
model.
"""
from __future__ import annotations

import functools

from ..core import costmodel

# GShard group-size candidates for the MoE dispatch (tokens per group)
_MOE_GROUP_CANDIDATES = (128, 256, 512, 1024, 2048, 4096, 8192)


@functools.lru_cache(maxsize=4096)
def moe_group_size(t: int, d: int, ff: int, e: int, k: int,
                   capacity_factor: float) -> int:
    """Tokens per GShard dispatch group for a ``t``-token MoE forward: the
    cost model's argmin over the candidates that divide ``t`` (one
    whole-batch group when none does)."""
    cands = [sg for sg in _MOE_GROUP_CANDIDATES
             if sg <= t and t % sg == 0] or [t]
    best, best_cost = cands[0], float("inf")
    for sg in cands:
        c = costmodel.moe_dispatch_cost(t, d, ff, e, k, capacity_factor, sg)
        if c < best_cost:
            best, best_cost = sg, c
    return best


@functools.lru_cache(maxsize=4096)
def tp_serving_overlap(rows: int, d_model: int, d_ff: int, heads_dim: int,
                       tp: int) -> str:
    """``"overlap"`` or ``"barrier"`` for the serving-TP row-GEMM boundary
    (``dist/tp.py``) of a step with ``rows`` packed tokens: the sum of the
    two boundaries a block crosses (attention out: heads dim -> d_model;
    MLP out: d_ff -> d_model) under each variant by
    ``costmodel.tp_boundary_cost``, the cheaper one."""
    if tp <= 1:
        return "barrier"

    def total(overlap: bool) -> float:
        return (costmodel.tp_boundary_cost(rows, heads_dim, d_model, tp,
                                           overlap)
                + costmodel.tp_boundary_cost(rows, d_ff, d_model, tp,
                                             overlap))

    return "overlap" if total(True) < total(False) else "barrier"

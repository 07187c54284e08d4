"""The MoE dispatch cost model and the serving-TP boundary cost of
``repro.core.costmodel`` (its ``moe_capacity`` and ``moe_dispatch_cost``,
``costmodel.py:220-256``, and ``tp_boundary_cost``, ``:259``).

These are the reference's GShard group-size rule, its overlap-vs-barrier
rule and the TPU machine constants they read, copied so that the port picks
the same tokens per dispatch group and the same expert capacity as the
reference — and so the same tokens are dropped — and resolves
``tp_overlap="auto"`` to the same boundary.  They are not a statement about
the card: the
constants are the reference's TPU figures (v5e-class cycles, bytes per
cycle of HBM and of the inter-chip links), and only their relative cost
across candidate group sizes decides anything.
"""
from __future__ import annotations

TPU_MACS_PER_CYCLE = 128 * 128         # the reference's MXU pass per cycle
TPU_HBM_BYTES_PER_CYCLE = 870          # the reference's HBM bytes per cycle
TPU_ICI_BYTES_PER_CYCLE = 100          # all-to-all bytes per cycle (ICI)
TPU_A2A_LATENCY_CYCLES = 8000          # one grouped all-to-all's setup


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def moe_capacity(sg: int, e: int, k: int, capacity_factor: float) -> int:
    """GShard per-expert queue length for an sg-token group."""
    return min(max(int(capacity_factor * sg * k / e), 4), sg)


def moe_dispatch_cost(t: int, d: int, ff: int, e: int, k: int,
                      capacity_factor: float, sg: int) -> float:
    """The reference's estimated cycles of one capacity-bounded MoE layer
    over ``t`` tokens at group size ``sg``: the (G, S, E, C) one-hot
    dispatch and combine, the expert inputs' all-to-all both ways, the
    expert GEMMs' capacity padding, and one all-to-all setup per group."""
    g = _cdiv(t, sg)
    cap = moe_capacity(sg, e, k, capacity_factor)
    onehot_bytes = 2 * g * sg * e * cap * 4
    a2a_bytes = 2 * e * g * cap * d * 2
    waste_rows = max(e * g * cap - t * k, 0)
    waste = waste_rows * 3 * d * ff / TPU_MACS_PER_CYCLE
    return (onehot_bytes / TPU_HBM_BYTES_PER_CYCLE
            + a2a_bytes / TPU_ICI_BYTES_PER_CYCLE
            + waste + g * TPU_A2A_LATENCY_CYCLES)


def tp_boundary_cost(rows: int, d_in: int, d_out: int, tp: int,
                     overlap: bool, bytes_per_elt: int = 2) -> float:
    """The reference's estimated cycles for ONE serving-TP row-GEMM
    boundary (``dist/tp.py``): the feature-sharded hidden (``rows`` x
    ``d_in``) entering a replicated (``d_in`` x ``d_out``) projection
    across ``tp`` ranks.  Barrier: all-gather of the hidden, the full row
    GEMM on every rank.  Overlap: the all-to-all (same payload and fan-out),
    1/tp of the GEMM rows a rank, then the gather of the output rows.  Only
    the relative cost of the two decides anything."""
    if tp <= 1:
        return 0.0
    wire = rows * d_in * bytes_per_elt * (tp - 1) / tp
    mac = rows * d_in * d_out
    if not overlap:
        return (wire / TPU_ICI_BYTES_PER_CYCLE + TPU_A2A_LATENCY_CYCLES
                + mac / TPU_MACS_PER_CYCLE)
    out_wire = rows * d_out * bytes_per_elt * (tp - 1) / tp
    return (wire / TPU_ICI_BYTES_PER_CYCLE
            + out_wire / TPU_ICI_BYTES_PER_CYCLE
            + 2 * TPU_A2A_LATENCY_CYCLES
            + mac / tp / TPU_MACS_PER_CYCLE)

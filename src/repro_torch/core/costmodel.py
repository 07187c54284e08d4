"""The MoE dispatch cost model of ``repro.core.costmodel`` (its
``moe_capacity`` and ``moe_dispatch_cost``, ``costmodel.py:220-256``).

These are the reference's GShard group-size rule and the TPU machine
constants it reads, copied so that the port picks the same tokens per
dispatch group and the same expert capacity as the reference — and so the
same tokens are dropped.  They are not a statement about the card: the
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

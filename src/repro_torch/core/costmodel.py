"""The NX-CGRA cost model (Tables V and VI), the MoE dispatch cost model
and the serving-TP boundary cost of ``repro.core.costmodel`` (its CGRA part,
``costmodel.py:22-104``; ``moe_capacity`` and ``moe_dispatch_cost``,
``:220-256``; ``tp_boundary_cost``, ``:259``), and the Hopper tile costs
of the port's kernels that take the place of the reference's TPU tile
costs (``:118-395``).

The CGRA part turns the fabric simulator's cycles and energy into the
paper's metrics (MOPS, GOPS/mm^2, TOPS/W, TOPS/W/mm^2) with the published
implementation constants (22 nm FD-SOI, 200 MHz, 0.8 V, 0.178 mm^2): a
model of the paper's fabric, not a statement about the card.  Its
arithmetic is the reference's, in the same order, so every metric equals
the reference's with ``==``.  MOPS excludes the context pre-load (the
paper pre-configures before application start, §III-D); the numerator is
the kernel's documented useful-op count (``core/kernel_library.py``).

The MoE and TP rules are the reference's GShard group-size rule, its
overlap-vs-barrier rule and the TPU machine constants they read, copied so
that the port picks
the same tokens per dispatch group and the same expert capacity as the
reference — and so the same tokens are dropped — and resolves
``tp_overlap="auto"`` to the same boundary.  They are not a statement about
the card: the
constants are the reference's TPU figures (v5e-class cycles, bytes per
cycle of HBM and of the inter-chip links), and only their relative cost
across candidate group sizes decides anything.

The Hopper tile costs estimate, in seconds on one H100, a launch of the
port's tensor-core GEMM loop (``kernels/csrc/gemm_mma.cuh``), of
``bf16_gemm`` and of the decode attention's cache split, at one of the
tilings their C entries take (``kernels/autotune.py`` lists them).  Their
constants are the card's (the hopper-kernels guide: 132 SMs, 228 KB of
shared memory an SM, 3.35 TB/s, a 50 MB L2, 989 TFLOP/s bf16 and 1979
TOP/s int8 dense) and four figures measured on it (PERF.md §6):
bf16_gemm's ~8.9 us of ring fill and epilogue for a 128 x 256 tile and
0.657 us a 64-deep k-tile of it (a fit to its times), its ~64 ns a dependent k16
``wgmma`` step at decode rows, and the share of the peak each
``mma.sync`` kind reaches at 4096 rows.  The terms: waves of blocks over
the SMs, bytes from device memory at the rate the blocks in flight can
draw (an SM reaches its share of 3.35 TB/s with ``INFLIGHT_PER_SM`` bytes
of weight in flight), a weight that fits the L2 read once from device
memory, the split-K combine's int32 partials, and each tile's ring fill
and epilogue.
"""
from __future__ import annotations

import dataclasses

from .isa import FREQ_HZ
from .simulator import SimResult

# --- Table V: total cell area breakdown (um^2), 22nm FD-SOI ------------------
AREA_UM2 = {
    "memory_map": 206,
    "memory_controller": 164,
    "context_memory": 13_327,     # 2 x 2 KiB SRAM macros
    "nx_array": 164_195,          # 16 PE + 8 MOB
    "other": 107,
}
TOTAL_AREA_MM2 = sum(AREA_UM2.values()) / 1e6  # = 0.177999 mm^2

# Active (non-gated) subsystem power beyond per-op energies: clock tree,
# global execution controller, memory controller.  Calibrated so kernel
# power lands in the paper's 1.5-1.6 mW band.
ACTIVE_W = 1.05e-3

# Paper Table VI reference values for the comparison report.
PAPER_TABLE_VI = {
    # kernel: (MOPS, GOPS/mm^2, TOPS/W, TOPS/W/mm^2)
    "conv": (1902, 10.68, 1.28, 7.20),
    "gemm": (3040, 17.08, 2.01, 11.29),
    "gelu": (636, 3.57, 0.39, 2.21),
    "norm": (70, 0.39, 0.04, 0.24),
    "quant": (255, 1.43, 0.16, 0.89),
    "sftmx": (1102, 6.19, 0.68, 3.83),
}


@dataclasses.dataclass
class KernelMetrics:
    name: str
    cycles: int
    exec_cycles: int            # excluding context pre-load
    time_s: float
    mops: float
    gops_mm2: float
    tops_w: float
    tops_w_mm2: float
    power_mw: float
    utilization: float

    def row(self) -> tuple:
        return (self.name, self.mops, self.gops_mm2, self.tops_w, self.tops_w_mm2)


def metrics_from_sim(name: str, sim: SimResult, useful_ops: int) -> KernelMetrics:
    exec_cycles = sim.cycles - sim.context_cycles
    t = exec_cycles / FREQ_HZ
    power = sim.energy_j / max(sim.cycles / FREQ_HZ, 1e-12) + ACTIVE_W
    ops_per_s = useful_ops / max(t, 1e-12)
    mops = ops_per_s / 1e6
    gops = ops_per_s / 1e9
    tops_w = (ops_per_s / 1e12) / power
    return KernelMetrics(
        name=name,
        cycles=sim.cycles,
        exec_cycles=exec_cycles,
        time_s=t,
        mops=mops,
        gops_mm2=gops / TOTAL_AREA_MM2,
        tops_w=tops_w,
        tops_w_mm2=tops_w / TOTAL_AREA_MM2,
        power_mw=power * 1e3,
        utilization=sim.utilization(),
    )


def area_table() -> list[tuple[str, float, float]]:
    """Reproduces Table V: (component, area um^2, %)."""
    total = sum(AREA_UM2.values())
    return [(k, v, 100.0 * v / total) for k, v in AREA_UM2.items()] + [
        ("NX-CGRA", total, 100.0)
    ]


# ---------------------------------------------------------------------------
# the MoE dispatch and serving-TP boundary rules (the reference's TPU figures)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Hopper tile costs (the port's kernels on one H100; they rank the
# candidates of kernels/autotune.py)
# ---------------------------------------------------------------------------

H100_SMS = 132
H100_SMEM_PER_SM = 233472              # 228 KB an SM
H100_HBM_BPS = 3.35e12
H100_L2_BYTES = 50 * 10 ** 6
H100_PEAK_OPS = {"w8": 1979e12, "w4": 1979e12, "bf16": 989e12}
# measured on the card (PERF.md §6): bf16_gemm's 128 x 256 tile — ring
# fill and epilogue, one 64-deep k-tile, one dependent k16 step at decode
# rows (a fit to its times); the share of the peak the mma.sync loop
# reaches at 4096 rows (int8_gemm 0.880 ms at [4096,13440]x[13440,4096],
# int4_gemm 1.836 ms there, the bf16 dual_gemm_gated 3.107 ms at
# [4096,4096]x2[4096,13440])
TILE_FIXED_S, K_TILE_S, WGMMA_STEP_S = 8.9e-6, 0.657e-6, 64e-9
BF16_TILE_BYTES = 4 * (128 + 256) * 64 * 2 + 128 * 256 * 2
MMA_PEAK_SHARE = {"w8": 0.26, "w4": 0.12, "bf16": 0.29}
# the weight bytes an SM keeps in flight to draw its share of the device
# memory rate (Little's law; the rule behind the GEMMs' and the decode
# split's fill of the card)
INFLIGHT_PER_SM = 32 << 10


def _fixed_s(ring_bytes: float, out_bytes: float) -> float:
    """A tile's ring fill and epilogue: the fitted 8.9 us for bf16_gemm's
    128 x 256 tile, scaled by the bytes they move."""
    return TILE_FIXED_S * (ring_bytes + out_bytes) / BF16_TILE_BYTES


def _draw(blocks: int, per_block: float, slots_per_sm: int,
          n_sm: int) -> float:
    """The share of the device memory rate that ``blocks`` blocks of
    ``per_block`` bytes in flight draw: each SM reaches its share with
    INFLIGHT_PER_SM bytes, the resident blocks dealt round the SMs."""
    resident = min(blocks, slots_per_sm * n_sm)
    full, extra = divmod(resident, n_sm)

    def sm(k: int) -> float:
        return min(1.0, k * per_block / INFLIGHT_PER_SM)
    return max((extra * sm(full + 1) + (n_sm - extra) * sm(full)) / n_sm,
               1e-9)


def mma_gemm_tile_cost(m: int, k: int, n: int, kind: str, streams: int,
                       bm: int, bn: int, split: int, k_len: int,
                       blocks_per_sm: int, group: int = 0,
                       n_sm: int = H100_SMS) -> float:
    """Seconds for one launch of the tensor-core loop (``gemm_mma.cuh``):
    [m, k] against ``streams`` weights [k, n] of ``kind`` ("w8", "w4" at
    ``group``, "bf16"), blocks of bm x bn, K split ``split`` ways of
    ``k_len``, ``blocks_per_sm`` resident an SM.  The larger of the bytes
    (the weight once if it fits the L2, else once per row of tiles; x; the
    bf16 output; 2 x the split's int32 partials) at the rate the blocks
    draw and the tensor-core work of the padded tiles, plus a ring fill and
    epilogue per wave."""
    rows, cols = _cdiv(m, bm), _cdiv(n, bn)
    blocks = rows * cols * split
    a_bytes = 2 if kind == "bf16" else 1
    w_bytes = {"w8": 1.0, "w4": 0.5 + 1.0 / max(group, 1), "bf16": 2.0}[kind]
    weight = streams * k * n * w_bytes
    partial = 2 * split * rows * bm * n * 4 * streams if split > 1 else 0
    moved = (weight * (1 if weight <= H100_L2_BYTES else rows)
             + m * k * a_bytes + m * n * 2 + partial)
    stage = 64 * bn * streams * (2 if kind == "bf16" else 1)
    t_mem = moved / (H100_HBM_BPS * _draw(blocks, 3 * stage, blocks_per_sm,
                                          n_sm))
    t_mma = (_cdiv(blocks, n_sm) * 2 * bm * bn * k_len * streams
             / (H100_PEAK_OPS[kind] * MMA_PEAK_SHARE[kind] / n_sm))
    fixed = _fixed_s(3 * (stage + bm * 64 * a_bytes),
                     bm * bn * (4 if split > 1 else 2))
    return (max(t_mem, t_mma)
            + _cdiv(blocks, blocks_per_sm * n_sm) * fixed)


def bf16_gemm_tile_cost(m: int, k: int, n: int, bm: int, bn: int,
                        stages: int, x_rows: int, n_sm: int = H100_SMS, *,
                        rate: float = 1.0) -> float:
    """Seconds for one ``bf16_gemm`` launch (``csrc/bf16_gemm.cu``) at a
    tiling: waves of blocks over the SMs (as many an SM as their rings fit
    its shared memory: two for the 64-row tiles up to 64 columns, one for
    the wider), each a ring fill and epilogue
    plus K / 64 k-tiles, each the largest of its tensor-core work at the
    tile's measured ``rate`` (relative to 128 x 256's:
    ``kernels.autotune.BF16_WIDE_RATES``), a stage's weight bytes at an
    SM's share of the memory rate, and the four dependent ``wgmma`` steps
    of a k-tile."""
    blocks = _cdiv(m, bm) * _cdiv(n, bn)
    ring = stages * (x_rows + bn) * 64 * 2
    per_sm = max(1, H100_SMEM_PER_SM // ring)
    k_tile = max(K_TILE_S * bm * bn / (128 * 256) / rate,
                 64 * bn * 2 * per_sm / (H100_HBM_BPS / n_sm),
                 4 * WGMMA_STEP_S)
    fixed = _fixed_s(ring, bm * bn * 2)
    return _cdiv(blocks, per_sm * n_sm) * (fixed + _cdiv(k, 64) * k_tile)


def decode_split_cost(blocks: int, s: int, d: int, g: int, n_split: int,
                      chunk: int, n_sm: int = H100_SMS,
                      keys: int = 32) -> float:
    """Seconds for one T = 1 launch of the decode attention over an int8
    cache of ``s`` slots: ``blocks`` (lanes x kv heads) x ``n_split``
    blocks (three an SM), each streaming ``chunk`` keys of K and V (``d``
    bytes a row, an f32 scale each) through a ring of three tiles of
    ``keys`` in flight; then the combine of every split's f32 (acc, m, l)
    for the ``g`` heads of a block, and a block's fixed start."""
    row = 2 * (d + 4)
    moved = blocks * s * row + 2 * blocks * n_split * g * (d + 2) * 4
    t_mem = moved / (H100_HBM_BPS * _draw(blocks * n_split, 3 * keys * row,
                                          3, n_sm))
    fixed = _fixed_s(3 * keys * row, g * (d + 2) * 4)
    return t_mem + _cdiv(blocks * n_split, 3 * n_sm) * fixed

"""NX-CGRA VLIW ISA model (paper §III-B), the port's copy of
``repro.core.isa`` (pure Python: the same constants and cycle formulas).

The fabric is a 4x6 array: 16 Processing Elements (PEs) and 8 Memory
Operation Blocks (MOBs).  Each core executes statically scheduled microcode.
We model microcode at *macro-op* granularity: one macro-op is a vectorized
inner loop of scalar ISA instructions with an exact cycle formula derived
from the datapath description:

  PE datapath (per cycle, single-issue):
    - ALU8: 4x fused signed MAC (the paper's "4x fused signed
      multiply-accumulate")  -> 4 int8 MACs / cycle
    - MUL16: 1 16-bit unsigned multiply / cycle
    - ALU32: 1 32-bit add/sub/logic/shift/compare / cycle
    - MUL32: 1 32-bit signed multiply (low) / cycle
    - DIV32: iterative, DIV_LATENCY cycles / op
    - branching: JUMP/CJUMP, 1 cycle + synchronization stall

  MOB datapath:
    - LSU with AGU: one 32-bit word per cycle to/from an L1 bank (OBI master);
      the AGU computes streamed addresses for free (separate unit)
    - branching as PEs; no ALUs

  NoC: switchless mesh torus, 32-bit flits, 1 hop / cycle, wormhole-free
  (statically scheduled MOVE ops; the compiler owns the routes).

Cycle formulas live here so the simulator and cost model share them.
"""
from __future__ import annotations

import dataclasses
import enum
import math


class OpClass(enum.Enum):
    MAC8 = "mac8"        # 4x int8 fused MAC
    MUL16 = "mul16"
    ALU32 = "alu32"      # add/sub/logic/shift/cmp/mask
    MUL32 = "mul32"
    DIV32 = "div32"
    MOVE = "move"        # NoC routing
    LOAD = "load"        # MOB only
    STORE = "store"      # MOB only
    JUMP = "jump"        # barrier / control
    NOP = "nop"


# --- microarchitectural constants (22nm FD-SOI implementation, paper §IV-B) --
FREQ_HZ = 200e6
VDD = 0.8
TECH_NM = 22
N_PE = 16
N_MOB = 8
MACS_PER_PE = 4            # "4x fused signed multiply-accumulate"
TOTAL_MACS = N_PE * MACS_PER_PE  # = 64, matches Table III "MACs" row
L1_BANKS = 8               # 8x32 KiB interleaved banks (§IV-A)
L1_BYTES = 256 * 1024
CONTEXT_BYTES = 4 * 1024   # 4 KiB context memory (Table V)
OBI_BYTES_PER_CYCLE = 4    # 32-bit OBI master channel per MOB
NOC_FLIT_BYTES = 4
DIV_LATENCY = 18           # iterative 32-bit divide
ISSUE_OVERHEAD = 1.15      # decode/RF-port structural-hazard derate (calibrated)
CONTEXT_WORDS_PER_CYCLE = 1  # memory controller distributes 4B/cycle


@dataclasses.dataclass(frozen=True)
class MacroOp:
    """One vectorized microcode segment on a single core."""

    cls: OpClass
    count: int = 1           # scalar ops (MAC8: int8 MACs; LOAD/STORE/MOVE: bytes)
    hops: int = 0            # MOVE only: torus Manhattan distance
    bank: int = -1           # LOAD/STORE only: L1 bank index
    tag: str = ""            # debug label

    def cycles(self) -> int:
        if self.cls is OpClass.MAC8:
            return max(1, math.ceil(self.count / MACS_PER_PE))
        if self.cls in (OpClass.ALU32, OpClass.MUL16, OpClass.MUL32):
            return max(1, self.count)
        if self.cls is OpClass.DIV32:
            return self.count * DIV_LATENCY
        if self.cls is OpClass.MOVE:
            return max(1, math.ceil(self.count / NOC_FLIT_BYTES)) + self.hops
        if self.cls in (OpClass.LOAD, OpClass.STORE):
            return max(1, math.ceil(self.count / OBI_BYTES_PER_CYCLE))
        if self.cls is OpClass.JUMP:
            return 1
        return 1


def context_load_cycles(n_cores_programmed: int, bytes_per_core: int = 0) -> int:
    """Pre-configuration: context memory -> per-core instruction RFs.

    The memory controller streams each core's context before execution
    (paper §III-D: "full pre-configuration before application start").
    """
    total = bytes_per_core * n_cores_programmed if bytes_per_core else CONTEXT_BYTES
    return math.ceil(total / (CONTEXT_WORDS_PER_CYCLE * 4))


# Torus geometry: 4 rows x 6 cols; MOBs occupy columns 0 and 5 (4x2 = 8),
# PEs occupy columns 1..4 (4x4 = 16).  Switchless mesh torus distance:
_COLS, _ROWS = 6, 4


def core_position(core_id: int, is_mob: bool) -> tuple[int, int]:
    if is_mob:
        # MOB i: row i%4, col 0 for i<4 else col 5
        return (core_id % 4, 0 if core_id < 4 else _COLS - 1)
    return (core_id % 4, 1 + core_id // 4)


def torus_hops(a: tuple[int, int], b: tuple[int, int]) -> int:
    dr = abs(a[0] - b[0])
    dc = abs(a[1] - b[1])
    return min(dr, _ROWS - dr) + min(dc, _COLS - dc)


# --- energy model (calibrated to Table VI, see costmodel.py) -----------------
# Per-op dynamic energy in pJ at 0.8V/22nm; a near-constant array power of
# ~1.5-1.6 mW across kernels (paper Tables III/IV/VI) implies throughput, not
# power, differentiates kernels; these split the constant power into
# per-class activity for the breakdown reports.
ENERGY_PJ = {
    OpClass.MAC8: 0.12,      # per int8 MAC
    OpClass.MUL16: 0.35,
    OpClass.ALU32: 0.22,
    OpClass.MUL32: 0.55,
    OpClass.DIV32: 4.2,
    OpClass.MOVE: 0.08,      # per byte routed
    OpClass.LOAD: 0.18,      # per byte (SRAM read + OBI)
    OpClass.STORE: 0.20,
    OpClass.JUMP: 0.10,
    OpClass.NOP: 0.01,
}
LEAKAGE_W = 2.1e-4           # static leakage of the subsystem
IDLE_CORE_W = 1.8e-6         # clock-gated core residual power

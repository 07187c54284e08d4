"""NX-CGRA functional + cycle simulator (the port's copy of
``repro.core.simulator``).

Executes a ``CGRAProgram`` produced by the static scheduler:

  * **Functional**: runs the macro-ops' payloads (``core.inumerics`` and
    the port's integer kernels through ``kernels.ops``) against a shared
    value environment, on the device its tensors lie on (the card: the CUDA
    kernels; the CPU: their plain versions) — outputs are bit-exact w.r.t.
    the integer-only semantics the real fabric computes.
  * The timing and energy passes are Python integer and float arithmetic in
    the reference's order of operations, so every number equals the
    reference's with ``==``.
  * **Timing**: per barrier segment, each core's time is the sum of its
    macro-op cycles (x issue overhead for decode/RF structural hazards); the
    segment completes at the max over cores, additionally lower-bounded by
    per-L1-bank service time (8 interleaved banks, 4 B/cycle each).  Context
    pre-load (and re-load, for kernels that exceed the fabric and need a
    context switch — the paper's sftmx case, §IV-A-1) is charged up front.
  * **Energy**: per-op-class activity energy + leakage integrated over the
    cycle count (constants in ``isa.ENERGY_PJ``, calibrated in costmodel).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .isa import (
    ENERGY_PJ,
    FREQ_HZ,
    IDLE_CORE_W,
    ISSUE_OVERHEAD,
    L1_BANKS,
    LEAKAGE_W,
    N_MOB,
    N_PE,
    OpClass,
    context_load_cycles,
)
from .program import CGRAProgram


@dataclasses.dataclass
class SimResult:
    cycles: int
    context_cycles: int
    segment_cycles: list[int]
    energy_j: float
    op_hist: dict[OpClass, int]
    core_busy: dict[str, int]        # per-core busy cycles (utilization report)
    env: dict[str, Any]              # final value environment

    @property
    def time_s(self) -> float:
        return self.cycles / FREQ_HZ

    @property
    def power_w(self) -> float:
        return self.energy_j / max(self.time_s, 1e-12)

    def utilization(self) -> float:
        total = sum(self.core_busy.values())
        return total / max((N_PE + N_MOB) * self.cycles, 1)


class Simulator:
    def run(self, prog: CGRAProgram, env: dict[str, Any] | None = None) -> SimResult:
        env = dict(env or {})
        # ---- functional pass (schedule order) -------------------------------
        for slot in prog.exec_order:
            if slot.fn is not None:
                slot.fn(env)

        # ---- timing pass -----------------------------------------------------
        segment_cycles: list[int] = []
        busy: dict[str, int] = {}
        op_hist: dict[OpClass, int] = {}
        cores = [("pe", c) for c in prog.pes] + [("mob", c) for c in prog.mobs]
        for seg_idx in range(prog.n_barriers):
            core_time = 0
            bank_time = [0] * L1_BANKS
            for kind, core in cores:
                t = 0
                for slot in core.segments[seg_idx] if seg_idx < len(core.segments) else []:
                    cyc = slot.op.cycles()
                    t += cyc
                    op_hist[slot.op.cls] = op_hist.get(slot.op.cls, 0) + slot.op.count
                    if slot.op.cls in (OpClass.LOAD, OpClass.STORE) and slot.op.bank >= 0:
                        bank_time[slot.op.bank] += cyc
                t = int(t * ISSUE_OVERHEAD)
                key = f"{kind}{core.core_id}"
                busy[key] = busy.get(key, 0) + t
                core_time = max(core_time, t)
            # barrier cost: one JUMP per participating core, resolved in 1 cycle
            seg = max(core_time, max(bank_time)) + 1
            segment_cycles.append(seg)

        ctx = context_load_cycles(max(prog.programmed_cores(), 1)) * prog.context_phases
        cycles = ctx + sum(segment_cycles)

        # ---- energy ----------------------------------------------------------
        e_dyn = sum(ENERGY_PJ[cls] * n for cls, n in op_hist.items()) * 1e-12
        time_s = cycles / FREQ_HZ
        # idle cores are clock-gated (paper: core sleep unit + clock gating)
        idle_core_cycles = (N_PE + N_MOB) * cycles - sum(busy.values())
        e_static = LEAKAGE_W * time_s + IDLE_CORE_W * (idle_core_cycles / FREQ_HZ)
        energy = e_dyn + e_static

        return SimResult(
            cycles=cycles,
            context_cycles=ctx,
            segment_cycles=segment_cycles,
            energy_j=energy,
            op_hist=op_hist,
            core_busy=busy,
            env=env,
        )

"""Static scheduler: kernel task graphs -> NX-CGRA microcode (the port's
copy of ``repro.core.scheduler``: the same slot-to-core assignment,
execution order, barriers and context phases).

This plays the role of the paper's LLVM-IR compilation toolchain (§III-C,
Fig. 3) at macro-op granularity: it statically maps a phase-ordered task
graph onto the 16 PEs and 8 MOBs, balancing load, inserting MOVE routing ops
with torus hop counts, assigning L1 banks by address interleave, and placing
JUMP barriers between phases.  The schedule is fully static — no runtime
decisions — which is the paper's core execution-model claim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .isa import (
    L1_BANKS,
    MacroOp,
    N_MOB,
    N_PE,
    OpClass,
    core_position,
    torus_hops,
)
from .program import CGRAProgram, Slot


@dataclasses.dataclass
class Task:
    """A unit of schedulable work.

    kind='compute': ``ops`` maps OpClass -> scalar op count; ``in_bytes`` /
    ``out_bytes`` describe operand traffic to/from MOBs.
    kind='load'/'store': ``nbytes`` of L1 traffic starting at ``addr``.
    ``fn(env)`` is the functional payload (optional).
    """

    name: str
    kind: str                    # compute | load | store
    phase: int = 0
    ops: dict[OpClass, int] = dataclasses.field(default_factory=dict)
    in_bytes: int = 0
    out_bytes: int = 0
    nbytes: int = 0
    addr: int = 0
    fn: Callable[[dict[str, Any]], None] | None = None


def _bank_of(addr: int) -> int:
    # word-interleaved banks (8 x 32 KiB), matching the 8 parallel LSUs
    return (addr // 4) % L1_BANKS


class StaticScheduler:
    """Greedy longest-processing-time list scheduler with static routing."""

    def __init__(self) -> None:
        self.pe_cycles = [0] * N_PE
        self.mob_cycles = [0] * N_MOB

    def schedule(self, tasks: list[Task], name: str = "", context_phases: int = 1) -> CGRAProgram:
        prog = CGRAProgram.empty(name=name)
        prog.context_phases = context_phases
        n_phases = 1 + max((t.phase for t in tasks), default=0)
        for phase in range(n_phases):
            phase_tasks = [t for t in tasks if t.phase == phase]
            # LPT: biggest tasks first for better balance
            phase_tasks.sort(key=self._task_weight, reverse=True)
            pe_load = [0] * N_PE
            mob_load = [0] * N_MOB
            for t in phase_tasks:
                if t.kind == "compute":
                    self._place_compute(prog, t, phase, pe_load, mob_load)
                else:
                    self._place_memory(prog, t, phase, mob_load)
        prog.finalize()
        return prog

    @staticmethod
    def _task_weight(t: Task) -> int:
        if t.kind == "compute":
            return sum(MacroOp(cls=c, count=n).cycles() for c, n in t.ops.items())
        return t.nbytes

    def _place_compute(self, prog: CGRAProgram, t: Task, phase: int,
                       pe_load: list[int], mob_load: list[int]) -> None:
        pe = min(range(N_PE), key=lambda i: pe_load[i])
        pe_pos = core_position(pe, is_mob=False)
        # route inputs from the least-loaded MOB (static route, compile-time)
        if t.in_bytes:
            mob = min(range(N_MOB), key=lambda i: mob_load[i])
            hops = torus_hops(core_position(mob, True), pe_pos)
            mv = MacroOp(OpClass.MOVE, count=t.in_bytes, hops=hops, tag=f"{t.name}.in")
            prog.add(prog.mobs[mob], phase, mv)
            mob_load[mob] += mv.cycles()
            # single-write-port RF: the PE spends cycles accepting flits
            rx = MacroOp(OpClass.MOVE, count=t.in_bytes, hops=0, tag=f"{t.name}.rx")
            prog.add(prog.pes[pe], phase, rx)
            pe_load[pe] += rx.cycles()
        for cls, n in t.ops.items():
            op = MacroOp(cls=cls, count=n, tag=t.name)
            prog.add(prog.pes[pe], phase, op, fn=t.fn if cls == self._main_cls(t) else None)
            pe_load[pe] += op.cycles()
            if cls is OpClass.MAC8:
                # operand staging: the single-issue core interleaves one RF
                # select/advance op per MAC8 issue (3 read ports feed 4-wide
                # MAC only when operands are already packed in the RF)
                stage = MacroOp(OpClass.ALU32, count=op.cycles(), tag=f"{t.name}.stage")
                prog.add(prog.pes[pe], phase, stage)
                pe_load[pe] += stage.cycles()
        if t.fn is not None:
            # functional payload executes once, in schedule order
            prog.exec_order.append(Slot(MacroOp(OpClass.NOP, tag=t.name), t.fn))
        if t.out_bytes:
            mob = min(range(N_MOB), key=lambda i: mob_load[i])
            hops = torus_hops(pe_pos, core_position(mob, True))
            mv = MacroOp(OpClass.MOVE, count=t.out_bytes, hops=hops, tag=f"{t.name}.out")
            prog.add(prog.pes[pe], phase, mv)
            pe_load[pe] += mv.cycles()

    def _place_memory(self, prog: CGRAProgram, t: Task, phase: int,
                      mob_load: list[int]) -> None:
        mob = min(range(N_MOB), key=lambda i: mob_load[i])
        cls = OpClass.LOAD if t.kind == "load" else OpClass.STORE
        op = MacroOp(cls=cls, count=t.nbytes, bank=_bank_of(t.addr), tag=t.name)
        prog.add(prog.mobs[mob], phase, op, fn=t.fn)
        if t.fn is not None:
            prog.exec_order.append(Slot(op, t.fn))
        mob_load[mob] += op.cycles()

    @staticmethod
    def _main_cls(t: Task) -> OpClass:
        # the dominant op class carries the functional payload marker
        return max(t.ops.items(), key=lambda kv: kv[1])[0] if t.ops else OpClass.NOP

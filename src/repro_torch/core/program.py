"""Microcode program containers for the NX-CGRA fabric (the port's copy of
``repro.core.program``).

A ``CGRAProgram`` holds one statically scheduled instruction stream per core
(16 PEs + 8 MOBs).  Streams are segmented by *barriers* — the paper's
JUMP/CJUMP synchronization points (§III-C): within a segment cores run
independently; a barrier completes when every participating core reaches it.

Functional payloads: a macro-op may carry ``fn`` — a callable executed by the
simulator against the shared value environment — so the same program yields
both bit-exact outputs (via ``core.inumerics`` and the port's integer
kernels, ``kernels.ops``) and cycle/energy accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .isa import MacroOp, OpClass, N_MOB, N_PE


@dataclasses.dataclass
class Slot:
    """A macro-op optionally paired with a functional action."""

    op: MacroOp
    fn: Callable[[dict[str, Any]], None] | None = None


@dataclasses.dataclass
class CoreProgram:
    core_id: int
    is_mob: bool
    # segments[i] = instruction stream between barrier i-1 and barrier i
    segments: list[list[Slot]] = dataclasses.field(default_factory=list)

    def ensure_segments(self, n: int) -> None:
        while len(self.segments) < n:
            self.segments.append([])

    def total_ops(self) -> int:
        return sum(len(s) for s in self.segments)


@dataclasses.dataclass
class CGRAProgram:
    """Full-fabric program: one stream per PE and per MOB."""

    pes: list[CoreProgram]
    mobs: list[CoreProgram]
    n_barriers: int = 0
    context_phases: int = 1   # >1 => kernel needed context switching (sftmx)
    name: str = ""
    # global functional execution order (producer-before-consumer); timing
    # uses the per-core streams, semantics use this list.
    exec_order: list[Slot] = dataclasses.field(default_factory=list)

    @classmethod
    def empty(cls, name: str = "") -> "CGRAProgram":
        return cls(
            pes=[CoreProgram(i, False) for i in range(N_PE)],
            mobs=[CoreProgram(i, True) for i in range(N_MOB)],
            name=name,
        )

    def add(self, core: CoreProgram, segment: int, op: MacroOp, fn=None) -> None:
        core.ensure_segments(segment + 1)
        core.segments[segment].append(Slot(op, fn))
        self.n_barriers = max(self.n_barriers, segment + 1)

    def finalize(self) -> None:
        for c in self.pes + self.mobs:
            c.ensure_segments(self.n_barriers)

    # -- static program statistics -------------------------------------------
    def op_histogram(self) -> dict[OpClass, int]:
        hist: dict[OpClass, int] = {}
        for c in self.pes + self.mobs:
            for seg in c.segments:
                for slot in seg:
                    hist[slot.op.cls] = hist.get(slot.op.cls, 0) + slot.op.count
        return hist

    def programmed_cores(self) -> int:
        return sum(1 for c in self.pes + self.mobs if c.total_ops() > 0)

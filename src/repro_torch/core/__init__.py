"""NX-CGRA core of the port: the paper's contribution (``repro.core``).

- ``inumerics``: integer-only transformer math (shared arithmetic contract)
- ``isa`` / ``program`` / ``scheduler`` / ``simulator``: the programmable
  fabric model (16 PE + 8 MOB, static VLIW microcode, torus NoC); the
  simulator's payloads run on the card's integer kernels
- ``kernel_library``: the six Table-II benchmark kernels as task graphs
- ``costmodel``: gate-level-calibrated metrics (Tables V/VI), and the MoE
  dispatch and serving-TP rules
"""
from . import inumerics  # noqa: F401
from .costmodel import KernelMetrics, metrics_from_sim, area_table, PAPER_TABLE_VI  # noqa: F401
from .kernel_library import BUILDERS  # noqa: F401
from .scheduler import StaticScheduler, Task  # noqa: F401
from .simulator import Simulator, SimResult  # noqa: F401

__all__ = ["BUILDERS", "KernelMetrics", "PAPER_TABLE_VI", "SimResult",
           "Simulator", "StaticScheduler", "Task", "area_table", "inumerics",
           "metrics_from_sim"]

"""Solver statistics (counterpart of robotoc_tpu/solver/statistics.py;
reference include/robotoc/solver/solver_statistics.hpp:17-62), collected
by OCPSolver.solve's host loop over the barrier path."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SolverStatistics:
    convergence: bool = False
    iter: int = 0
    kkt_error: List[float] = dataclasses.field(default_factory=list)
    primal_step_size: List[float] = dataclasses.field(default_factory=list)
    dual_step_size: List[float] = dataclasses.field(default_factory=list)
    ts: List[np.ndarray] = dataclasses.field(default_factory=list)
    mesh_refinement_iter: List[int] = dataclasses.field(
        default_factory=list)
    barrier: List[float] = dataclasses.field(default_factory=list)
    """Barrier parameter path (one entry per mu stage when the solver runs
    the path-following schedule)."""
    cpu_time: float = 0.0   # ms

    def __str__(self):
        lines = [
            "SolverStatistics:",
            f"  convergence: {self.convergence}",
            f"  iter: {self.iter}",
            f"  final kkt_error: "
            f"{self.kkt_error[-1] if self.kkt_error else float('nan')}",
        ]
        if self.mesh_refinement_iter:
            lines.append(
                f"  mesh refinements at: {self.mesh_refinement_iter}")
        if self.cpu_time:
            lines.append(f"  cpu_time: {self.cpu_time:.3f} ms")
        return "\n".join(lines)

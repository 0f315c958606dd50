"""Horizon-stacked LQR data structures (counterpart of
robotoc_tpu/core/structs.py). Fields carry any leading batch dims; in the
solver they are (B, N, ...) for a fleet of B scenarios."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class PerformanceIndex:
    """Five numbers of solver health, one each per scenario (reference
    core/performance_index.hpp:13)."""
    cost: torch.Tensor
    cost_barrier: torch.Tensor
    primal_feasibility: torch.Tensor
    dual_feasibility: torch.Tensor
    kkt_error: torch.Tensor      # sum of squared KKT residuals


@dataclasses.dataclass
class LQRData:
    """Condensed time-varying LQR subproblem over the horizon."""
    A: torch.Tensor       # (..., N, nx, nx) state transition
    B: torch.Tensor       # (..., N, nx, nu)
    xres: torch.Tensor    # (..., N, nx) state-equation residual
    Qxx: torch.Tensor     # (..., N, nx, nx)
    Qxu: torch.Tensor     # (..., N, nx, nu)
    Quu: torch.Tensor     # (..., N, nu, nu)
    lx: torch.Tensor      # (..., N, nx)
    lu: torch.Tensor      # (..., N, nu)
    Qxx_N: torch.Tensor   # (..., nx, nx)
    lx_N: torch.Tensor    # (..., nx)
    # optional pure-state (switching) equality rows
    # Phix dx + Phiu du + Pc = 0, masked per row by sw
    Phix: Optional[torch.Tensor] = None    # (..., N, nf, nx)
    Phiu: Optional[torch.Tensor] = None    # (..., N, nf, nu)
    Pc: Optional[torch.Tensor] = None      # (..., N, nf)
    sw: Optional[torch.Tensor] = None      # (..., N, nf)


@dataclasses.dataclass
class LQRPolicy:
    """Feedback policy from the Riccati sweep."""
    K: torch.Tensor       # (..., N, nu, nx)
    k: torch.Tensor       # (..., N, nu)
    P: torch.Tensor       # (..., N+1, nx, nx)
    p: torch.Tensor       # (..., N+1, nx)
    Mx: Optional[torch.Tensor] = None       # (..., N, nf, nx)
    mx: Optional[torch.Tensor] = None       # (..., N, nf)

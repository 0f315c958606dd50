"""Contact schedule (host-side) -> static-shape per-slot tensors.

Counterpart of robotoc_tpu/planner/contact_sequence.py. `discretize` runs
the Python baking path; the native C++ baker of the JAX package is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ContactPhase:
    active: np.ndarray            # (nc,) bool
    placements: np.ndarray        # (nc, 3) world contact position refs
    friction: np.ndarray          # (nc,)
    start_time: float
    rotations: Optional[np.ndarray] = None   # (nc, 3, 3)

    def __post_init__(self):
        if self.rotations is None:
            self.rotations = np.broadcast_to(
                np.eye(3), (len(self.active), 3, 3)).copy()


class ContactSchedule:
    """Deque-like phase list."""

    def __init__(self, nc: int, default_friction: float = 0.7):
        self.nc = nc
        self.default_friction = default_friction
        self.phases: List[ContactPhase] = []
        self.event_is_impact: List[bool] = []

    def _friction(self, friction):
        return (np.full(self.nc, self.default_friction) if friction is None
                else np.asarray(friction, float))

    def init(self, active, placements, friction=None, t0: float = 0.0,
             rotations=None):
        self.phases = [ContactPhase(np.asarray(active, bool),
                                    np.asarray(placements, float),
                                    self._friction(friction), t0, rotations)]
        self.event_is_impact = []
        return self

    def push_back(self, active, placements, time: float, friction=None,
                  rotations=None):
        active = np.asarray(active, bool)
        is_impact = bool(np.any(active & ~self.phases[-1].active))
        self.phases.append(ContactPhase(active, np.asarray(placements, float),
                                        self._friction(friction), time,
                                        rotations))
        self.event_is_impact.append(is_impact)

    def phase_at(self, t: float) -> ContactPhase:
        ph = self.phases[0]
        for p in self.phases[1:]:
            if t >= p.start_time:
                ph = p
            else:
                break
        return ph


@dataclasses.dataclass
class GridData:
    """Per-slot tensors consumed by the stage pipeline. S = N + 1 +
    n_reserved slots; the last slot is terminal."""
    dt: torch.Tensor            # (S-1,)
    t: torch.Tensor             # (S,)
    contact_mask: torch.Tensor  # (S, nc) 1.0/0.0
    p_ref: torch.Tensor         # (S, nc, 3)
    friction: torch.Tensor      # (S, nc)
    is_impact: torch.Tensor     # (S,)
    imp_mask: torch.Tensor      # (S, nc)
    R_ref: torch.Tensor         # (S, nc, 3, 3)

    @property
    def n_slots(self):
        return self.t.shape[-1]


def discretize(schedule: ContactSchedule, t0: float, T: float, N: int,
               n_reserved: int = 0, dtype=torch.float64,
               device=None) -> GridData:
    """Slot tensors with the uniform grid boundary nearest each event
    snapped to the exact event time (values change, shapes never)."""
    from ..device import resolve
    dev = resolve(device)
    dt = T / N
    nc = schedule.nc
    bounds = t0 + dt * np.arange(N + 1)
    impacts = {}
    for k, p in enumerate(schedule.phases[1:]):
        te = p.start_time
        if t0 < te <= t0 + T + 1e-9:
            b = int(round((te - t0) / dt))
            b = min(max(b, 1), N)
            bounds[b] = te
            newly = p.active & ~schedule.phases[k].active
            if schedule.event_is_impact[k]:
                impacts[b] = impacts.get(b, np.zeros(nc, bool)) | newly
    bounds = np.maximum.accumulate(bounds)
    n_impacts = len(impacts)
    if n_impacts > n_reserved:
        raise ValueError(f"{n_impacts} impact events in horizon but only "
                         f"{n_reserved} reserved slots")

    rows = []   # (t, dt, active, p_ref, fric, is_impact, imp_mask, R_ref)

    def status(t):
        ph = schedule.phase_at(t + 1e-9)
        return (ph.active.astype(float), ph.placements, ph.friction,
                ph.rotations)

    for k in range(N):
        tk, tk1 = bounds[k], bounds[k + 1]
        if k in impacts:
            a, p, f, R = status(tk)
            rows.append((tk, 0.0, a, p, f, 1.0, impacts[k].astype(float), R))
        a, p, f, R = status(tk)
        rows.append((tk, tk1 - tk, a, p, f, 0.0, np.zeros(nc), R))
    t_end = bounds[N]
    for _ in range(n_reserved - n_impacts):
        a, p, f, R = status(t_end)
        rows.append((t_end, 0.0, a, p, f, 1.0, np.zeros(nc), R))
    if N in impacts:
        a, p, f, R = status(t_end)
        rows.append((t_end, 0.0, a, p, f, 1.0, impacts[N].astype(float), R))
    a, p, f, R = status(t_end)
    rows.append((t_end, 0.0, a, p, f, 0.0, np.zeros(nc), R))  # terminal

    def arr(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=dev)

    return GridData(
        dt=arr([r[1] for r in rows[:-1]]), t=arr([r[0] for r in rows]),
        contact_mask=arr([r[2] for r in rows]),
        p_ref=arr([r[3] for r in rows]), friction=arr([r[4] for r in rows]),
        is_impact=arr([r[5] for r in rows]),
        imp_mask=arr([r[6] for r in rows]), R_ref=arr([r[7] for r in rows]))

"""MPCJump: the whole-body jump MPC (counterpart of
robotoc_tpu/mpc/mpc_jump.py).

A jump is one stance -> flight -> landing-impact sequence. `init` plans the
landing placements (JumpFootStepPlanner: the feet displaced by the jump
length and turned by the jump yaw about their centre), fixes the lift-off
and touchdown times and solves the initial OCP; `update_solution` slides
the horizon over those fixed times at MPC rate. The landing is constrained
by the switching constraint two grids before the impact slot, and the
Newton updates are globalised by the KKT-residual line search: on this
problem class full Gauss-Newton steps limit-cycle. Optimising the switching
times (init(..., sto=True)) needs the STO solver, which is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..constraints.joint_limits import make_joint_limits
from ..costs.config_cost import make_config_cost
from ..models import contacts as ct
from ..models import robot as rm
from ..planner.contact_sequence import ContactSchedule, discretize
from ..solver.ocp_solver import OCPSolver, SolverOptions, align_solution
from .control_policy import ControlPolicy
from .gait_mpc import FEET_DEFAULT, _np


class JumpFootStepPlanner:
    """Jump landing placements: the current foot positions displaced by
    the commanded jump length and turned by the commanded yaw about their
    centre."""

    def __init__(self, model, feet):
        self.model = model
        self.feet = feet
        self.jump_length = np.zeros(3)
        self.jump_yaw = 0.0

    def set_jump_pattern(self, jump_length, jump_yaw: float):
        self.jump_length = np.asarray(jump_length, float)
        self.jump_yaw = float(jump_yaw)

    def plan(self, q):
        """(p0, p1) (nc, 3) numpy: the feet at configuration q, and their
        landing targets."""
        m = self.model
        q = torch.as_tensor(q, dtype=m.dtype, device=m.device)
        Rw, pw = rm.forward_kinematics(m, q)
        p0 = np.stack([_np(rm.frame_placement(m, m.frame_id(f), Rw, pw)[1])
                       for f in self.feet])
        c = p0.mean(axis=0)
        cy, sy = math.cos(self.jump_yaw), math.sin(self.jump_yaw)
        Ry = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        p1 = (p0 - c) @ Ry.T + c + self.jump_length
        return p0, p1


class MPCJump:
    """The jump MPC: one configuration cost, joint limits, one reserved
    impact slot, switching constraints and the KKT-residual search."""

    def __init__(self, model: rm.RobotModel, T: float, N: int,
                 feet=None, friction_coefficient: float = 0.5,
                 options: Optional[SolverOptions] = None,
                 baumgarte_time_step: float = 0.05,
                 contact_types=None):
        self.model = model
        feet = feet or FEET_DEFAULT
        self.feet = feet
        self.nc = len(feet)
        self.contacts = ct.make_contacts(
            model, feet, types=contact_types,
            baumgarte_time_step=baumgarte_time_step)
        self.T, self.N = float(T), int(N)
        self.friction = friction_coefficient
        nv, dimu = model.nv, model.dimu
        kw = dict(dtype=model.dtype, device=model.device)
        # x free, the base's height and rotation dominant, light joints;
        # the jump's displacement enters through q_ref (set by `init`);
        # impact rows on the base rotation and the joints
        qw = torch.tensor([1.0, 0, 0, 1.0, 1.0, 1.0] + [0.001] * (nv - 6),
                          **kw)
        self.config_cost = make_config_cost(
            model, q_weight=qw,
            v_weight=torch.full((nv,), 1.0, **kw),
            a_weight=torch.full((nv,), 1e-6, **kw),
            u_weight=torch.full((dimu,), 1e-2, **kw),
            q_weight_terminal=qw.clone(),
            v_weight_terminal=torch.full((nv,), 1.0, **kw),
            q_weight_impact=torch.tensor(
                [0, 0, 0, 100.0, 100, 100] + [0.1] * (nv - 6), **kw),
            v_weight_impact=torch.full((nv,), 1.0, **kw),
            dv_weight_impact=torch.full((nv,), 1e-6, **kw))
        self.limits = make_joint_limits(model)
        self.n_reserved = 1
        self._options = options or SolverOptions(
            max_iter=2, switching_constraints=True,
            enable_line_search="kkt")
        self.planner = JumpFootStepPlanner(model, feet)
        self.flying_time = 0.3
        self.ground_time = 0.3
        self._solver: Optional[OCPSolver] = None
        self.sol = None
        self.grid = None
        self.lqr_policy = None
        self.t_lift = None
        self.t_land = None
        self._p_stance = None
        self._p_land = None

    def set_jump_pattern(self, jump_length, jump_yaw: float,
                         flying_time: float, ground_time: float):
        self.planner.set_jump_pattern(jump_length, jump_yaw)
        self.flying_time = float(flying_time)
        self.ground_time = float(ground_time)

    # ------------------------------------------------------------------
    def _schedule(self, t: float):
        """The three-phase schedule around the fixed (t_lift, t_land), as
        much of it as the horizon from t reaches."""
        sched = ContactSchedule(nc=self.nc, default_friction=self.friction)
        if t < self.t_lift:
            sched.init([True] * self.nc, self._p_stance)
            if self.t_lift <= t + self.T + 1e-9:
                sched.push_back([False] * self.nc, self._p_stance,
                                self.t_lift)
                if self.t_land <= t + self.T + 1e-9:
                    sched.push_back([True] * self.nc, self._p_land,
                                    self.t_land)
        elif t < self.t_land:
            sched.init([False] * self.nc, self._p_stance)
            if self.t_land <= t + self.T + 1e-9:
                sched.push_back([True] * self.nc, self._p_land,
                                self.t_land)
        else:
            sched.init([True] * self.nc, self._p_land)
        return sched

    def _grid(self, t: float):
        return discretize(self._schedule(t), t, self.T, self.N,
                          n_reserved=self.n_reserved, dtype=self.model.dtype,
                          device=self.model.device)

    def init(self, t, q, v, num_iters: int = 30, sto: bool = False,
             min_flying_time: float = 0.1, min_ground_time: float = 0.1):
        """Plan the jump and solve the initial OCP with num_iters Newton
        updates; returns the last update's KKT. sto=True (the switching
        times optimised first) raises NotImplementedError: the STO solver
        is not ported, and fixed times would be another answer."""
        if sto:
            raise NotImplementedError(
                "MPCJump.init(sto=True): switching-time optimization (STO, "
                "solver/sto_solver.py) is not ported")
        m = self.model
        kw = dict(dtype=m.dtype, device=m.device)
        q = torch.as_tensor(q, **kw)
        v = torch.as_tensor(v, **kw)
        p0, p1 = self.planner.plan(q)
        self._p_stance, self._p_land = p0, p1
        # q_ref: the configuration displaced by the planned jump
        disp = torch.as_tensor(p1.mean(axis=0) - p0.mean(axis=0), **kw)
        self.config_cost = dataclasses.replace(
            self.config_cost, q_ref=torch.cat([q[:3] + disp, q[3:]]))
        self.t_lift = float(t) + self.ground_time
        self.t_land = self.t_lift + self.flying_time
        grid = self._grid(float(t))
        if self._solver is None:
            self._solver = OCPSolver(
                m, self.contacts, (self.config_cost,), self.limits,
                self.T, self.N, options=self._options,
                n_reserved_events=self.n_reserved)
        sol = self._solver.init_solution(grid, q, v)
        kkt = float("inf")
        for _ in range(num_iters):
            sol, kkt, _, policy = self._solver.update(
                grid, q, v, sol, costs=(self.config_cost,))
            self.lqr_policy = policy
        self.sol, self.grid = sol, grid
        return float(kkt)

    def update_solution(self, t, dt, q, v, max_iter: int = 2):
        """One MPC update: the grid at t, the warm start re-aligned to it,
        max_iter Newton updates; returns the last update's KKT."""
        kw = dict(dtype=self.model.dtype, device=self.model.device)
        q = torch.as_tensor(q, **kw)
        v = torch.as_tensor(v, **kw)
        grid = self._grid(float(t))
        sol = align_solution(self.sol, self.grid, grid, model=self.model)
        kkt = None
        for _ in range(max_iter):
            sol, kkt, _, policy = self._solver.update(
                grid, q, v, sol, costs=(self.config_cost,))
            self.lqr_policy = policy
        self.sol, self.grid = sol, grid
        return float(kkt)

    # ------------------------------------------------------------------
    def get_initial_control_input(self):
        return self.sol.u[..., 0, :]

    def get_control_policy(self, t: float):
        """The interpolated PD + feedforward policy at time t."""
        return ControlPolicy.from_solution(self.model, self.grid, self.sol,
                                           self.lqr_policy, t)

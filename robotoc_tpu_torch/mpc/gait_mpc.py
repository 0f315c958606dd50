"""Periodic-gait whole-body MPC (counterpart of robotoc_tpu/mpc/gait_mpc.py).

A gait is a cycle of swing sets plus (swing_time, stance_time |
flying_time) timing:

    trot         cycle = ((LH, RF), (LF, RH))          (mpc_trot.MPCTrot)
    pace         cycle = ((RF, RH), (LF, LH))          MPCPace
    crawl        cycle = ((RH,), (RF,), (LH,), (LF,))  MPCCrawl
    flying trot  cycle = ((LH, RF), (LF, RH)), flying_time > 0: every foot
                 airborne between steps, the touchdown an impact
    biped walk   cycle = ((r_sole,), (l_sole,))        MPCBipedWalk

Each control update re-plans the steps on the host, bakes the sliding
contact schedule into a GridData and the step-indexed reference tensors
into the cost stack (values change, shapes never), and runs Newton updates
of the contact OCP (solver/ocp_solver.py) with impact slots and switching
constraints. Pace and crawl track the base rotation through a second
ConfigurationSpaceCost whose time-varying reference
(refs.StepConfigurationRef) slerps the base quaternion between the steps;
the others through BaseRotationCost.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..constraints.joint_limits import make_joint_limits
from ..costs.config_cost import make_config_cost
from ..costs.task_cost import BaseRotationCost, MultiFrameTaskCost
from ..models import contacts as ct
from ..models import robot as rm
from ..planner.contact_sequence import ContactSchedule, discretize
from ..solver.ocp_solver import OCPSolver, SolverOptions, align_solution
from .control_policy import ControlPolicy
from .foot_step_planner import GaitFootStepPlanner
from .refs import (StepBaseRotRef, StepCoMRef, StepConfigurationRef,
                   StepSwingFootRef)

FEET_DEFAULT = ["LF_FOOT", "LH_FOOT", "RF_FOOT", "RH_FOOT"]


class PeriodicGaitMPC:
    """Whole-body MPC over a periodic gait cycle."""

    #: swing sets per step within one gait cycle; override per gait
    CYCLE: Tuple[Tuple[int, ...], ...] = ((1, 2), (0, 3))
    #: track the base rotation with a ConfigurationSpaceCost on a
    #: time-varying StepConfigurationRef instead of BaseRotationCost
    BASE_ROT_VIA_CONFIG_REF: bool = False

    def __init__(self, model: rm.RobotModel, T: float, N: int,
                 feet=None, friction_coefficient: float = 0.5,
                 options: SolverOptions = SolverOptions(
                     switching_constraints=True),
                 baumgarte_time_step: float = 0.05,
                 contact_types=None, rect=(0.05, 0.025)):
        self.model = model
        feet = feet or FEET_DEFAULT
        self.feet = feet
        self.nc = len(feet)
        self.contacts = ct.make_contacts(
            model, feet, types=contact_types,
            baumgarte_time_step=baumgarte_time_step, rect=rect)
        self.T, self.N = float(T), int(N)
        self.friction = friction_coefficient
        nv, dimu = model.nv, model.dimu
        kw = dict(dtype=model.dtype, device=model.device)
        # the trot stack: joints 0.001 (impact 1), v 1, u 1e-2, base
        # rotation 1e3 through its own time-varying reference, feet 1e4 and
        # CoM 1e3 at stages only (terminal and impact task weights zero)
        self.config_cost = make_config_cost(
            model,
            q_weight=torch.tensor([0.0] * 6 + [0.001] * (nv - 6), **kw),
            v_weight=torch.full((nv,), 1.0, **kw),
            a_weight=torch.full((nv,), 1e-6, **kw),
            u_weight=torch.full((dimu,), 1e-2, **kw),
            q_weight_terminal=torch.tensor([0.0] * 6 + [0.001] * (nv - 6),
                                           **kw),
            v_weight_terminal=torch.full((nv,), 1.0, **kw),
            q_weight_impact=torch.tensor([0.0] * 6 + [1.0] * (nv - 6), **kw),
            v_weight_impact=torch.full((nv,), 1.0, **kw),
            dv_weight_impact=torch.full((nv,), 1e-3, **kw))
        self.base_rot_weight = torch.full((3,), 1000.0, **kw)
        self.foot_weight = torch.full((3,), 1e4, **kw)
        self.com_weight = torch.full((3,), 1e3, **kw)
        self.limits = make_joint_limits(model)
        self.n_reserved = max(2, int(math.ceil(T / 0.2)) + 1)
        self.planner: Optional[GaitFootStepPlanner] = None
        self.swing_height = 0.1
        self.swing_time = 0.25
        self.stance_time = 0.0
        self.flying_time = 0.0
        self.swing_start_time = 0.5
        self._solver: Optional[OCPSolver] = None
        self._options = options
        self.sol = None
        self.grid = None
        self._costs = None

    # ------------------------------------------------------------------
    def make_planner(self, first_step_factor: float = 0.5, terrain=None):
        return GaitFootStepPlanner(self.model, self.feet, self.CYCLE,
                                   first_step_factor, terrain=terrain)

    def set_gait_pattern(self, planner: GaitFootStepPlanner,
                         swing_height: float, swing_time: float,
                         stance_time: float, swing_start_time: float,
                         flying_time: float = 0.0):
        self.planner = planner
        planner.has_flight_phase = flying_time > 0.0
        self.swing_height = float(swing_height)
        self.swing_time = float(swing_time)
        self.stance_time = float(stance_time)
        self.flying_time = float(flying_time)
        self.swing_start_time = float(swing_start_time)
        period = swing_time + stance_time + flying_time
        self.n_reserved = int(math.ceil(self.T / period)) + 2
        self.K = self.n_reserved + 2      # planner step cap

    # -- gait timing ------------------------------------------------------
    def _step_period(self) -> float:
        return self.swing_time + self.stance_time + self.flying_time

    def _ts(self, s: int) -> float:
        return self.swing_start_time + (s - 1) * self._step_period()

    def _current_swing(self, t: float) -> int:
        if t < self.swing_start_time:
            return 0
        return int(np.floor((t - self.swing_start_time)
                            / self._step_period())) + 1

    def _swing_set(self, s: int):
        return self.planner.cycle[(s - 1) % len(self.planner.cycle)]

    def _active_at(self, t: float):
        s = self._current_swing(t)
        if s == 0:
            return [True] * self.nc
        ts = self._ts(s)
        if t <= ts + self.swing_time + 1e-9:
            sw = self._swing_set(s)
            return [i not in sw for i in range(self.nc)]
        if self.flying_time > 0 and t <= ts + self.swing_time \
                + self.flying_time + 1e-9:
            return [False] * self.nc          # flight
        return [True] * self.nc               # stance window

    def _swing_window(self, s: int):
        """(start, duration) of step s's foot-swing trajectory."""
        ts = self._ts(s)
        if self.flying_time > 0:
            start = ts - self.flying_time if s > 1 else ts
            return start, self.swing_time + self.flying_time + (
                self.flying_time if s > 1 else 0.0)
        return ts, self.swing_time

    # ------------------------------------------------------------------
    def _build_schedule_and_costs(self, t, q, v):
        """Plan future steps; bake the schedule and the reference tensors.
        Returns (GridData, (config cost, base-rotation cost, task cost))."""
        m = self.model
        kw = dict(dtype=m.dtype, device=m.device)
        nc = self.nc
        q, v = _np(q), _np(v)
        s_now = self._current_swing(t)
        active_now = self._active_at(t)
        plan = self.planner.plan(t, q, v, active_now, self.K)
        if plan is None:
            raise RuntimeError("planner failed (unsupported contact state)")
        positions, coms, Rs = plan

        sched = ContactSchedule(nc=nc, default_friction=self.friction)
        sched.init(active_now, positions[0])
        j = 1
        s = s_now if s_now > 0 else 0
        while True:
            s_next = s + 1
            ts = self._ts(s_next)
            te = ts + self.swing_time
            if ts > t + self.T + 1e-9:
                break
            if ts > t:                 # swing begins (lift of swing set)
                sw = self._swing_set(s_next)
                sched.push_back([i not in sw for i in range(nc)],
                                positions[min(j, self.K)], ts)
            if self.flying_time > 0:
                if te > t and te <= t + self.T + 1e-9:
                    sched.push_back([False] * nc,
                                    positions[min(j, self.K)], te)
            elif self.stance_time > 0 and te > t \
                    and te <= t + self.T + 1e-9:
                sched.push_back([True] * nc, positions[min(j, self.K)], te)
            s = s_next
            j += 1

        grid = discretize(sched, t, self.T, self.N,
                          n_reserved=self.n_reserved, dtype=m.dtype,
                          device=m.device)

        K = self.K
        npos = positions.shape[0]

        def phase_of(s_abs):
            return s_abs - s_now if s_now >= 1 else s_abs

        # swing-foot references, all feet baked in numpy first
        ts_all = np.full((nc, K), 1e9)
        durs_all = np.full((nc, K), self.swing_time)
        xp_all = np.zeros((nc, K, 3))
        xn_all = np.zeros((nc, K, 3))
        val_all = np.zeros((nc, K))
        for i in range(nc):
            slot = 0
            for s_abs in range(max(1, s_now), s_now + K + 1):
                if i in self._swing_set(s_abs) and slot < K:
                    pph = min(phase_of(s_abs), npos - 2)
                    w0, wd = self._swing_window(s_abs)
                    ts_all[i, slot] = w0
                    durs_all[i, slot] = wd
                    xp_all[i, slot] = positions[pph][i]
                    xn_all[i, slot] = positions[pph + 1][i]
                    val_all[i, slot] = 1.0
                    slot += 1
            order = np.argsort(ts_all[i])
            for arr in (ts_all, durs_all, xp_all, xn_all, val_all):
                arr[i] = arr[i][order]
        T_ = lambda x: torch.as_tensor(np.asarray(x), **kw)  # noqa: E731
        foot_refs = StepSwingFootRef(
            x_prev=T_(xp_all), x_next=T_(xn_all), t_start=T_(ts_all),
            swing_time=T_(durs_all),
            step_height=T_(np.full(nc, self.swing_height)),
            valid=T_(val_all))
        # CoM and base-rotation references, step indexing as above
        t_start = np.full(K, 1e9)
        com_steps = np.zeros((K + 1, 3))
        quat_steps = np.zeros((K + 1, 4))
        valid = np.zeros(K)
        first = min(phase_of(max(1, s_now)), npos - 2)
        com_steps[0] = coms[first]
        quat_steps[0] = _yaw_quat(Rs[first])
        for k, s_abs in enumerate(range(max(1, s_now), s_now + K)):
            pph = min(phase_of(s_abs), npos - 2)
            t_start[k] = self._ts(s_abs)
            com_steps[k + 1] = coms[pph + 1]
            quat_steps[k + 1] = _yaw_quat(Rs[pph + 1])
            valid[k] = 1.0
        active_time = T_(self.swing_time + self.flying_time)
        com_ref = StepCoMRef(com_steps=T_(com_steps), t_start=T_(t_start),
                             swing_time=active_time, valid=T_(valid))
        if self.BASE_ROT_VIA_CONFIG_REF:
            # the base-rotation weights on the base-rotation tangent rows of
            # a second configuration cost with a slerped base quaternion
            w_rot = torch.cat([torch.zeros(3, **kw), self.base_rot_weight,
                               torch.zeros(m.nv - 6, **kw)])
            base_rot_cost = make_config_cost(
                m, q_ref_fn=StepConfigurationRef(
                    q=self.config_cost.q_ref, quat_steps=T_(quat_steps),
                    t_start=T_(t_start), swing_time=active_time,
                    valid=T_(valid)),
                q_weight=w_rot, q_weight_terminal=w_rot,
                q_weight_impact=w_rot)
        else:
            base_rot_cost = BaseRotationCost(
                weight=self.base_rot_weight,
                weight_terminal=self.base_rot_weight,
                weight_impact=self.base_rot_weight,
                ref=StepBaseRotRef(quat_steps=T_(quat_steps),
                                   t_start=T_(t_start),
                                   swing_time=active_time, valid=T_(valid)))
        zero3 = torch.zeros(3, **kw)
        task_cost = MultiFrameTaskCost(
            frame_ids=self.contacts.frame_ids, foot_weight=self.foot_weight,
            foot_weight_terminal=zero3, foot_weight_impact=zero3,
            com_weight=self.com_weight, com_weight_terminal=zero3,
            com_weight_impact=zero3, foot_refs=foot_refs, com_ref=com_ref)
        return grid, (self.config_cost, base_rot_cost, task_cost)

    # ------------------------------------------------------------------
    def _solver_for(self, costs):
        if self._solver is None:
            self._solver = OCPSolver(self.model, self.contacts, costs,
                                     self.limits, self.T, self.N,
                                     options=self._options,
                                     n_reserved_events=self.n_reserved)
        return self._solver

    def init(self, t, q, v, num_iters: int = 20):
        """Solve the initial OCP with num_iters Newton updates."""
        kw = dict(dtype=self.model.dtype, device=self.model.device)
        q, v = torch.as_tensor(q, **kw), torch.as_tensor(v, **kw)
        self.config_cost = dataclasses.replace(self.config_cost, q_ref=q)
        self.planner.init(_np(q))
        grid, costs = self._build_schedule_and_costs(float(t), q, v)
        solver = self._solver_for(costs)
        sol = solver.init_solution(grid, q, v)
        kkt, policy = float("inf"), None
        for _ in range(num_iters):
            sol, kkt, _, policy = solver.update(grid, q, v, sol, costs=costs)
        self.sol, self.grid, self._costs = sol, grid, costs
        self.lqr_policy = policy
        return float(kkt)

    def update_solution(self, t, dt, q, v, max_iter: int = 2):
        """One MPC update: re-plan, re-align the warm start, max_iter
        Newton updates."""
        kw = dict(dtype=self.model.dtype, device=self.model.device)
        q, v = torch.as_tensor(q, **kw), torch.as_tensor(v, **kw)
        grid, costs = self._build_schedule_and_costs(float(t), q, v)
        sol = align_solution(self.sol, self.grid, grid, model=self.model)
        kkt = None
        for _ in range(max_iter):
            sol, kkt, _, policy = self._solver.update(grid, q, v, sol,
                                                      costs=costs)
        self.sol, self.grid, self._costs = sol, grid, costs
        self.lqr_policy = policy
        return float(kkt)

    def kkt_error(self, t, q, v):
        return float(self._solver.kkt_error(self.grid, q, v, self.sol,
                                            costs=self._costs))

    # ------------------------------------------------------------------
    def get_initial_control_input(self):
        return self.sol.u[..., 0, :]

    def get_control_policy(self, t: float):
        """The interpolated PD + feedforward policy at time t."""
        return ControlPolicy.from_solution(self.model, self.grid, self.sol,
                                           self.lqr_policy, t)


class MPCPace(PeriodicGaitMPC):
    """Pace: lateral pairs, the right side (RF, RH) first."""
    CYCLE = ((2, 3), (0, 1))
    BASE_ROT_VIA_CONFIG_REF = True


class MPCCrawl(PeriodicGaitMPC):
    """Crawl: one foot at a time, in the order RH, RF, LH, LF."""
    CYCLE = ((3,), (2,), (1,), (0,))
    BASE_ROT_VIA_CONFIG_REF = True


class MPCFlyingTrot(PeriodicGaitMPC):
    """Flying trot: diagonal pairs with a flight phase (no foot in
    contact) of flying_time between steps."""
    CYCLE = ((1, 2), (0, 3))

    def set_gait_pattern(self, planner, swing_height, swing_time,
                         flying_time, swing_start_time):
        super().set_gait_pattern(planner, swing_height, swing_time,
                                 stance_time=0.0,
                                 swing_start_time=swing_start_time,
                                 flying_time=flying_time)


class MPCBipedWalk(PeriodicGaitMPC):
    """Humanoid walking MPC on two surface contacts (6-D wrenches, 17-row
    wrench cones). Feet order (l_sole, r_sole); the right foot swings
    first."""
    CYCLE = ((1,), (0,))
    FEET_BIPED = ["l_sole", "r_sole"]

    def __init__(self, model: rm.RobotModel, T: float, N: int,
                 feet=None, friction_coefficient: float = 0.5,
                 options: SolverOptions = SolverOptions(
                     switching_constraints=True),
                 baumgarte_time_step: float = 0.05,
                 wrench_cone_rect=(0.1, 0.05)):
        feet = feet or self.FEET_BIPED
        super().__init__(model, T, N, feet=feet,
                         friction_coefficient=friction_coefficient,
                         options=options,
                         baumgarte_time_step=baumgarte_time_step,
                         contact_types=(ct.SURFACE,) * len(feet),
                         rect=wrench_cone_rect)
        nv, dimu = model.nv, model.dimu
        kw = dict(dtype=model.dtype, device=model.device)
        # the biped stack: base rotation 1e3 and joints 0.001 (impact 1),
        # v 1, u 1e-2, impact dv 1e-2; base rotation, feet and CoM as the
        # trot's
        qw = [0.0, 0.0, 0.0, 1000.0, 1000.0, 1000.0]
        self.config_cost = make_config_cost(
            model,
            q_weight=torch.tensor(qw + [0.001] * (nv - 6), **kw),
            v_weight=torch.full((nv,), 1.0, **kw),
            a_weight=torch.full((nv,), 1e-6, **kw),
            u_weight=torch.full((dimu,), 1e-2, **kw),
            q_weight_terminal=torch.tensor(qw + [0.001] * (nv - 6), **kw),
            v_weight_terminal=torch.full((nv,), 1.0, **kw),
            q_weight_impact=torch.tensor(qw + [1.0] * (nv - 6), **kw),
            v_weight_impact=torch.full((nv,), 1.0, **kw),
            dv_weight_impact=torch.full((nv,), 1e-2, **kw))
        self.foot_weight = torch.full((3,), 1e4, **kw)
        self.com_weight = torch.full((3,), 1e3, **kw)

    def set_wrench_cone_rectangular(self, X: float, Y: float):
        """Half-lengths (X, Y) of the sole rectangle of every contact's
        wrench cone."""
        self.contacts = dataclasses.replace(
            self.contacts, rect=torch.tensor(
                [X, Y], dtype=self.model.dtype,
                device=self.model.device).expand(self.nc, 2).clone())


def _np(x):
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=float)


def _yaw_quat(R):
    """Quaternion (x, y, z, w) of the yaw rotation R (planner rotations are
    pure yaw)."""
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([0.0, 0.0, np.sin(0.5 * yaw), np.cos(0.5 * yaw)])


def pace_foot_step_planner(model, feet=None, first_step_factor=0.5):
    return GaitFootStepPlanner(model, feet or FEET_DEFAULT, MPCPace.CYCLE,
                               first_step_factor)


def crawl_foot_step_planner(model, feet=None, first_step_factor=0.5):
    return GaitFootStepPlanner(model, feet or FEET_DEFAULT, MPCCrawl.CYCLE,
                               first_step_factor)


def flying_trot_foot_step_planner(model, feet=None, first_step_factor=0.5):
    return GaitFootStepPlanner(model, feet or FEET_DEFAULT,
                               MPCFlyingTrot.CYCLE, first_step_factor)

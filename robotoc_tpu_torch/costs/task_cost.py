"""Task-space and CoM tracking costs with time-varying references
(counterpart of robotoc_tpu/costs/task_cost.py): frame-position, CoM, SE(3)
and base-orientation tracking, local contact forces, the fused multi-frame
task cost (swing feet + CoM) of the gait stack, and their references.

A reference is a callable of the grid time: `ref(t)` takes t of any shape
and returns (value, active) with t's shape in front (t is 0-dim per sample
under torch.func.vmap). The periodic references are closed-form formulas
of t; the discrete-time ones pick their contact phase by counting the
phase bounds at or before t and take its rows with a one-hot sum (exact,
and batched under vmap). Gauss-Newton quadratization: with the residual
r(q) = task(q) - ref(t) and its tangent Jacobian J, lq = dt J^T W r and
Qqq = dt J^T W J."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jacfwd

from ..device import resolve
from ..models import robot as rm
from ..ops import lie
from .base import ImpactQuad, StageQuad, TerminalQuad


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------

def _ones(t, like):
    return torch.ones(t.shape, dtype=like.dtype, device=like.device)


def _lead(x, t):
    """x (...) with t's shape in front."""
    return x.expand(t.shape + tuple(x.shape))


def _lift(x, z):
    """Positions x (..., 3) raised by z (...)."""
    return torch.cat([x[..., :2], x[..., 2:] + z.unsqueeze(-1)], dim=-1)


@dataclasses.dataclass
class ConstantRef:
    p: torch.Tensor                 # (3,)

    def __call__(self, t):
        return _lead(self.p, t), _ones(t, self.p)


@dataclasses.dataclass
class PeriodicSwingFootRef:
    """Cyclic swing-foot trajectory: active only during swing; linear
    advance by step_length with a sin^2 height profile of apex
    step_height. The fields may carry a leading feet dim (one reference
    per foot stacked, as MultiFrameTaskCost takes them); the values then
    come out as t.shape + (nc, 3) and the active flags as t.shape +
    (nc,)."""
    p0: torch.Tensor                # ([nc,] 3) initial foot position
    step_length: torch.Tensor       # ([nc,] 3) displacement per cycle
    step_height: torch.Tensor       # ([nc])
    t0: torch.Tensor                # ([nc]) first swing start
    period_swing: torch.Tensor      # ([nc])
    period: torch.Tensor            # ([nc]) full cycle duration
    first_half: bool = False
    """If True the first (partial) step advances by half a step."""

    def __call__(self, t):
        # t against each foot's scalars: a trailing dim per stacked dim
        tau = t.reshape(t.shape + (1,) * self.t0.dim()) - self.t0
        cycle = torch.floor(tau / self.period)
        tin = tau - cycle * self.period
        in_swing = (tau >= 0.0) & (tin < self.period_swing)
        phase = torch.clamp(tin / self.period_swing, 0.0, 1.0)
        half = 0.5 if self.first_half else 1.0
        after = (cycle > 0).unsqueeze(-1)
        # completed steps before this cycle
        base = self.p0 + torch.where(
            after, (half + (cycle - 1.0)).unsqueeze(-1) * self.step_length,
            torch.zeros_like(self.step_length))
        adv = torch.where(after, self.step_length, half * self.step_length)
        pos = base + phase.unsqueeze(-1) * adv
        z = self.step_height * torch.sin(torch.pi * phase) ** 2
        return (_lift(pos, z),
                torch.where(in_swing, 1.0, 0.0).to(self.p0.dtype))


@dataclasses.dataclass
class PeriodicCoMRef:
    """CoM reference moving at constant velocity during the active spans
    of each period."""
    com0: torch.Tensor              # (3,)
    vcom: torch.Tensor              # (3,) velocity during active spans
    t0: torch.Tensor                # ()
    period_active: torch.Tensor     # ()
    period_inactive: torch.Tensor   # ()
    first_rate: float = 1.0

    def __call__(self, t):
        period = self.period_active + self.period_inactive
        tau = t - self.t0
        cycle = torch.floor(tau / period)
        tin = tau - cycle * period
        act_t = torch.clamp(tin, min=0.0)
        act_t = torch.where(act_t > self.period_active, self.period_active,
                            act_t)
        total_act = (torch.clamp(cycle, min=0.0) * self.period_active
                     + torch.where(tau >= 0, act_t, torch.zeros_like(act_t)))
        return (self.com0 + self.vcom * total_act.unsqueeze(-1),
                _ones(t, self.com0))


@dataclasses.dataclass
class SE3Ref:
    """Constant SE(3) reference placement."""
    R: torch.Tensor                 # (3, 3)
    p: torch.Tensor                 # (3,)

    def __call__(self, t):
        return (_lead(self.R, t), _lead(self.p, t)), _ones(t, self.p)


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

def tracking_quad(J, r, active, w):
    """(cost, lq, Qqq) of the weighted residual r with tangent Jacobian J,
    weights active * w."""
    aw = active * w
    return (0.5 * torch.sum(aw * r * r), J.T @ (aw * r),
            J.T @ (aw.unsqueeze(-1) * J))


class _Tracking:
    """stage / terminal / impact quadratizations and costs of a tracking
    cost from its `_quad(model, q, t, w)` and `_eval(model, q, t, w)` at
    the weights `weight`, `weight_terminal` and `weight_impact`."""

    def eval_stage(self, model, q, v, a, u, f, t, dt):
        return dt * self._eval(model, q, t, self.weight)

    def eval_terminal(self, model, q, v, t):
        return self._eval(model, q, t, self.weight_terminal)

    def eval_impact(self, model, q, v, dv, t):
        return self._eval(model, q, t, self.weight_impact)

    def quadratize_stage(self, model, nf, q, v, a, u, f, t, dt):
        c, lq, Qqq = self._quad(model, q, t, self.weight)
        out = StageQuad.zeros(model.nv, model.dimu, nf, q.dtype, q.device)
        return out._replace(cost=dt * c, lq=dt * lq, Qqq=dt * Qqq)

    def quadratize_terminal(self, model, q, v, t):
        c, lq, Qqq = self._quad(model, q, t, self.weight_terminal)
        out = TerminalQuad.zeros(model.nv, q.dtype, q.device)
        return out._replace(cost=c, lq=lq, Qqq=Qqq)

    def quadratize_impact(self, model, q, v, dv, t):
        c, lq, Qqq = self._quad(model, q, t, self.weight_impact)
        out = ImpactQuad.zeros(model.nv, q.dtype, q.device)
        return out._replace(cost=c, lq=lq, Qqq=Qqq)


class _ResidualTracking(_Tracking):
    """A tracking cost of the residual `_residual(model, q, t)` ->
    (r, active), quadratized through its tangent Jacobian."""

    def _eval(self, model, q, t, w):
        r, active = self._residual(model, q, t)
        return 0.5 * active * torch.sum(w * r * r)

    def _quad(self, model, q, t, w):
        r, active = self._residual(model, q, t)
        J = rm.tangent_jacobian(
            model, q, lambda qq: self._residual(model, qq, t)[0])
        return tracking_quad(J, r, active, w)


@dataclasses.dataclass
class TaskSpace3DCost(_ResidualTracking):
    """Frame-position tracking: r = p_frame(q) - p_ref(t)."""
    frame_id: int
    weight: torch.Tensor            # (3,)
    weight_terminal: torch.Tensor
    weight_impact: torch.Tensor
    ref: object                     # t -> (p_ref (3,), active)

    def _residual(self, model, q, t):
        p_ref, active = self.ref(t)
        return rm.frame_position(model, self.frame_id, q) - p_ref, active


@dataclasses.dataclass
class CoMCost(_ResidualTracking):
    """Centre-of-mass tracking: r = com(q) - p_ref(t)."""
    weight: torch.Tensor            # (3,)
    weight_terminal: torch.Tensor
    weight_impact: torch.Tensor
    ref: object

    def _residual(self, model, q, t):
        p_ref, active = self.ref(t)
        return rm.com(model, q) - p_ref, active


@dataclasses.dataclass
class TaskSpace6DCost(_ResidualTracking):
    """Frame SE(3) tracking through the log6 residual
    r = log6(M_ref(t)^-1 M(q)), [linear, angular]."""
    frame_id: int
    weight: torch.Tensor            # (6,)
    weight_terminal: torch.Tensor
    weight_impact: torch.Tensor
    ref: object                     # t -> ((R_ref, p_ref), active)

    def _residual(self, model, q, t):
        R_w, p_w = rm.forward_kinematics(model, q)
        R, p = rm.frame_placement(model, self.frame_id, R_w, p_w)
        (R_ref, p_ref), active = self.ref(t)
        Rt = R_ref.transpose(-1, -2)
        return lie.se3_log(Rt @ R, rm._mv(Rt, p - p_ref)), active


@dataclasses.dataclass
class LocalContactForceCost:
    """Quadratic cost on the local contact forces at stages."""
    f_weight: torch.Tensor          # (nf,)
    f_ref: torch.Tensor             # (nf,)

    def eval_stage(self, model, q, v, a, u, f, t, dt):
        return dt * 0.5 * torch.sum(self.f_weight * (f - self.f_ref) ** 2)

    def eval_terminal(self, model, q, v, t):
        return q.new_zeros(())

    def eval_impact(self, model, q, v, dv, t):
        return q.new_zeros(())

    def quadratize_stage(self, model, nf, q, v, a, u, f, t, dt):
        out = StageQuad.zeros(model.nv, model.dimu, nf, q.dtype, q.device)
        return out._replace(
            cost=self.eval_stage(model, q, v, a, u, f, t, dt),
            lf=dt * self.f_weight * (f - self.f_ref),
            Qff=torch.diag(dt * self.f_weight))

    def quadratize_terminal(self, model, q, v, t):
        return TerminalQuad.zeros(model.nv, q.dtype, q.device)

    def quadratize_impact(self, model, q, v, dv, t):
        return ImpactQuad.zeros(model.nv, q.dtype, q.device)


def base_rotation_residual(q, quat_ref):
    """r = log3(R_ref^T R_base(q)) (one sample)."""
    R = lie.quat_to_rot(q[3:7])
    return lie.so3_log(lie.quat_to_rot(quat_ref).T @ R)


def base_rotation_quad(model, q, quat_ref, active, w):
    """(cost, lq, Qqq) of r = log3(R_ref^T R_base(q)) on the base-rotation
    tangent rows; the 3x3 Jacobian by jacfwd over a right perturbation."""
    R = lie.quat_to_rot(q[3:7])
    R_ref = lie.quat_to_rot(quat_ref)
    r = lie.so3_log(R_ref.T @ R)

    def res_of(phi):
        return lie.so3_log(R_ref.T @ (R @ lie.so3_exp(phi)))

    J3 = jacfwd(res_of)(torch.zeros(3, dtype=q.dtype, device=q.device))
    aw = active * w
    rest = model.nv - 6
    lq = F.pad(J3.T @ (aw * r), (3, rest))
    Qqq = F.pad(J3.T @ (aw.unsqueeze(-1) * J3), (3, rest, 3, rest))
    return 0.5 * torch.sum(aw * r * r), lq, Qqq


def task_quad_kin(ref, act, w, task, Jq):
    """(cost, lq, Qqq) of task rows `task` with q-Jacobian Jq against the
    reference `ref`, weights w * act."""
    return tracking_quad(Jq, task - ref, act, w)


@dataclasses.dataclass
class BaseRotationCost(_Tracking):
    """Floating-base orientation tracking against a time-varying
    quaternion reference: r = log3(R_ref(t)^T R_base(q))."""
    weight: torch.Tensor            # (3,)
    weight_terminal: torch.Tensor
    weight_impact: torch.Tensor
    ref: object                     # t -> (quat_ref (4,), active)

    def _quad(self, model, q, t, w):
        quat_ref, active = self.ref(t)
        return base_rotation_quad(model, q, quat_ref, active, w)

    def _eval(self, model, q, t, w):
        quat_ref, active = self.ref(t)
        r = base_rotation_residual(q, quat_ref)
        return 0.5 * active * torch.sum(w * r * r)


@dataclasses.dataclass
class MultiFrameTaskCost:
    """Swing-foot position targets and the CoM target from one kinematic
    chain: task = (feet world positions in contact order, CoM). foot_refs
    is a StepSwingFootRef stacked over the feet; com_ref a StepCoMRef.
    Stage chains that already run the kinematics over `kin_frame_ids` hand
    over (task, dtask/dq) directly (the *_kin methods)."""
    frame_ids: tuple
    foot_weight: torch.Tensor           # (3,)
    foot_weight_terminal: torch.Tensor
    foot_weight_impact: torch.Tensor
    com_weight: torch.Tensor            # (3,)
    com_weight_terminal: torch.Tensor
    com_weight_impact: torch.Tensor
    foot_refs: object
    com_ref: object

    @property
    def kin_frame_ids(self):
        return self.frame_ids

    def _task(self, model, q):
        R_w, p_w = rm.forward_kinematics(model, q)
        feet = [rm.frame_placement(model, fid, R_w, p_w)[1]
                for fid in self.frame_ids]
        ci = rm._mv(R_w, model.com) + p_w
        com = (torch.sum(model.mass.unsqueeze(-1) * ci, dim=-2)
               / torch.sum(model.mass))
        return torch.cat(feet + [com], dim=-1)

    def _ref_active(self, t):
        """(ref, act), each t.shape + (3 nc + 3,)."""
        p_feet, act_feet = self.foot_refs(t)
        p_com, act_com = self.com_ref(t)
        ref = torch.cat([p_feet.reshape(t.shape + (-1,)), p_com], dim=-1)
        act = torch.cat([torch.repeat_interleave(act_feet, 3, dim=-1),
                         act_com.unsqueeze(-1).expand(t.shape + (3,))],
                        dim=-1)
        return ref, act

    def task_weight(self, w_foot, w_com):
        return torch.cat([w_foot.repeat(len(self.frame_ids)), w_com])

    def _quad_kin(self, t, w_foot, w_com, task, Jq):
        ref, act = self._ref_active(t)
        return task_quad_kin(ref, act, self.task_weight(w_foot, w_com),
                             task, Jq)

    def _quad(self, model, q, t, w_foot, w_com):
        task = self._task(model, q)
        Jq = rm.tangent_jacobian(model, q, lambda qq: self._task(model, qq))
        return self._quad_kin(t, w_foot, w_com, task, Jq)

    def _eval(self, model, q, t, w_foot, w_com):
        ref, act = self._ref_active(t)
        w = self.task_weight(w_foot, w_com) * act
        r = self._task(model, q) - ref
        return 0.5 * torch.sum(w * r * r)

    def eval_stage(self, model, q, v, a, u, f, t, dt):
        return dt * self._eval(model, q, t, self.foot_weight,
                               self.com_weight)

    def eval_terminal(self, model, q, v, t):
        return self._eval(model, q, t, self.foot_weight_terminal,
                          self.com_weight_terminal)

    def eval_impact(self, model, q, v, dv, t):
        return self._eval(model, q, t, self.foot_weight_impact,
                          self.com_weight_impact)

    def quadratize_stage_kin(self, model, nf, q, v, a, u, f, t, dt, task,
                             Jq):
        c, lq, Qqq = self._quad_kin(t, self.foot_weight, self.com_weight,
                                    task, Jq)
        out = StageQuad.zeros(model.nv, model.dimu, nf, q.dtype, q.device)
        return out._replace(cost=dt * c, lq=dt * lq, Qqq=dt * Qqq)

    def quadratize_impact_kin(self, model, q, v, dv, t, task, Jq):
        c, lq, Qqq = self._quad_kin(t, self.foot_weight_impact,
                                    self.com_weight_impact, task, Jq)
        out = ImpactQuad.zeros(model.nv, q.dtype, q.device)
        return out._replace(cost=c, lq=lq, Qqq=Qqq)

    def quadratize_stage(self, model, nf, q, v, a, u, f, t, dt):
        c, lq, Qqq = self._quad(model, q, t, self.foot_weight,
                                self.com_weight)
        out = StageQuad.zeros(model.nv, model.dimu, nf, q.dtype, q.device)
        return out._replace(cost=dt * c, lq=dt * lq, Qqq=dt * Qqq)

    def quadratize_terminal(self, model, q, v, t):
        c, lq, Qqq = self._quad(model, q, t, self.foot_weight_terminal,
                                self.com_weight_terminal)
        out = TerminalQuad.zeros(model.nv, q.dtype, q.device)
        return out._replace(cost=c, lq=lq, Qqq=Qqq)

    def quadratize_impact(self, model, q, v, dv, t):
        c, lq, Qqq = self._quad(model, q, t, self.foot_weight_impact,
                                self.com_weight_impact)
        out = ImpactQuad.zeros(model.nv, q.dtype, q.device)
        return out._replace(cost=c, lq=lq, Qqq=Qqq)


# ---------------------------------------------------------------------------
# Discrete-time (per-contact-phase) references of the offline STO problems
# ---------------------------------------------------------------------------

def _phase_rate(bounds, t, first_rate, last_rate):
    """(one-hot (t.shape + (P,)) of the contact phase of t, the rate of t
    through that phase in [0, 1]) for the phase bounds (P + 1,): the phase
    is the count of bounds[1:] at or before t, clipped to [0, P - 1]; the
    first and last phases start their rate at first_rate and last_rate."""
    P = bounds.shape[0] - 1
    idx = torch.clamp(torch.sum((t.unsqueeze(-1) >= bounds[1:])
                                .to(torch.long), dim=-1), 0, P - 1)
    sel = (torch.arange(P, device=bounds.device)
           == idx.unsqueeze(-1)).to(bounds.dtype)
    lo = torch.sum(sel * bounds[:-1], dim=-1)
    dur = torch.clamp(torch.sum(sel * bounds[1:], dim=-1) - lo, min=1e-8)
    rate = torch.clamp((t - lo) / dur, 0.0, 1.0)
    rate = torch.where(idx == 0, first_rate * (1.0 - rate) + rate, rate)
    rate = torch.where(idx == P - 1, last_rate * (1.0 - rate) + rate, rate)
    return sel, rate


def _rows(sel, x):
    """Rows x (P, 3) picked by the one-hot sel (..., P)."""
    return torch.sum(sel.unsqueeze(-1) * x, dim=-2)


@dataclasses.dataclass
class DiscreteTimeSwingFootRef:
    """Swing-foot reference interpolating from the contact position before
    the swing phase to the one after it, with a triangular height profile
    of apex `step_height` at mid-swing; the phase is found from the grid
    time against the baked phase bounds."""
    bounds: torch.Tensor            # (P+1,) phase start times + horizon end
    pos: torch.Tensor               # (P+1, 3) per-phase contact position
    swing: torch.Tensor             # (P,) 1.0 where the contact swings
    step_height: torch.Tensor       # ()
    first_rate: float = 1.0
    last_rate: float = 1.0

    def __call__(self, t):
        sel, rate = _phase_rate(self.bounds, t, self.first_rate,
                                self.last_rate)
        P = self.swing.shape[0]
        # rows max(idx - 1, 0) and idx + 1
        p_from = _rows(sel, torch.cat([self.pos[:1], self.pos[:P - 1]]))
        p_to = _rows(sel, self.pos[1:])
        ref = (1.0 - rate).unsqueeze(-1) * p_from + rate.unsqueeze(-1) * p_to
        z = torch.where(rate < 0.5, 2.0 * rate,
                        2.0 * (1.0 - rate)) * self.step_height
        return _lift(ref, z), torch.sum(sel * self.swing, dim=-1)


@dataclasses.dataclass
class DiscreteTimeCoMRef:
    """CoM reference per contact phase: the phase's anchor, interpolated
    to the next phase's across phases in which some contact swings, held
    during full stance."""
    bounds: torch.Tensor            # (P+1,)
    com: torch.Tensor               # (P+1, 3) per-phase CoM anchors
    has_inactive: torch.Tensor      # (P,) 1.0 where some contact swings
    first_rate: float = 1.0
    last_rate: float = 1.0

    def __call__(self, t):
        sel, rate = _phase_rate(self.bounds, t, self.first_rate,
                                self.last_rate)
        c_here = _rows(sel, self.com[:-1])
        c_next = _rows(sel, self.com[1:])
        moving = torch.sum(sel * self.has_inactive, dim=-1).unsqueeze(-1)
        r = rate.unsqueeze(-1)
        ref = torch.where(moving > 0, (1.0 - r) * c_here + r * c_next,
                          c_here)
        return ref, _ones(t, self.com)


def make_discrete_time_swing_refs(schedule, t_end, step_height,
                                  dtype=torch.float64, device=None):
    """One DiscreteTimeSwingFootRef per contact of a ContactSchedule: the
    phases' start times and t_end as bounds, each phase's placement of the
    contact (the last repeated), swing where it is inactive."""
    kw = dict(dtype=dtype, device=resolve(device))
    bounds = np.array([ph.start_time for ph in schedule.phases]
                      + [float(t_end)])
    refs = []
    for i in range(schedule.nc):
        pos = np.array([ph.placements[i] for ph in schedule.phases])
        pos = np.vstack([pos, pos[-1:]])
        swing = np.array([0.0 if ph.active[i] else 1.0
                          for ph in schedule.phases])
        refs.append(DiscreteTimeSwingFootRef(
            bounds=torch.as_tensor(bounds, **kw),
            pos=torch.as_tensor(pos, **kw),
            swing=torch.as_tensor(swing, **kw),
            step_height=torch.as_tensor(float(step_height), **kw)))
    return refs


def make_discrete_time_com_ref(schedule, t_end, com_to_contact,
                               dtype=torch.float64, device=None):
    """A DiscreteTimeCoMRef of a ContactSchedule: each phase's anchor the
    mean over its active contacts of (placement - com_to_contact) (zero
    without one), and the anchor of a phase between a flight and the
    phase after it the midpoint of its neighbours'."""
    kw = dict(dtype=dtype, device=resolve(device))
    bounds = np.array([ph.start_time for ph in schedule.phases]
                      + [float(t_end)])
    com_to_contact = np.asarray(com_to_contact, float)
    coms, has_inactive = [], []
    prev_had_active = True
    for p, ph in enumerate(schedule.phases):
        act = np.asarray(ph.active, bool)
        n_act = int(act.sum())
        if n_act > 0:
            c = (ph.placements[act] - com_to_contact[act]).mean(axis=0)
        else:
            c = np.zeros(3)
        coms.append(c)
        has_inactive.append(1.0 if n_act < schedule.nc else 0.0)
        if not prev_had_active and p > 1:
            coms[p - 1] = 0.5 * (coms[p - 2] + coms[p])
        prev_had_active = n_act > 0
    coms.append(coms[-1])
    return DiscreteTimeCoMRef(
        bounds=torch.as_tensor(bounds, **kw),
        com=torch.as_tensor(np.array(coms), **kw),
        has_inactive=torch.as_tensor(np.array(has_inactive), **kw))

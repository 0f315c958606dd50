"""The gait cost stack's task costs (counterpart of
robotoc_tpu/costs/task_cost.py): base-orientation tracking and the fused
multi-frame task cost (swing feet + CoM). References are callables of the
grid time (mpc/refs.py). Gauss-Newton quadratization: with the residual
r(q) = task(q) - ref(t) and its tangent Jacobian J,
lq = dt J^T W r and Qqq = dt J^T W J."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.func import jacfwd

from ..models import robot as rm
from ..ops import lie
from .base import ImpactQuad, StageQuad, TerminalQuad


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
    w = w * act
    r = task - ref
    return (0.5 * torch.sum(w * r * r), Jq.T @ (w * r),
            Jq.T @ (w.unsqueeze(-1) * Jq))


@dataclasses.dataclass
class BaseRotationCost:
    """Floating-base orientation tracking against a time-varying
    quaternion reference: r = log3(R_ref(t)^T R_base(q))."""
    weight: torch.Tensor            # (3,)
    weight_terminal: torch.Tensor
    weight_impact: torch.Tensor
    ref: object                     # t -> (quat_ref (4,), active)

    def _quad(self, model, q, t, w):
        quat_ref, active = self.ref(t)
        return base_rotation_quad(model, q, quat_ref, active, w)

    def _eval(self, q, t, w):
        quat_ref, active = self.ref(t)
        r = base_rotation_residual(q, quat_ref)
        return 0.5 * active * torch.sum(w * r * r)

    def eval_stage(self, model, q, v, a, u, f, t, dt):
        return dt * self._eval(q, t, self.weight)

    def eval_terminal(self, model, q, v, t):
        return self._eval(q, t, self.weight_terminal)

    def eval_impact(self, model, q, v, dv, t):
        return self._eval(q, t, self.weight_impact)

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

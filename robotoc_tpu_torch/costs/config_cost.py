"""Configuration-space quadratic cost (counterpart of
robotoc_tpu/costs/config_cost.py): quadratic penalties on (q, v, a, u)
with separate stage, terminal and impact weights, dt-scaled at stages.
The floating-base q-error uses the Lie difference and its tangent
Jacobian. The configuration reference is the constant `q_ref`, or, when
`q_ref_fn` is set, that callable of the grid time (the gait MPCs'
mpc.refs.StepConfigurationRef), evaluated at each stage's, impact's and
terminal's own time. The eval_* functions give the cost alone."""
from __future__ import annotations

import dataclasses

import torch

from ..models import robot as rm


@dataclasses.dataclass
class ConfigurationSpaceCost:
    q_ref: torch.Tensor              # (nq,)
    v_ref: torch.Tensor              # (nv,)
    q_weight: torch.Tensor           # (nv,)
    v_weight: torch.Tensor
    a_weight: torch.Tensor
    u_weight: torch.Tensor           # (dimu,)
    q_weight_terminal: torch.Tensor
    v_weight_terminal: torch.Tensor
    q_weight_impact: torch.Tensor
    v_weight_impact: torch.Tensor
    dv_weight_impact: torch.Tensor
    q_ref_fn: object = None
    """Optional time-varying reference t -> q_ref (t.shape + (nq,)); when
    set it overrides the constant q_ref."""

    def eval_stage(self, model, q, v, a, u, f, t, dt):
        return eval_stage(model, self, q, v, a, u, dt, t)

    def eval_terminal(self, model, q, v, t):
        return eval_terminal(model, self, q, v, t)

    def eval_impact(self, model, q, v, dv, t):
        return eval_impact(model, self, q, v, dv, t)

    def quadratize_stage(self, model, nf, q, v, a, u, f, t, dt):
        from .base import StageQuad
        c, lq, lv, la, lu, Wq, Wv, Wa, Wu = quadratize_stage(
            model, self, q, v, a, u, dt, t)
        out = StageQuad.zeros(model.nv, model.dimu, nf, q.dtype, q.device)
        return out._replace(cost=c, lq=lq, lv=lv, la=la, lu=lu, Qqq=Wq,
                            Qvv=Wv, Qaa=Wa, Quu=Wu)

    def quadratize_terminal(self, model, q, v, t):
        from .base import TerminalQuad
        c, lq, lv, Wq, Wv = quadratize_terminal(model, self, q, v, t)
        return TerminalQuad(cost=c, lq=lq, lv=lv, Qqq=Wq, Qvv=Wv)

    def quadratize_impact(self, model, q, v, dv, t):
        from .base import ImpactQuad
        return ImpactQuad(*quadratize_impact(model, self, q, v, dv, t))


def make_config_cost(model: rm.RobotModel, q_ref=None, q_ref_fn=None,
                     **weights) -> ConfigurationSpaceCost:
    """q_ref_fn: optional callable t -> q_ref, the time-varying reference
    (overrides the constant q_ref when set)."""
    kw = dict(dtype=model.dtype, device=model.device)
    nv, dimu = model.nv, model.dimu
    if q_ref is None:
        q_ref = rm.neutral(model)

    def w(name, n):
        val = weights.get(name)
        if val is None:
            return torch.zeros(n, **kw)
        return torch.as_tensor(val, **kw).expand(n).clone()

    return ConfigurationSpaceCost(
        q_ref=torch.as_tensor(q_ref, **kw), v_ref=w("v_ref", nv),
        q_weight=w("q_weight", nv), v_weight=w("v_weight", nv),
        a_weight=w("a_weight", nv), u_weight=w("u_weight", dimu),
        q_weight_terminal=w("q_weight_terminal", nv),
        v_weight_terminal=w("v_weight_terminal", nv),
        q_weight_impact=w("q_weight_impact", nv),
        v_weight_impact=w("v_weight_impact", nv),
        dv_weight_impact=w("dv_weight_impact", nv), q_ref_fn=q_ref_fn)


def _q_ref(cost, t):
    """The reference at grid time t: q_ref_fn(t) when set, else q_ref."""
    return cost.q_ref if cost.q_ref_fn is None else cost.q_ref_fn(t)


def _qdiff(model, cost, q, t=None):
    """q (-) q_ref(t) (one sample)."""
    q_ref = _q_ref(cost, t)
    if not model.floating_base:
        return q - q_ref
    return rm.difference(model, q_ref, q)


def _qdiff_and_jac(model, cost, q, t=None):
    """q (-) q_ref(t) and the tangent Jacobian J with d(qdiff) = J dq (one
    sample)."""
    q_ref = _q_ref(cost, t)
    if not model.floating_base:
        return q - q_ref, None
    return (rm.difference(model, q_ref, q),
            rm.d_difference_dq1(model, q_ref, q))


def eval_stage(model, cost, q, v, a, u, dt, t=None, qdiff=None):
    if qdiff is None:
        qdiff = _qdiff(model, cost, q, t)
    return dt * (0.5 * (torch.sum(cost.q_weight * qdiff ** 2)
                        + torch.sum(cost.v_weight * (v - cost.v_ref) ** 2)
                        + torch.sum(cost.a_weight * a ** 2)
                        + torch.sum(cost.u_weight * u ** 2)))


def eval_terminal(model, cost, q, v, t=None, qdiff=None):
    if qdiff is None:
        qdiff = _qdiff(model, cost, q, t)
    return 0.5 * (torch.sum(cost.q_weight_terminal * qdiff ** 2)
                  + torch.sum(cost.v_weight_terminal * (v - cost.v_ref) ** 2))


def eval_impact(model, cost, q, v, dv, t=None, qdiff=None):
    if qdiff is None:
        qdiff = _qdiff(model, cost, q, t)
    return 0.5 * (torch.sum(cost.q_weight_impact * qdiff ** 2)
                  + torch.sum(cost.v_weight_impact * (v - cost.v_ref) ** 2)
                  + torch.sum(cost.dv_weight_impact * dv ** 2))


def quadratize_stage(model, cost, q, v, a, u, dt, t=None):
    """(cost, lq, lv, la, lu, Wq, Wv, Wa, Wu), dt-scaled, Gauss-Newton."""
    qdiff, J = _qdiff_and_jac(model, cost, q, t)
    c = eval_stage(model, cost, q, v, a, u, dt, qdiff=qdiff)
    if J is None:
        lq = dt * cost.q_weight * qdiff
        Wq = torch.diag(dt * cost.q_weight)
    else:
        lq = dt * (J.T @ (cost.q_weight * qdiff))
        Wq = dt * (J.T @ (cost.q_weight.unsqueeze(-1) * J))
    return (c, lq, dt * cost.v_weight * (v - cost.v_ref),
            dt * cost.a_weight * a, dt * cost.u_weight * u, Wq,
            torch.diag(dt * cost.v_weight), torch.diag(dt * cost.a_weight),
            torch.diag(dt * cost.u_weight))


def quadratize_terminal(model, cost, q, v, t=None):
    qdiff, J = _qdiff_and_jac(model, cost, q, t)
    c = eval_terminal(model, cost, q, v, qdiff=qdiff)
    if J is None:
        lq = cost.q_weight_terminal * qdiff
        Wq = torch.diag(cost.q_weight_terminal)
    else:
        lq = J.T @ (cost.q_weight_terminal * qdiff)
        Wq = J.T @ (cost.q_weight_terminal.unsqueeze(-1) * J)
    return (c, lq, cost.v_weight_terminal * (v - cost.v_ref), Wq,
            torch.diag(cost.v_weight_terminal))


def quadratize_impact(model, cost, q, v, dv, t=None):
    """(cost, lq, lv, ldv, Wq, Wv, Wdv) with the impact weights."""
    qdiff, J = _qdiff_and_jac(model, cost, q, t)
    c = eval_impact(model, cost, q, v, dv, qdiff=qdiff)
    if J is None:
        lq = cost.q_weight_impact * qdiff
        Wq = torch.diag(cost.q_weight_impact)
    else:
        lq = J.T @ (cost.q_weight_impact * qdiff)
        Wq = J.T @ (cost.q_weight_impact.unsqueeze(-1) * J)
    return (c, lq, cost.v_weight_impact * (v - cost.v_ref),
            cost.dv_weight_impact * dv, Wq, torch.diag(cost.v_weight_impact),
            torch.diag(cost.dv_weight_impact))

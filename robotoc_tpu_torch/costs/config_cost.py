"""Configuration-space quadratic cost (counterpart of
robotoc_tpu/costs/config_cost.py): quadratic penalties on (q, v, a, u)
with separate stage and terminal weights, dt-scaled at stages. The
floating-base q-error uses the Lie difference and its tangent Jacobian."""
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

    def quadratize_stage(self, model, nf, q, v, a, u, f, t, dt):
        from .base import StageQuad
        c, lq, lv, la, lu, Wq, Wv, Wa, Wu = quadratize_stage(
            model, self, q, v, a, u, dt)
        out = StageQuad.zeros(model.nv, model.dimu, nf, q.dtype, q.device)
        return out._replace(cost=c, lq=lq, lv=lv, la=la, lu=lu, Qqq=Wq,
                            Qvv=Wv, Qaa=Wa, Quu=Wu)

    def quadratize_terminal(self, model, q, v, t):
        from .base import TerminalQuad
        c, lq, lv, Wq, Wv = quadratize_terminal(model, self, q, v)
        return TerminalQuad(cost=c, lq=lq, lv=lv, Qqq=Wq, Qvv=Wv)

    def quadratize_impact(self, model, q, v, dv, t):
        from .base import ImpactQuad
        return ImpactQuad(*quadratize_impact(model, self, q, v, dv))


def make_config_cost(model: rm.RobotModel, q_ref=None,
                     **weights) -> ConfigurationSpaceCost:
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
        dv_weight_impact=w("dv_weight_impact", nv))


def _qdiff_and_jac(model, cost, q):
    """q (-) q_ref and the tangent Jacobian J with d(qdiff) = J dq (one
    sample)."""
    if not model.floating_base:
        return q - cost.q_ref, None
    return (rm.difference(model, cost.q_ref, q),
            rm.d_difference_dq1(model, cost.q_ref, q))


def quadratize_stage(model, cost, q, v, a, u, dt):
    """(cost, lq, lv, la, lu, Wq, Wv, Wa, Wu), dt-scaled, Gauss-Newton."""
    qdiff, J = _qdiff_and_jac(model, cost, q)
    c = dt * (0.5 * (torch.sum(cost.q_weight * qdiff ** 2)
                     + torch.sum(cost.v_weight * (v - cost.v_ref) ** 2)
                     + torch.sum(cost.a_weight * a ** 2)
                     + torch.sum(cost.u_weight * u ** 2)))
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


def quadratize_terminal(model, cost, q, v):
    qdiff, J = _qdiff_and_jac(model, cost, q)
    c = 0.5 * (torch.sum(cost.q_weight_terminal * qdiff ** 2)
               + torch.sum(cost.v_weight_terminal * (v - cost.v_ref) ** 2))
    if J is None:
        lq = cost.q_weight_terminal * qdiff
        Wq = torch.diag(cost.q_weight_terminal)
    else:
        lq = J.T @ (cost.q_weight_terminal * qdiff)
        Wq = J.T @ (cost.q_weight_terminal.unsqueeze(-1) * J)
    return (c, lq, cost.v_weight_terminal * (v - cost.v_ref), Wq,
            torch.diag(cost.v_weight_terminal))


def quadratize_impact(model, cost, q, v, dv):
    """(cost, lq, lv, ldv, Wq, Wv, Wdv) with the impact weights."""
    qdiff, J = _qdiff_and_jac(model, cost, q)
    c = 0.5 * (torch.sum(cost.q_weight_impact * qdiff ** 2)
               + torch.sum(cost.v_weight_impact * (v - cost.v_ref) ** 2)
               + torch.sum(cost.dv_weight_impact * dv ** 2))
    if J is None:
        lq = cost.q_weight_impact * qdiff
        Wq = torch.diag(cost.q_weight_impact)
    else:
        lq = J.T @ (cost.q_weight_impact * qdiff)
        Wq = J.T @ (cost.q_weight_impact.unsqueeze(-1) * J)
    return (c, lq, cost.v_weight_impact * (v - cost.v_ref),
            cost.dv_weight_impact * dv, Wq, torch.diag(cost.v_weight_impact),
            torch.diag(cost.dv_weight_impact))

"""Joint-space box constraints (position / velocity / torque /
acceleration) as one fused, masked stack (counterpart of
robotoc_tpu/constraints/joint_limits.py):

    e = [ q_lb - q_J ; q_J - q_ub ; -v_lim - v_J ; v_J - v_lim ;
          -u_lim - u ; u - u_lim  ; -a_lim - a_J ; a_J - a_lim ]  (8*dimu)

Every Jacobian is a signed selection, so PDIPM condensing reduces to
diagonal adds.
"""
from __future__ import annotations

import dataclasses

import torch

from . import pdipm


@dataclasses.dataclass
class JointLimits:
    q_lower: torch.Tensor   # (dimu,)
    q_upper: torch.Tensor
    v_limit: torch.Tensor   # (dimu,) symmetric
    u_limit: torch.Tensor
    a_limit: torch.Tensor
    mask: torch.Tensor      # (8*dimu,) bool, finite-bound rows

    @property
    def dimc(self) -> int:
        return self.mask.shape[-1]


def make_joint_limits(model, q_lower=None, q_upper=None, v_limit=None,
                      u_limit=None, a_limit=None) -> JointLimits:
    kw = dict(dtype=model.dtype, device=model.device)

    def pick(val, default):
        return torch.as_tensor(val, **kw) if val is not None else default

    inf = torch.full((model.dimu,), float("inf"), **kw)
    ql = pick(q_lower, model.q_lower)
    qu = pick(q_upper, model.q_upper)
    vl = pick(v_limit, model.v_limit)
    ul = pick(u_limit, model.u_limit)
    al = pick(a_limit, inf)
    fin = torch.isfinite
    mask = torch.cat([fin(ql), fin(qu), fin(vl), fin(vl), fin(ul), fin(ul),
                      fin(al), fin(al)])
    big = torch.tensor(1e8, **kw)
    return JointLimits(
        q_lower=torch.where(fin(ql), ql, -big),
        q_upper=torch.where(fin(qu), qu, big),
        v_limit=torch.where(fin(vl), vl, big),
        u_limit=torch.where(fin(ul), ul, big),
        a_limit=torch.where(fin(al), al, big), mask=mask)


def constraint_values(model, lim: JointLimits, q, v, u, a=None):
    nj = model.dimu
    qj = q[..., model.nq - nj:]
    vj = v[..., model.nv - nj:]
    aj = torch.zeros_like(vj) if a is None else a[..., model.nv - nj:]
    return torch.cat([lim.q_lower - qj, qj - lim.q_upper,
                      -lim.v_limit - vj, vj - lim.v_limit,
                      -lim.u_limit - u, u - lim.u_limit,
                      -lim.a_limit - aj, aj - lim.a_limit], dim=-1)


def constraint_direction(model, lim: JointLimits, dq, dv, du, da=None):
    nj = model.dimu
    dqj = dq[..., model.nv - nj:]
    dvj = dv[..., model.nv - nj:]
    daj = torch.zeros_like(dvj) if da is None else da[..., model.nv - nj:]
    return torch.cat([-dqj, dqj, -dvj, dvj, -du, du, -daj, daj], dim=-1)


def _full(model, x):
    pad = model.nv - model.dimu
    if pad == 0:
        return x
    return torch.cat([x.new_zeros(x.shape[:-1] + (pad,)), x], dim=-1)


def condense(model, lim: JointLimits, e, s, z, barrier):
    """PDIPM condensing onto (q, v, u, a) diagonals: returns
    (Hq_diag, Hv_diag, Hu_diag, Ha_diag, gq, gv, gu, ga) in full tangent
    coordinates (passive rows zero; u rows dimu)."""
    d = pdipm.condensing_diag(s, z, lim.mask)
    r = pdipm.condensing_rhs(e, s, z, barrier, lim.mask)
    dql, dqu, dvl, dvu, dul, duu, dal, dau = torch.chunk(d, 8, dim=-1)
    rql, rqu, rvl, rvu, rul, ruu, ral, rau = torch.chunk(r, 8, dim=-1)
    return (_full(model, dql + dqu), _full(model, dvl + dvu), dul + duu,
            _full(model, dal + dau), _full(model, -rql + rqu),
            _full(model, -rvl + rvu), -rul + ruu, _full(model, -ral + rau))


def dual_residual(model, lim: JointLimits, z):
    """Constraint-dual contribution J^T z to (lq, lv, lu, la)."""
    zql, zqu, zvl, zvu, zul, zuu, zal, zau = torch.chunk(z, 8, dim=-1)
    return (_full(model, zqu - zql), _full(model, zvu - zvl), zuu - zul,
            _full(model, zau - zal))

"""Switching constraint: pure-state equality on the next impact's contact
placements (counterpart of robotoc_tpu/dynamics/switching_constraint.py).

At the intermediate grid two steps before an impact slot, the impacting
contacts' placements at the predicted configuration
    q_pred = q (+) ((dt1 + dt2) v + dt1 dt2 a)
must equal their targets. Rows follow the force-stack layout (3 per point
contact: world position error; 6 per surface contact: log6 placement
error), masked by the impact mask; the Jacobians come from one fused
3nv-tangent jacfwd of predict -> FK -> error.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd

from ..models import contacts as ct
from ..models import robot as rm
from ..ops import lie


def predicted_config(model, q, v, a, dt1, dt2):
    """q (+) ((dt1 + dt2) v + dt1 dt2 a), the two-step prediction."""
    return rm.integrate(model, q, (dt1 + dt2) * v + dt1 * dt2 * a)


def placement_error(model, contacts, q_pred, p_target, R_target):
    """Stacked placement error at q_pred: (max_dimf,)."""
    R_w, p_w = rm.forward_kinematics(model, q_pred)
    rows = []
    for c in range(contacts.n_contacts):
        Rw, pw = rm.frame_placement(model, contacts.frame_ids[c], R_w, p_w)
        if contacts.types[c] == ct.POINT:
            rows.append(pw - p_target[..., c, :])
        else:
            Rrt = R_target[..., c, :, :].transpose(-1, -2)
            rows.append(lie.se3_log(Rrt @ Rw,
                                    rm._mv(Rrt, pw - p_target[..., c, :])))
    return torch.cat(rows, dim=-1)


def residual_and_jacs(model, contacts, q, v, a, dt1, dt2, p_target,
                      R_target, sw_mask):
    """(P_res, Phiq, Phiv, Phia) for one sample, rows of inactive
    contacts (sw_mask (nc,)) zeroed."""
    nv = model.nv
    rowmask = contacts.force_mask(sw_mask)

    def res(qq, vv, aa):
        return placement_error(model, contacts, predicted_config(
            model, qq, vv, aa, dt1, dt2), p_target, R_target)

    P0 = res(q, v, a)
    z = torch.zeros(3 * nv, dtype=q.dtype, device=q.device)
    J = jacfwd(lambda e: res(rm.integrate(model, q, e[:nv]),
                             v + e[nv:2 * nv], a + e[2 * nv:]))(z)
    m = rowmask.unsqueeze(-1)
    return (P0 * rowmask, J[:, :nv] * m, J[:, nv:2 * nv] * m,
            J[:, 2 * nv:] * m)


def condense(P_res, Phiq, Phiv, Phia, da_dw, da_0, nv, nu):
    """Eliminate da = da_dw (dq, dv, du) + da_0 (the contact-dynamics
    condensation): Phix = [Phiq + Phia Jq, Phiv + Phia Jv], Phiu = Phia Ju,
    Pc = P_res + Phia da_0. Works on batched (..., nf, ...) inputs."""
    PJ = Phia @ da_dw
    Phix = torch.cat([Phiq + PJ[..., :nv], Phiv + PJ[..., nv:2 * nv]],
                     dim=-1)
    Pc = P_res + (Phia @ da_0.unsqueeze(-1)).squeeze(-1)
    return Phix, PJ[..., 2 * nv:], Pc

"""Lie-corrected multiple-shooting state equation (counterpart of
robotoc_tpu/dynamics/state_equation.py): the q-row of
    F_q = (q_{i+1} (-) q_i) - dt v_i
is premultiplied by the inverse of d(q_{i+1} (-) q_i)/dq_{i+1}, giving the
solved form dq_{i+1} = Aqq dq_i + Aqv dv_i + xres_q. Only the 6x6 base
block differs from the identity."""
from __future__ import annotations

import torch

from ..models import robot as rm
from ..ops.linalg import pivoted_gauss_jordan_inverse


def linearize_base(model, q, v, dt, q_next):
    """(Aqq, J1b_inv, xres_q) for one floating-base sample, J1b_inv the
    inverse of the 6x6 base block of d(q_next (-) q)/dq_next; the solved
    form has Aqv = dt * blockdiag(J1b_inv, I)."""
    nv = model.nv
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    r = rm.difference(model, q, q_next) - dt * v
    J0 = rm.d_difference_dq0(model, q, q_next)
    J1 = rm.d_difference_dq1(model, q, q_next)
    # partial pivoting: divergent iterates reach far-apart (q, q_next)
    # where unpivoted elimination of the base block breaks down
    J1b_inv = pivoted_gauss_jordan_inverse(J1[:6, :6])
    Cinv = torch.cat([
        torch.cat([J1b_inv, eye[:6, 6:]], dim=-1), eye[6:]], dim=-2)
    return -Cinv @ J0, J1b_inv, -(Cinv @ r)


def linearize(model, q, v, dt, q_next):
    """(Aqq, Aqv, xres_q) for one sample: dq_next = Aqq dq + Aqv dv +
    xres_q with Aqv = dt * Cinv."""
    nv = model.nv
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    if not model.floating_base:
        return eye, dt * eye, q + dt * v - q_next
    Aqq, J1b_inv, xres_q = linearize_base(model, q, v, dt, q_next)
    Cinv = torch.cat([
        torch.cat([J1b_inv, eye[:6, 6:]], dim=-1), eye[6:]], dim=-2)
    return Aqq, dt * Cinv, xres_q

"""Lifted contact dynamics: KKT-block inversion for condensing and
expansion (counterpart of robotoc_tpu/dynamics/contact_dynamics.py).

T_y = [[M, J^T], [J, -D]] is symmetric quasi-definite; one unpivoted
Gauss-Jordan sweep gives Psi = T_y^-1 = [[inv11, inv12], [inv12^T, -Sinv]],
which serves both the condensing and the dual expansion. Inactive contact
rows have J zeroed and a unit diagonal in D, so shapes never change."""
from __future__ import annotations

import torch

from ..ops.linalg import gauss_jordan_inverse


def kkt_block(M, J, inactive_diag):
    """[[M, J^T], [J, -diag(inactive)]] over leading batch dims."""
    nf = J.shape[-2]
    D = inactive_diag.unsqueeze(-1) * torch.eye(nf, dtype=M.dtype,
                                                device=M.device)
    return torch.cat([torch.cat([M, J.transpose(-1, -2)], dim=-1),
                      torch.cat([J, -D], dim=-1)], dim=-2)


def mjtj_inverse(M, J, inactive_diag):
    """(inv11, inv12, Sinv) blocks of Psi, symmetrized."""
    nv = M.shape[-1]
    Psi = gauss_jordan_inverse(kkt_block(M, J, inactive_diag))
    inv11 = Psi[..., :nv, :nv]
    inv12 = Psi[..., :nv, nv:]
    Sinv = -Psi[..., nv:, nv:]
    inv11 = 0.5 * (inv11 + inv11.transpose(-1, -2))
    Sinv = 0.5 * (Sinv + Sinv.transpose(-1, -2))
    return inv11, inv12, Sinv


def ty_solve(inv11, inv12, Sinv, r1, r2):
    """Solve T_y [x1; x2] = [r1; r2] given the Psi blocks; r1/r2 may be
    vectors (..., n) or matrices (..., n, m)."""
    vec = r1.dim() == inv11.dim() - 1
    if vec:
        r1, r2 = r1.unsqueeze(-1), r2.unsqueeze(-1)
    x1 = inv11 @ r1 + inv12 @ r2
    x2 = inv12.transpose(-1, -2) @ r1 - Sinv @ r2
    if vec:
        x1, x2 = x1.squeeze(-1), x2.squeeze(-1)
    return x1, x2

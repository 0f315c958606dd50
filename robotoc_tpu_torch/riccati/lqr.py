"""Time-varying LQR via the serial Riccati recursion (counterpart of
robotoc_tpu/riccati/lqr.py). Python loops over the horizon replace
`lax.scan`; every step broadcasts over leading batch dims, so a (B, N, ...)
fleet runs as one sweep.

QP over directions dx_i, du_i (grids 0..N-1, terminal N):
  min sum_i [1/2 dx'Qxx dx + dx'Qxu du + 1/2 du'Quu du + lx'dx + lu'du]
      + 1/2 dxN'QxxN dxN + lxN'dxN
  s.t. dx_{i+1} = A_i dx_i + B_i du_i + xres_i, dx_0 given.
With switching rows (Phix, Phiu, Pc, sw) every step takes the masked
pure-state-equality Schur branch.
"""
from __future__ import annotations

import torch

from ..core.structs import LQRData, LQRPolicy
from ..ops.linalg import spd_inverse


def _t(x):
    return x.transpose(-1, -2)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def backward(data: LQRData) -> LQRPolicy:
    """Backward Riccati sweep; arrays carry a leading batch dim before N
    (or none)."""
    constrained = data.Phix is not None
    N = data.A.shape[-3]
    P_next = 0.5 * (data.Qxx_N + _t(data.Qxx_N))
    p_next = data.lx_N
    Ps, ps, Ks, ks, Mxs, mxs = [], [], [], [], [], []
    for i in reversed(range(N)):
        A, B = data.A[..., i, :, :], data.B[..., i, :, :]
        AtP = _t(A) @ P_next
        BtP = _t(B) @ P_next
        F = data.Qxx[..., i, :, :] + AtP @ A
        H = data.Qxu[..., i, :, :] + AtP @ B
        G = data.Quu[..., i, :, :] + BtP @ B
        Pxr_p = _mv(P_next, data.xres[..., i, :]) + p_next
        gu = data.lu[..., i, :] + _mv(_t(B), Pxr_p)
        Ginv = spd_inverse(G)
        K = -(Ginv @ _t(H))
        k = -_mv(Ginv, gu)
        lxt = data.lx[..., i, :] + _mv(_t(A), Pxr_p)
        if constrained:
            Phix, Phiu = data.Phix[..., i, :, :], data.Phiu[..., i, :, :]
            Pc, sw = data.Pc[..., i, :], data.sw[..., i, :]
            GiPhiuT = Ginv @ _t(Phiu)
            S = ((Phiu @ GiPhiuT) * (sw.unsqueeze(-1) * sw.unsqueeze(-2))
                 + torch.diag_embed(1.0 - sw))
            Sinv = spd_inverse(S)
            Mx = Sinv @ ((Phiu @ K + Phix) * sw.unsqueeze(-1))
            mx = _mv(Sinv, (_mv(Phiu, k) + Pc) * sw)
            K = K - GiPhiuT @ Mx
            k = k - _mv(GiPhiuT, mx)
            P = F + H @ K + _t(Phix) @ Mx
            p = lxt + _mv(H, k) + _mv(_t(Phix), mx)
            Mxs.append(Mx)
            mxs.append(mx)
        else:
            P = F + H @ K
            p = lxt + _mv(H, k)
        P = 0.5 * (P + _t(P))
        Ps.append(P)
        ps.append(p)
        Ks.append(K)
        ks.append(k)
        P_next, p_next = P, p
    d = data.A.dim() - 3          # stacking dim of the horizon axis
    rev = lambda xs: torch.stack(xs[::-1], dim=d)          # noqa: E731
    P_all = torch.cat([rev(Ps), (0.5 * (data.Qxx_N + _t(data.Qxx_N)))
                       .unsqueeze(d)], dim=d)
    p_all = torch.cat([rev(ps), data.lx_N.unsqueeze(d)], dim=d)
    return LQRPolicy(K=rev(Ks), k=rev(ks), P=P_all, p=p_all,
                     Mx=rev(Mxs) if constrained else None,
                     mx=rev(mxs) if constrained else None)


def forward(data: LQRData, K, k, P_all, p_all, dx0):
    """Forward rollout with the feedback gains: returns
    (dx (..., N+1, nx), du (..., N, nu), dlmd (..., N+1, nx))."""
    N = data.A.shape[-3]
    d = data.A.dim() - 3
    dx = dx0
    dxs, dus = [], []
    for i in range(N):
        du = _mv(K[..., i, :, :], dx) + k[..., i, :]
        dxs.append(dx)
        dus.append(du)
        dx = (_mv(data.A[..., i, :, :], dx) + _mv(data.B[..., i, :, :], du)
              + data.xres[..., i, :])
    dxs.append(dx)
    dx_all = torch.stack(dxs, dim=d)
    dlmd = _mv(P_all, dx_all) + p_all
    return dx_all, torch.stack(dus, dim=d), dlmd


def solve(data: LQRData, dx0):
    policy = backward(data)
    dx, du, dlmd = forward(data, policy.K, policy.k, policy.P, policy.p,
                           dx0)
    return dx, du, dlmd, policy

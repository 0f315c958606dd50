"""Interpolated PD + feedforward control policy from an MPC solution
(counterpart of robotoc_tpu/mpc/control_policy.py).

At a query time t between MPC updates the policy interpolates the
solution's torques, joint positions and velocities and the Riccati
feedback gains of the two stage slots around t: joint targets (qJ, dqJ),
feedforward torques tauJ and local gains (Kp, Kd) for a joint PD loop,
u = tauJ - Kp (qJ_meas - qJ) - Kd (dqJ_meas - dqJ).

The two slots and the weight are found on the host from the grid's times
and impact flags (one copy of each per call); the values are gathered and
blended as tensors on the solution's device. Solution fields may carry
leading fleet dims; the grid is shared.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ControlPolicy(NamedTuple):
    t: float
    tauJ: torch.Tensor     # (..., dimu)
    qJ: torch.Tensor       # (..., dimu)
    dqJ: torch.Tensor      # (..., dimu)
    Kp: torch.Tensor       # (..., dimu, dimu)
    Kd: torch.Tensor       # (..., dimu, dimu)

    @staticmethod
    def from_solution(model, grid, sol, lqr_policy, t: float):
        """The policy at time t from `sol` (fields (..., S, .)) and the
        LQR policy of the update that made it (K (..., S-1, dimu, 2 nv))."""
        dimu, nv = model.dimu, model.nv
        ts = grid.t.detach().cpu().double().numpy()
        is_imp = grid.is_impact.detach().cpu().numpy()
        K = lqr_policy.K
        if K.dim() > sol.u.dim() + 1:     # a fleet of one for one scenario
            K = K.reshape(K.shape[-3:])
        S, nK = ts.shape[0], K.shape[-3]
        if t <= ts[0]:
            i0 = i1 = 0
            alpha = 1.0
        else:
            i1 = next((i for i in range(1, S - 1)
                       if t < ts[i] and not is_imp[i - 1] > 0), None)
            if i1 is None:
                i0 = i1 = min(S - 2, nK - 1)
                alpha = 1.0
            else:
                i0 = i1 - 1
                dt = ts[i1] - ts[i0]
                alpha = (ts[i1] - t) / dt if dt > 0 else 1.0
        iK0, iK1 = min(i0, nK - 1), min(i1, nK - 1)

        def lerp(x, a, b):
            """Blend of slots a and b of x (..., slots, n)."""
            return alpha * x[..., a, :] + (1.0 - alpha) * x[..., b, :]

        def lerp_gain(x):
            """Blend of slots iK0 and iK1 of x (..., slots, n, m)."""
            return (alpha * x[..., iK0, :, :]
                    + (1.0 - alpha) * x[..., iK1, :, :])

        # feedback sign: u = tauJ - Kp e_q - Kd e_v
        return ControlPolicy(
            t=float(t), tauJ=lerp(sol.u, i0, i1),
            qJ=lerp(sol.q[..., -dimu:], i0, i1),
            dqJ=lerp(sol.v[..., -dimu:], i0, i1),
            Kp=lerp_gain(-K[..., nv - dimu:nv]),
            Kd=lerp_gain(-K[..., 2 * nv - dimu:]))

    def control_input(self, qJ_meas, dqJ_meas):
        """u = tauJ - Kp (qJ_meas - qJ) - Kd (dqJ_meas - dqJ)."""
        kw = dict(dtype=self.tauJ.dtype, device=self.tauJ.device)
        eq = torch.as_tensor(qJ_meas, **kw) - self.qJ
        ev = torch.as_tensor(dqJ_meas, **kw) - self.dqJ
        return (self.tauJ - (self.Kp @ eq.unsqueeze(-1)).squeeze(-1)
                - (self.Kd @ ev.unsqueeze(-1)).squeeze(-1))

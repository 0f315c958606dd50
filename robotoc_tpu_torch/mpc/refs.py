"""Step-indexed MPC references synchronised with the foot-step planner.

Counterpart of robotoc_tpu/mpc/refs.py. Each reference holds per-step
tensors (K planned steps) that the MPC layer re-bakes every update, and is
evaluated at grid times: `ref(t)` takes t of any shape and returns values
with t's shape in front. The step of a time is found by counting the sorted
step start times at or before it (searchsorted, side "right") and is picked
out with a one-hot sum, which is exact and works under torch.func.vmap.
StepSwingFootRef also takes its fields stacked over contacts (a leading nc
dim), which the multi-frame task cost uses.
"""
from __future__ import annotations

import dataclasses

import torch


def _step_onehot(t_start, t):
    """One-hot (t.shape + t_start.shape) of clip(#(t_start <= t) - 1, 0,
    K - 1) over the last (step) dim of the sorted t_start."""
    K = t_start.shape[-1]
    tt = t.reshape(t.shape + (1,) * t_start.dim())
    k = torch.clamp(torch.sum((t_start <= tt).to(torch.long), dim=-1) - 1,
                    0, K - 1)
    steps = torch.arange(K, device=t_start.device)
    return (steps == k.unsqueeze(-1)).to(t_start.dtype)


def _pick(x, sel, trailing=0):
    """x (..., K, *trailing dims) at the step selected by `sel`."""
    s = sel.reshape(sel.shape + (1,) * trailing)
    return torch.sum(s * x, dim=-1 - trailing)


@dataclasses.dataclass
class StepSwingFootRef:
    """Swing trajectory of one foot (or of each foot, fields stacked over a
    leading contact dim) across its K planned swings: linear advance from
    x_prev[k] to x_next[k] plus a triangular height profile."""
    x_prev: torch.Tensor      # ([nc,] K, 3)
    x_next: torch.Tensor      # ([nc,] K, 3)
    t_start: torch.Tensor     # ([nc,] K) swing start times (sorted)
    swing_time: torch.Tensor  # like t_start, or a scalar
    step_height: torch.Tensor  # ([nc])
    valid: torch.Tensor       # ([nc,] K) 1.0 where the slot holds a swing

    def __call__(self, t):
        sel = _step_onehot(self.t_start, t)
        tau = t.reshape(t.shape + (1,) * (self.t_start.dim() - 1)) \
            - _pick(self.t_start, sel)
        dur = (_pick(self.swing_time, sel)
               if self.swing_time.shape == self.t_start.shape
               else self.swing_time)
        in_swing = (tau >= 0.0) & (tau <= dur) & (_pick(self.valid, sel) > 0)
        phase = torch.clamp(tau / dur, 0.0, 1.0)
        x0 = _pick(self.x_prev, sel, 1)
        pos = x0 + phase.unsqueeze(-1) * (_pick(self.x_next, sel, 1) - x0)
        z = self.step_height * torch.where(phase < 0.5, 2.0 * phase,
                                           2.0 * (1.0 - phase))
        pos = torch.cat([pos[..., :2], pos[..., 2:] + z.unsqueeze(-1)],
                        dim=-1)
        return pos, torch.where(in_swing, 1.0, 0.0).to(pos.dtype)


def _slerp(q0, q1, s):
    """Quaternion slerp (x, y, z, w) with shortest-arc sign correction;
    s (...) broadcasts against the quaternions' batch dims."""
    s = s.unsqueeze(-1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.acos(dot)
    sin_t = torch.sin(theta)
    small = sin_t < 1e-6
    den = torch.where(small, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(small, 1.0 - s, torch.sin((1.0 - s) * theta) / den)
    w1 = torch.where(small, s, torch.sin(s * theta) / den)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


@dataclasses.dataclass
class StepBaseRotRef:
    """Base orientation slerped between the planner's per-step yaw
    rotations during each swing window; returns (quat (..., 4), active)."""
    quat_steps: torch.Tensor  # (K+1, 4) base quaternion after k steps
    t_start: torch.Tensor     # (K,) swing start times (sorted)
    swing_time: torch.Tensor  # scalar
    valid: torch.Tensor       # (K,)

    def __call__(self, t):
        sel = _step_onehot(self.t_start, t)
        tau = t - _pick(self.t_start, sel)
        rate = torch.clamp(tau / self.swing_time, 0.0, 1.0)
        rate = torch.where(_pick(self.valid, sel) > 0, rate,
                           torch.zeros_like(rate))
        q = _slerp(_pick(self.quat_steps[:-1], sel, 1),
                   _pick(self.quat_steps[1:], sel, 1), rate)
        before = (t < self.t_start[0]).unsqueeze(-1)
        return (torch.where(before, self.quat_steps[0], q),
                torch.ones_like(t))


@dataclasses.dataclass
class StepCoMRef:
    """CoM reference: lerp between the planner's step CoMs during each
    swing window, hold otherwise; returns (pos (..., 3), active)."""
    com_steps: torch.Tensor   # (K+1, 3) CoM after k steps (0 = current)
    t_start: torch.Tensor     # (K,)
    swing_time: torch.Tensor
    valid: torch.Tensor       # (K,)

    def __call__(self, t):
        sel = _step_onehot(self.t_start, t)
        tau = t - _pick(self.t_start, sel)
        phase = torch.clamp(tau / self.swing_time, 0.0, 1.0).unsqueeze(-1)
        base = _pick(self.com_steps[:-1], sel, 1)
        target = _pick(self.com_steps[1:], sel, 1)
        before = (t < self.t_start[0]).unsqueeze(-1)
        pos = torch.where(before, self.com_steps[0],
                          base + phase * (target - base))
        return pos, torch.ones_like(t)

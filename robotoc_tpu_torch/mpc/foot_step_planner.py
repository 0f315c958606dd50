"""Host-side gait planner: the cyclic foot-step planner and its
Raibert-heuristic mode (counterpart of robotoc_tpu/mpc/foot_step_planner.py).

numpy on the host, once per MPC update; only the measured kinematics (feet
and CoM at the current configuration) run on the model's device. A gait is
a cycle of swing sets (which feet are airborne at step s). Feet order
LF, LH, RF, RH: trot cycle = ((LH, RF), (LF, RH)) = ((1, 2), (0, 3)),
pace ((RF, RH), (LF, LH)), crawl ((RH,), (RF,), (LH,), (LF,)). In the
Raibert mode the step length follows the measured base velocity, averaged
over a trailing window, and the commanded one.
"""
from __future__ import annotations

from collections import deque
from typing import Sequence, Tuple

import numpy as np
import torch

from ..models import robot as rm


class MovingWindowFilter:
    """Mean of the values pushed within a trailing time window."""

    def __init__(self, window: float):
        self.window = window
        self.data = deque()

    def clear(self):
        self.data.clear()

    def push(self, t, value):
        self.data.append((t, np.asarray(value, float)))
        while self.data and self.data[0][0] < t - self.window:
            self.data.popleft()

    def average(self):
        if not self.data:
            return 0.0
        return np.mean([v for _, v in self.data], axis=0)


class RaibertHeuristic:
    """Step length 0.5 period v_avg + gain (v_avg - v_cmd) in x and y."""

    def __init__(self, period: float, gain: float):
        self.period = period
        self.gain = gain

    def step_length(self, vcom_avg, vcom_cmd, yaw_rate_cmd):
        v = np.asarray(vcom_avg, float)
        cmd = np.asarray(vcom_cmd, float)
        xy = 0.5 * self.period * v + self.gain * (v - cmd)
        return np.array([xy[0], xy[1], 0.0])


class GaitFootStepPlanner:
    """Cyclic foot-step planner: placements, CoM and yaw per future step."""

    def __init__(self, model, feet_frames, cycle: Sequence[Tuple[int, ...]],
                 first_step_factor: float = 0.5, terrain=None):
        """terrain: optional height map z = terrain(x, y) that planned
        placements snap to."""
        self.model = model
        self.frame_ids = [model.frame_id(f) for f in feet_frames]
        self.nc = len(self.frame_ids)
        self.terrain = terrain
        self.cycle = tuple(tuple(s) for s in cycle)
        self.com_advance = 1.0 / len(self.cycle)
        self.first_step_factor = float(first_step_factor)
        self.step_length = np.zeros(3)
        self.R_yaw = np.eye(3)
        self.enable_stance_phase = False
        self.has_flight_phase = False
        self.enable_raibert = False
        self.raibert = None
        self.vcom_filter = None
        self.vcom_cmd = np.zeros(3)
        self.yaw_rate_cmd = 0.0
        self.current_step = 0

    def _fk_feet_com(self, q):
        """World feet positions (nc, 3) and CoM (3,) at q, as numpy."""
        m = self.model
        qt = torch.as_tensor(np.asarray(q), dtype=m.dtype, device=m.device)
        R_w, p_w = rm.forward_kinematics(m, qt)
        feet = torch.stack([rm.frame_placement(m, fid, R_w, p_w)[1]
                            for fid in self.frame_ids])
        return (feet.detach().cpu().double().numpy(),
                rm.com(m, qt).detach().cpu().double().numpy())

    # -- gait pattern -------------------------------------------------------
    def set_gait_pattern(self, step_length, step_yaw,
                         enable_stance_phase=False):
        self.step_length = np.asarray(step_length, float)
        cy, sy = np.cos(step_yaw), np.sin(step_yaw)
        self.R_yaw = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        self.enable_stance_phase = enable_stance_phase
        self.enable_raibert = False

    def set_raibert_gait_pattern(self, vcom_cmd, yaw_rate_cmd, period,
                                 gain):
        """Step length from the Raibert heuristic at every plan; period:
        the full gait period (every foot stepped once); the step yaw from
        the commanded yaw rate."""
        self.raibert = RaibertHeuristic(period, gain)
        self.vcom_filter = MovingWindowFilter(0.1 * period)
        self.vcom_cmd = np.asarray(vcom_cmd, float)
        self.yaw_rate_cmd = yaw_rate_cmd
        step_yaw = yaw_rate_cmd * period / len(self.cycle)
        cy, sy = np.cos(step_yaw), np.sin(step_yaw)
        self.R_yaw = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        self.enable_raibert = True

    def swing_set(self, s: int) -> Tuple[int, ...]:
        return self.cycle[(s - 1) % len(self.cycle)]

    # -- lifecycle ----------------------------------------------------------
    def init(self, q):
        q = np.asarray(q, float)
        R = _yaw_projection(_quat_to_R(q[3:7]))
        feet, com = self._fk_feet_com(q)
        self.com_to_foot_local = [R.T @ (feet[i] - com)
                                  for i in range(self.nc)]
        self.current_step = 0
        self._R = R
        if self.vcom_filter is not None:
            self.vcom_filter.clear()

    def plan(self, t, q, v, contact_active, planning_steps):
        """(positions (K+1, nc, 3), com (K+1, 3), R (K+1, 3, 3)); entry 0 is
        the current stance, entry j the placements after j more steps."""
        q = np.asarray(q, float)
        if self.enable_raibert:
            self.vcom_filter.push(t, np.asarray(v[:3], float)[:2])
            vavg = np.atleast_1d(self.vcom_filter.average())
            if vavg.size < 2:
                vavg = np.zeros(2)
            self.step_length = self.raibert.step_length(
                vavg[:2], self.vcom_cmd[:2], self.yaw_rate_cmd)
        feet, _ = self._fk_feet_com(q)
        pos = [feet[i] for i in range(self.nc)]
        R = getattr(self, "_R", _yaw_projection(_quat_to_R(q[3:7])))
        active = list(contact_active)
        n_cyc = len(self.cycle)

        if all(active):
            if self.enable_stance_phase:
                self.current_step += self.current_step % 2
            else:
                self.current_step = 0
            com = np.mean([pos[i] - R @ self.com_to_foot_local[i]
                           for i in range(self.nc)], axis=0)
        elif not any(active) and self.has_flight_phase:
            if self.current_step == 0:
                self.current_step = 1
            com = np.mean([pos[i] - R @ self.com_to_foot_local[i]
                           for i in range(self.nc)], axis=0)
            swing = self.swing_set(self.current_step)
            for i in range(self.nc):
                if i in swing:
                    pos[i] = com + R @ (self.com_to_foot_local[i]
                                        - 0.5 * self.step_length)
                pos[i] = self._snap(pos[i])
        else:
            if not any(active):
                # a momentary all-inactive reading in a gait without
                # flight: keep the scheduled swing set, the other feet
                # stand at their measured placements
                if self.current_step == 0:
                    self.current_step = 1
                sched_swing = self.swing_set(self.current_step)
                for i in range(self.nc):
                    if i not in sched_swing:
                        pos[i] = self._snap(pos[i])
                active = [i not in sched_swing for i in range(self.nc)]
            swing = tuple(i for i in range(self.nc) if not active[i])
            match = None
            for k, c in enumerate(self.cycle):
                if set(c) == set(swing) or set(c).issuperset(swing):
                    match = k
                    break
            if match is None:
                return None
            if self.current_step == 0 \
                    or (self.current_step - 1) % n_cyc != match:
                self.current_step += 1
                R = self.R_yaw @ R
                while (self.current_step - 1) % n_cyc != match:
                    self.current_step += 1
            stand = [i for i in range(self.nc) if active[i]]
            com = np.mean([pos[i] - R @ self.com_to_foot_local[i]
                           for i in stand], axis=0)
            for i in swing:
                pos[i] = com + R @ (self.com_to_foot_local[i]
                                    - 0.5 * self.step_length)
                pos[i] = self._snap(pos[i])
        self._R = R

        positions = [np.stack(pos)]
        coms = [com.copy()]
        Rs = [R.copy()]
        step0 = self.current_step
        pos = [p.copy() for p in pos]
        for step in range(step0, step0 + planning_steps + 1):
            if step == 0:
                pass
            elif step0 == 0 and step == 1:
                R = self.R_yaw @ R
                adv = self.com_advance * (
                    1.0 if self.enable_raibert else self.first_step_factor)
                com = com + adv * (R @ self.step_length)
                for i in self.swing_set(step):
                    pos[i] = self._snap(com + R @ self.com_to_foot_local[i])
            else:
                R = self.R_yaw @ R
                com = com + self.com_advance * (R @ self.step_length)
                for i in self.swing_set(step):
                    pos[i] = self._snap(com + R @ self.com_to_foot_local[i])
            positions.append(np.stack([p.copy() for p in pos]))
            coms.append(com.copy())
            Rs.append(R.copy())
        return np.stack(positions), np.stack(coms), np.stack(Rs)

    def _snap(self, p):
        """Snap a planned placement to the terrain surface (no-op flat)."""
        if self.terrain is None:
            return p
        p = np.asarray(p, float).copy()
        p[2] = float(self.terrain(p[0], p[1]))
        return p


class TrotFootStepPlanner(GaitFootStepPlanner):
    """Trot: diagonal pairs, pair B = (LH, RF) swings first."""

    PAIR_A = (0, 3)   # LF, RH
    PAIR_B = (1, 2)   # LH, RF

    def __init__(self, model, feet_frames, terrain=None):
        super().__init__(model, feet_frames,
                         cycle=(self.PAIR_B, self.PAIR_A), terrain=terrain)

    def set_raibert_gait_pattern(self, vcom_cmd, yaw_rate_cmd, swing_time,
                                 stance_time, gain):
        period = 2.0 * (swing_time + stance_time)
        super().set_raibert_gait_pattern(vcom_cmd, yaw_rate_cmd, period,
                                         gain)
        self.enable_stance_phase = stance_time > 0.0


def _quat_to_R(quat_xyzw):
    x, y, z, w = quat_xyzw
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _yaw_projection(R):
    """Project a rotation onto a pure yaw rotation (about z)."""
    yaw = np.arctan2(R[1, 0], R[0, 0])
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

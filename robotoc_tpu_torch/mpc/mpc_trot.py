"""MPCTrot: the whole-body trot MPC for quadrupeds (counterpart of
robotoc_tpu/mpc/mpc_trot.py).

Feet order LF, LH, RF, RH; diagonal pairs A = (LF, RH), B = (LH, RF).
Swing s (s = 1, 2, ...) runs [ts(s), ts(s) + swing_time] with
ts(s) = swing_start_time + (s - 1) (swing_time + stance_time); odd s
swings pair B, even s pair A; a touchdown is an impact event.
"""
from __future__ import annotations

from .foot_step_planner import TrotFootStepPlanner
from .gait_mpc import PeriodicGaitMPC

PAIR_A = (0, 3)
PAIR_B = (1, 2)


class MPCTrot(PeriodicGaitMPC):
    CYCLE = (PAIR_B, PAIR_A)

    def make_planner(self, first_step_factor: float = 0.5, terrain=None):
        return TrotFootStepPlanner(self.model, self.feet, terrain=terrain)

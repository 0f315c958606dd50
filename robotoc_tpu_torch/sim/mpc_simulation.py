"""MPC-in-the-loop driver (counterpart of robotoc_tpu/sim/mpc_simulation.py).

Runs an MPC controller against the plant (`LeggedSimulator`) with

  * `simulation_steps_per_mpc_update`: the MPC updates once every that
    many control ticks;
  * `feedback_policy`: apply the interpolated LQR PD + feedforward policy
    (mpc/control_policy.py) at every tick instead of the first control
    input. As in the JAX package, and unlike the reference it follows, the
    policy is used at every tick when it is on: the penalty-ground plant is
    softer than the solver's rigid contacts;
  * `feedback_delay`: compute u from the PREVIOUS solution before the MPC
    update of this tick (a one-tick computation delay);
  * logs of (t, q, v, u, kkt) per control tick.

The MPC must provide `update_solution(t, dt, q, v) -> kkt`,
`get_initial_control_input()` and `get_control_policy(t)` (the
PeriodicGaitMPC / MPCJump interface). The MPC and the plant exchange tensors
on the plant's device; per tick the driver copies one vector (t, q, v) to
the host for the log and reads the KKT that the update returns, and copies
the controls to the host once, at the end of the run.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from .simulator import LeggedSimulator


@dataclasses.dataclass
class MPCSimulationLog:
    t: List[float] = dataclasses.field(default_factory=list)
    q: List[np.ndarray] = dataclasses.field(default_factory=list)
    v: List[np.ndarray] = dataclasses.field(default_factory=list)
    u: List[np.ndarray] = dataclasses.field(default_factory=list)
    kkt: List[float] = dataclasses.field(default_factory=list)

    def as_arrays(self):
        return {k: np.asarray(getattr(self, k))
                for k in ("t", "q", "v", "u", "kkt")}

    def save(self, log_dir: str):
        """Write the t/q/v/u/kkt logs as text files <name>.log in
        log_dir; returns its absolute path."""
        os.makedirs(log_dir, exist_ok=True)
        for k, arr in self.as_arrays().items():
            np.savetxt(os.path.join(log_dir, f"{k}.log"),
                       np.atleast_2d(arr))
        return os.path.abspath(log_dir)


class MPCSimulation:
    def __init__(self, simulator: LeggedSimulator):
        self.simulator = simulator
        self.log = MPCSimulationLog()

    def run(self, mpc, t0: float, q0, simulation_time: float,
            control_dt: float,
            feedback_policy: bool = False, feedback_delay: bool = False,
            simulation_steps_per_mpc_update: int = 1,
            verbose: bool = False, v0=None) -> MPCSimulationLog:
        """Closed-loop run from (t0, q0, v0) for `simulation_time` seconds
        at control period `control_dt`; the plant substeps at its own
        sim_dt within each control tick."""
        assert simulation_steps_per_mpc_update >= 1
        m = self.simulator.model
        n_sub = max(1, int(round(control_dt / self.simulator.sim_dt)))
        v0 = np.zeros(m.nv) if v0 is None else v0
        state = self.simulator.init(q0, v0, t0)
        self.log = MPCSimulationLog()
        us = []
        inner = 0                      # 0: an MPC update on this tick
        n_ticks = int(round(simulation_time / control_dt))
        kkt = float("nan")
        for _ in range(n_ticks):
            # the one copy of the tick: (t, q, v) to the host for the log
            x = torch.cat([state.t.reshape(1), state.q, state.v]).cpu()
            x = x.numpy()
            t = float(x[0])
            if feedback_delay:
                u = self._control(mpc, t, state, feedback_policy)
            if inner == 0:
                kkt = mpc.update_solution(t, control_dt, state.q, state.v)
                inner = simulation_steps_per_mpc_update - 1
            else:
                inner -= 1
            if not feedback_delay:
                u = self._control(mpc, t, state, feedback_policy)
            if verbose:
                print(f"t = {t:.4f}  kkt = {kkt:.3e}")
            state = self.simulator.step(state, u, n_substeps=n_sub)
            self.log.t.append(t)
            self.log.q.append(x[1:1 + m.nq].copy())
            self.log.v.append(x[1 + m.nq:].copy())
            us.append(u)
            self.log.kkt.append(float(kkt))
        if us:
            self.log.u = list(torch.stack(us).cpu().numpy())
        return self.log

    def _control(self, mpc, t, state, use_fb):
        """The control input at time t on the plant's device: the policy's
        PD + feedforward torques at the measured joint state, or the
        solution's first control input."""
        m = self.simulator.model
        if use_fb:
            pol = mpc.get_control_policy(t)
            dimu = pol.tauJ.shape[-1]
            u = pol.control_input(state.q[-dimu:], state.v[-dimu:])
        else:
            u = mpc.get_initial_control_input()
        return torch.as_tensor(u, dtype=m.dtype, device=m.device)

"""Closed-loop plant: forward dynamics with a penalty ground contact
(counterpart of robotoc_tpu/sim/simulator.py).

The plant integrates M a = tau + J^T f_ext - h(q, v) by semi-implicit Euler
at `sim_dt`, torque-controlled. The ground is a spring-damper whose damper
acts both ways while a foot is in contact, with a Coulomb cap
min(mu fn, kt |vt|) on the tangential force: a contact model deliberately
different from the solver's rigid contacts, so that an MPC in the loop
meets a real model mismatch. The plant runs on its model's device. On
the CPU each substep is a sequence of tensor ops dispatched from the host;
on a CUDA card `step` captures its n substeps once as a CUDA graph (some
two thousand tiny launches a substep) and replays it, on the same ops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import contacts as ct
from ..models import robot as rm
from ..ops.spatial import motion_transform_inv


class SimState(NamedTuple):
    q: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor


class LeggedSimulator:
    """Semi-implicit Euler at `sim_dt`, torque-controlled."""

    def __init__(self, model: rm.RobotModel, contacts: ct.ContactModel,
                 sim_dt: float = 2e-4, ground_z: float = 0.0,
                 kp: float = 2e4, kd: float = 200.0, mu: float = 0.7,
                 kt: float = 300.0, terrain=None):
        """terrain: optional height map z = terrain(x, y) on tensors,
        replacing the flat ground at ground_z."""
        self.model = model
        self.contacts = contacts
        self.sim_dt = float(sim_dt)
        self.terrain = terrain
        self.params = (float(ground_z), float(kp), float(kd), float(mu),
                       float(kt))
        self._graphs = {}

    def init(self, q, v, t=0.0) -> SimState:
        kw = dict(dtype=self.model.dtype, device=self.model.device)
        return SimState(torch.as_tensor(q, **kw), torch.as_tensor(v, **kw),
                        torch.as_tensor(t, **kw))

    def step(self, state: SimState, u, n_substeps: int = 1) -> SimState:
        u = torch.as_tensor(u, dtype=self.model.dtype,
                            device=self.model.device)
        if u.device.type == "cuda":
            return self._replay(state, u, n_substeps)
        return self._substeps(state, u, n_substeps)

    def _substeps(self, state, u, n):
        for _ in range(n):
            state = _sim_step(self.model, self.contacts, self.sim_dt,
                              *self.params, state, u, terrain=self.terrain)
        return state

    def _replay(self, state, u, n):
        """n substeps as a CUDA graph, captured at the first call of these
        shapes: the state and u copied into the graph's input buffers, its
        outputs copied out."""
        key = (n, tuple(state.q.shape), tuple(u.shape))
        if key not in self._graphs:
            ins = [x.clone() for x in (*state, u)]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                # warm-up outside the capture: library handles, workspaces
                # and the cached index tensors are made here
                for _ in range(2):
                    self._substeps(SimState(*ins[:3]), ins[3], n)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self._substeps(SimState(*ins[:3]), ins[3], n)
            self._graphs[key] = (graph, ins, outs)
        graph, ins, outs = self._graphs[key]
        for buf, x in zip(ins, (*state, u)):
            buf.copy_(x)
        graph.replay()
        return SimState(*[x.clone() for x in outs])


def _contact_forces(model, contacts, ground_z, kp, kd, mu, kt, q, v,
                    terrain=None):
    """Each contact's force in its LOCAL frame from the penalty ground
    model, stacked: (..., 3 nc)."""
    R_w, p_w = rm.forward_kinematics(model, q)
    vs = rm.joint_velocities(model, q, v)
    forces = []
    for c in range(contacts.n_contacts):
        fid = contacts.frame_ids[c]
        par = model.frame_parents[fid]
        fR, fp = model.frame_R[fid], model.frame_p[fid]
        Rp = R_w[..., par, :, :]
        Rf = Rp @ fR
        pf = rm._mv(Rp, fp) + p_w[..., par, :]
        vf_local = motion_transform_inv(fR, fp, vs[..., par, :])
        v_world = rm._mv(Rf, vf_local[..., :3])
        gz = ground_z if terrain is None else terrain(pf[..., 0],
                                                      pf[..., 1])
        pen = gz - pf[..., 2]
        # the spring-damper normal force; the damper acts both ways while
        # in contact (a one-sided damper leaves the rebound undamped)
        fn = torch.where(pen > 0.0, kp * pen - kd * v_world[..., 2], 0.0)
        fn = torch.clamp(fn, min=0.0)
        vt = v_world[..., :2]
        vt_norm = torch.linalg.norm(vt, dim=-1) + 1e-8
        ft_mag = torch.minimum(mu * fn, kt * vt_norm)
        ft = -ft_mag.unsqueeze(-1) * vt / vt_norm.unsqueeze(-1)
        f_world = torch.cat([ft, fn.unsqueeze(-1)], dim=-1)
        forces.append(rm._mv(Rf.transpose(-1, -2), f_world))
    return torch.cat(forces, dim=-1)


def _sim_step(model, contacts, dt, ground_z, kp, kd, mu, kt,
              state: SimState, u, terrain=None) -> SimState:
    q, v, t = state
    f_stack = _contact_forces(model, contacts, ground_z, kp, kd, mu, kt,
                              q, v, terrain=terrain)
    f_joint = ct.contact_forces_to_joint(model, contacts, f_stack)
    tau = torch.cat([u.new_zeros(u.shape[:-1] + (model.dim_passive,)), u],
                    dim=-1)
    # M a = tau + (contact forces) - h(q, v)
    h = rm.rnea(model, q, v, torch.zeros_like(v), f_joint)
    M = rm.crba(model, q)
    # solve_ex: the LU solve of linalg.solve without its error check,
    # which would synchronise the host with the card at every substep
    a = torch.linalg.solve_ex(M, (tau - h).unsqueeze(-1))[0].squeeze(-1)
    v_new = v + dt * a
    q_new = rm.integrate(model, q, dt * v_new)
    return SimState(rm.normalize(model, q_new), v_new, t + dt)

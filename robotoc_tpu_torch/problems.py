"""Ready-made problems of the port.

`anymal_standing` builds the ANYmal contact OCP that
tests/golden/anymal_standing_ocp.npz pins: four point contacts with
5-facet friction cones, joint limits and a configuration cost, all feet
in stance, T = 0.5, no impact slots.

`anymal_trot` builds the mid-gait ANYmal trot MPC problem (the JAX
package's flagship, __graft_entry__._flagship): MPCTrot at t = 0.35 with
one lift and one touchdown in the horizon, impact slots, the gait cost
stack, and an OCPSolver with switching constraints. `fleet` broadcasts a
warm start to B scenarios whose initial configurations are moved in the
tangent space by seeded noise.

`icub_standing` builds the iCub lower-half standing OCP on two surface
contacts (the setup of tests/test_biped.py). `icub_walk` builds the
iCub lower-half biped walk MPC problem (MPCBipedWalk, the JAX package's
tools/bench_icub_walk.py): surface contacts with 17-row wrench cones,
impact slots, switching constraints and the gait cost stack;
`walk_warm_start` warms its iterate the way the MPC runs (standing
`init`, then closed-loop updates to mid-gait).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .constraints.joint_limits import JointLimits, make_joint_limits
from .costs.config_cost import ConfigurationSpaceCost, make_config_cost
from .models import load_robot
from .models import robot as rm
from .models.contacts import SURFACE, ContactModel, make_contacts
from .planner.contact_sequence import (ContactSchedule, GridData,
                                       discretize)
from .solver import ocp_solver as OS

FEET = ("LF_FOOT", "LH_FOOT", "RF_FOOT", "RH_FOOT")
Q_STAND = (0, 0, 0.4792, 0, 0, 0, 1, -0.1, 0.7, -1.0, -0.1, -0.7, 1.0, 0.1,
           0.7, -1.0, 0.1, -0.7, 1.0)


@dataclasses.dataclass
class Problem:
    model: rm.RobotModel
    contacts: ContactModel
    cost: ConfigurationSpaceCost
    limits: JointLimits
    grid: GridData
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


def anymal_standing(N: int = 20, T: float = 0.5, dtype=torch.float64,
                    device=None) -> Problem:
    m = load_robot("anymal", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    contacts = make_contacts(m, list(FEET), baumgarte_time_step=0.04)
    q0 = torch.tensor(Q_STAND, **kw)
    qw = torch.tensor([0, 0, 0, 250000, 250000, 250000] + [0.0001] * 12,
                      **kw)
    vw = torch.tensor([100.0] * 6 + [1.0] * 12, **kw)
    cost = make_config_cost(m, q_ref=q0, q_weight=qw, v_weight=vw,
                            a_weight=1e-6, u_weight=1e-1,
                            q_weight_terminal=qw, v_weight_terminal=vw)
    lim = make_joint_limits(m, u_limit=torch.full((12,), 80.0, **kw),
                            v_limit=torch.full((12,), 15.0, **kw))
    Rw, pw = rm.forward_kinematics(m, q0)
    plc = np.stack([rm.frame_placement(m, m.frame_id(f), Rw, pw)[1]
                    .double().cpu().numpy() for f in FEET])
    sched = ContactSchedule(nc=len(FEET)).init([True] * len(FEET), plc)
    grid = discretize(sched, 0.0, T, N, dtype=dtype, device=m.device)
    return Problem(model=m, contacts=contacts, cost=cost, limits=lim,
                   grid=grid, q0=q0, v0=torch.zeros(m.nv, **kw), T=T, N=N)


@dataclasses.dataclass
class GaitProblem:
    model: rm.RobotModel
    mpc: object                  # mpc.gait_mpc.PeriodicGaitMPC
    solver: OS.OCPSolver
    grid: GridData
    costs: tuple
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


def anymal_trot(N: int = 20, T: float = 0.5, dtype=torch.float64,
                device=None, t0: float = 0.35,
                options: OS.SolverOptions = OS.SolverOptions(
                    switching_constraints=True)) -> GaitProblem:
    """Mid-gait ANYmal trot: step length 0.15 m, swing height 0.1, swing
    time 0.25, no stance phase, first swing at 0.5 s, planned at t0."""
    from .mpc.mpc_trot import MPCTrot
    m = load_robot("anymal", dtype=dtype, device=device)
    mpc = MPCTrot(m, T=T, N=N, options=options)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.15, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.25,
                         stance_time=0.0, swing_start_time=0.5)
    kw = dict(dtype=dtype, device=m.device)
    q0 = torch.tensor(Q_STAND, **kw)
    v0 = torch.zeros(m.nv, **kw)
    mpc.planner.init(np.asarray(Q_STAND, dtype=float))
    mpc.config_cost = dataclasses.replace(mpc.config_cost, q_ref=q0)
    grid, costs = mpc._build_schedule_and_costs(t0, q0, v0)
    solver = OS.OCPSolver(m, mpc.contacts, costs, mpc.limits, T=T, N=N,
                          options=options, n_reserved_events=mpc.n_reserved)
    return GaitProblem(model=m, mpc=mpc, solver=solver, grid=grid,
                       costs=costs, q0=q0, v0=v0, T=T, N=N)


def icub_walk_q0(model) -> np.ndarray:
    """The iCub lower half standing with knees bent by pi/6, the base height
    set so that both soles touch z = 0."""
    knee = np.pi / 6
    q0 = np.array([0, 0, 0, 0, 0, 0, 1,
                   0.5 * knee, 0, 0, -knee, 0.5 * knee, 0,
                   0.5 * knee, 0, 0, -knee, 0.5 * knee, 0])
    qt = torch.as_tensor(q0, dtype=model.dtype, device=model.device)
    Rw, pw = rm.forward_kinematics(model, qt)
    zs = [float(rm.frame_placement(model, model.frame_id(f), Rw, pw)[1][2])
          for f in ("l_sole", "r_sole")]
    q0[2] = -0.5 * (zs[0] + zs[1])
    return q0


def icub_standing(N: int = 4, dtype=torch.float64, device=None) -> Problem:
    """The iCub lower half standing on both soles (surface contacts, 17-row
    wrench cones on a 0.1 x 0.05 rectangle, Baumgarte time 0.05), the
    bent-knee pose held by a configuration cost, T = 0.025 N, all stages in
    double support with the soles' placements and rotations as references."""
    m = load_robot("icub_lower_half", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    soles = ["l_sole", "r_sole"]
    contacts = make_contacts(m, soles, types=(SURFACE, SURFACE),
                             baumgarte_time_step=0.05, rect=(0.1, 0.05))
    q0 = torch.as_tensor(icub_walk_q0(m), **kw)
    qw = torch.tensor([0, 0, 0, 1000, 1000, 1000] + [0.001] * (m.nv - 6),
                      **kw)
    vw = torch.full((m.nv,), 1.0, **kw)
    cost = make_config_cost(m, q_ref=q0, q_weight=qw, v_weight=vw,
                            a_weight=1e-6, u_weight=1e-2,
                            q_weight_terminal=qw, v_weight_terminal=vw)
    lim = make_joint_limits(m, u_limit=torch.full((m.dimu,), 60.0, **kw),
                            v_limit=torch.full((m.dimu,), 10.0, **kw))
    Rw, pw = rm.forward_kinematics(m, q0)
    plc = [rm.frame_placement(m, m.frame_id(f), Rw, pw) for f in soles]
    p_ref = np.stack([p.double().cpu().numpy() for _, p in plc])
    R_ref = np.stack([R.double().cpu().numpy() for R, _ in plc])
    sched = ContactSchedule(nc=2).init([True, True], p_ref, rotations=R_ref)
    T = 0.025 * N
    grid = discretize(sched, 0.0, T, N, dtype=dtype, device=m.device)
    return Problem(model=m, contacts=contacts, cost=cost, limits=lim,
                   grid=grid, q0=q0, v0=torch.zeros(m.nv, **kw), T=T, N=N)


def icub_walk(N: int = 25, T: float = 0.7, dtype=torch.float64,
              device=None, t0: Optional[float] = None,
              options: OS.SolverOptions = OS.SolverOptions(
                  switching_constraints=True)) -> GaitProblem:
    """The iCub lower-half biped walk (MPCBipedWalk): two surface contacts
    with 17-row wrench cones on a 0.05 x 0.025 sole rectangle, step
    (0.22, 0, 0), swing height 0.1, swing time 0.7, no stance phase, first
    swing at 0.5 s. With t0 None the problem is planned at t = 0 in double
    support; with t0 it is planned at t0 from the standing configuration
    (the caller warms the iterate, as `walk_warm_start` does)."""
    from .mpc.gait_mpc import MPCBipedWalk
    m = load_robot("icub_lower_half", dtype=dtype, device=device)
    mpc = MPCBipedWalk(m, T=T, N=N, options=options)
    mpc.set_wrench_cone_rectangular(X=0.05, Y=0.025)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.22, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.7,
                         stance_time=0.0, swing_start_time=0.5)
    kw = dict(dtype=dtype, device=m.device)
    q0np = icub_walk_q0(m)
    q0 = torch.as_tensor(q0np, **kw)
    v0 = torch.zeros(m.nv, **kw)
    mpc.planner.init(q0np)
    mpc.config_cost = dataclasses.replace(mpc.config_cost, q_ref=q0)
    grid, costs = mpc._build_schedule_and_costs(
        0.0 if t0 is None else t0, q0, v0)
    solver = OS.OCPSolver(m, mpc.contacts, costs, mpc.limits, T=T, N=N,
                          options=options, n_reserved_events=mpc.n_reserved)
    return GaitProblem(model=m, mpc=mpc, solver=solver, grid=grid,
                       costs=costs, q0=q0, v0=v0, T=T, N=N)


def walk_warm_start(p: GaitProblem, t_target: float, control_dt: float):
    """Warm the walk's iterate the way the MPC runs: `init` at standing
    double support (40 updates), then closed-loop MPC updates (two each)
    every control_dt up to t_target, the state moved by the plan's first
    velocity and acceleration. Returns (t, q, v) reached; p.mpc then holds
    the grid, cost stack and iterate at t."""
    mpc, m = p.mpc, p.model
    mpc.init(0.0, p.q0, p.v0, num_iters=40)
    t, q, v = 0.0, p.q0, p.v0
    while t < t_target - 1e-9:
        mpc.update_solution(t, control_dt, q, v, max_iter=2)
        q = rm.integrate(m, q, control_dt * mpc.sol.v[0])
        v = mpc.sol.v[0] + control_dt * mpc.sol.a[0]
        t += control_dt
    return t, q, v


def fleet(solver, grid, q0, v0, B: int, seed: int = 0,
          scale: float = 0.03):
    """(warm start (B, S, ...), q0s (B, nq), v0s (B, nv)): the solver's warm
    start at (q0, v0) broadcast to B scenarios whose initial configurations
    are moved by scale * N(0, 1) in the tangent space (numpy seed)."""
    m = solver.model
    sol = solver.init_solution(grid, q0, v0).map(
        lambda x: x.expand((B,) + x.shape).contiguous())
    rng = np.random.default_rng(seed)
    kw = dict(dtype=m.dtype, device=m.device)
    dq = torch.as_tensor(scale * rng.standard_normal((B, m.nv)), **kw)
    q0s = rm.integrate(m, q0.expand(B, m.nq), dq)
    return sol, q0s, v0.expand(B, m.nv).contiguous()

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
impact slots, switching constraints and the gait cost stack.

`a1_crawl` builds the Unitree A1 crawl MPC on a height map (MPCCrawl,
four point feet, the planner's placements snapped to `a1_terrain`), and
`anymal_gait` the ANYmal pace or flying trot MPC; `warm_start` warms any
of these gait problems the way the MPC runs (`init`, then closed-loop
updates to mid-gait).

`iiwa14_config` builds the KUKA iiwa14 configuration-space OCP that
tests/golden/iiwa14_config_ocp.npz pins (fixed base, no contacts) with
the unconstrained Riccati solver or the ParNMPC solver; `iiwa14_fleet`
moves its initial configuration by seeded noise for B scenarios.
`iiwa14_task_space` drives the iiwa14's end effector to a world target
(a task-space cost on a constant reference beside a configuration cost)
with the unconstrained Riccati solver.

`anymal_jump` builds the ANYmal jump MPC (MPCJump: stance, a full flight
and the landing impact with its switching constraint, the KKT-residual
line search) with its jump pattern set.

`anymal_trot_sim` builds the ANYmal trot MPC of examples/anymal_trot_mpc.py
with the penalty-ground plant it runs against in closed loop
(sim.LeggedSimulator). `anymal_bounce` builds the offline multi-cycle
bounce OCP of examples/anymal_bounce.py: a fixed contact schedule with
touchdown impacts, periodic swing-foot and CoM references beside a
configuration cost, solved by OCPSolver with the KKT-residual search.
"""
from __future__ import annotations

import dataclasses
import math
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
from .parnmpc import solver as PN
from .solver import ocp_solver as OS
from .solver import unconstr_ocp_solver as US

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


def _gait_problem(mpc, q0, t0: float, options) -> GaitProblem:
    """The gait MPC's problem planned at t0 from configuration q0 (numpy)
    at rest: the planner initialised at q0, the configuration reference
    q0, the grid, the cost stack and an OCPSolver with the MPC's impact
    slots."""
    m = mpc.model
    kw = dict(dtype=m.dtype, device=m.device)
    q = torch.as_tensor(np.asarray(q0, dtype=float), **kw)
    v = torch.zeros(m.nv, **kw)
    mpc.planner.init(np.asarray(q0, dtype=float))
    mpc.config_cost = dataclasses.replace(mpc.config_cost, q_ref=q)
    grid, costs = mpc._build_schedule_and_costs(t0, q, v)
    solver = OS.OCPSolver(m, mpc.contacts, costs, mpc.limits, T=mpc.T,
                          N=mpc.N, options=options,
                          n_reserved_events=mpc.n_reserved)
    return GaitProblem(model=m, mpc=mpc, solver=solver, grid=grid,
                       costs=costs, q0=q, v0=v, T=mpc.T, N=mpc.N)


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
    return _gait_problem(mpc, Q_STAND, t0, options)


# the ANYmal gaits of examples/anymal_gait_mpc.py: (MPC class name, step
# length, swing time, swing height, flying time); first swing at 0.5 s,
# no stance phase
ANYMAL_GAITS = {"pace": ("MPCPace", 0.05, 0.25, 0.08, 0.0),
                "flying_trot": ("MPCFlyingTrot", 0.15, 0.20, 0.10, 0.06)}


def anymal_gait(name: str, N: int = 20, T: float = 0.5,
                dtype=torch.float64, device=None, t0: float = 0.35,
                options: OS.SolverOptions = OS.SolverOptions(
                    switching_constraints=True)) -> GaitProblem:
    """The ANYmal pace ("pace": lateral pairs, step 0.05 m, swing 0.25 s,
    height 0.08) or flying trot ("flying_trot": diagonal pairs, step 0.15
    m, swing 0.20 s, height 0.10, a 0.06 s flight between steps) planned
    at t0 from standing. At the default t0 = 0.35 the pace's horizon holds
    the first lift and its touchdown, the flying trot's the first swing, a
    flight (no contact active) and the touchdown after it."""
    from .mpc import gait_mpc
    cls, step, swing, height, flying = ANYMAL_GAITS[name]
    m = load_robot("anymal", dtype=dtype, device=device)
    mpc = getattr(gait_mpc, cls)(m, T=T, N=N, options=options)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([step, 0, 0]), 0.0)
    if flying > 0:
        mpc.set_gait_pattern(planner, swing_height=height, swing_time=swing,
                             flying_time=flying, swing_start_time=0.5)
    else:
        mpc.set_gait_pattern(planner, swing_height=height, swing_time=swing,
                             stance_time=0.0, swing_start_time=0.5)
    return _gait_problem(mpc, Q_STAND, t0, options)


@dataclasses.dataclass
class JumpProblem:
    model: rm.RobotModel
    mpc: object                  # mpc.mpc_jump.MPCJump
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


def anymal_jump(N: int = 10, T: float = 0.85, dtype=torch.float64,
                device=None, jump_length=(0.1, 0.0, 0.0),
                flying_time: float = 0.25, ground_time: float = 0.3,
                options: Optional[OS.SolverOptions] = None) -> JumpProblem:
    """The ANYmal jump MPC (examples/anymal_jump_mpc.py,
    tests/test_mpc_jump.py): MPCJump on the four point feet, T 0.85, N 10,
    the jump pattern set (length `jump_length`, no yaw, flight
    `flying_time`, ground `ground_time`), standing at Q_STAND at rest.
    `options`: the solver's, MPCJump's (two updates, switching
    constraints, the KKT-residual search) when None. mpc.init plans it."""
    from .mpc.mpc_jump import MPCJump
    m = load_robot("anymal", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    mpc = MPCJump(m, T=T, N=N, options=options)
    mpc.set_jump_pattern(jump_length=list(jump_length), jump_yaw=0.0,
                         flying_time=flying_time, ground_time=ground_time)
    return JumpProblem(model=m, mpc=mpc, q0=torch.tensor(Q_STAND, **kw),
                       v0=torch.zeros(m.nv, **kw), T=T, N=N)


@dataclasses.dataclass
class SimProblem:
    model: rm.RobotModel
    mpc: object                  # mpc.mpc_trot.MPCTrot
    simulator: object            # sim.LeggedSimulator
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


def anymal_trot_sim(N: int = 20, T: float = 0.5, dtype=torch.float64,
                    device=None,
                    options: Optional[OS.SolverOptions] = None
                    ) -> SimProblem:
    """The ANYmal trot MPC of examples/anymal_trot_mpc.py (step 0.15 m,
    swing height 0.1, swing 0.25 s, no stance phase, first swing at 0.5 s;
    MPCTrot's options when `options` is None) and the plant it runs
    against (LeggedSimulator at sim_dt 2.5e-4), standing at Q_STAND at
    rest. mpc.init plans it."""
    from .mpc.mpc_trot import MPCTrot
    from .sim import LeggedSimulator
    m = load_robot("anymal", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    mpc = (MPCTrot(m, T=T, N=N) if options is None
           else MPCTrot(m, T=T, N=N, options=options))
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.15, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.25,
                         stance_time=0.0, swing_start_time=0.5)
    sim = LeggedSimulator(m, mpc.contacts, sim_dt=2.5e-4)
    return SimProblem(model=m, mpc=mpc, simulator=sim,
                      q0=torch.tensor(Q_STAND, **kw),
                      v0=torch.zeros(m.nv, **kw), T=T, N=N)


@dataclasses.dataclass
class BounceProblem:
    model: rm.RobotModel
    contacts: ContactModel
    costs: tuple                 # (ConfigurationSpaceCost, MultiFrameTaskCost)
    limits: JointLimits
    schedule: ContactSchedule
    grid: GridData
    solver: OS.OCPSolver
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


# the bounce of examples/anymal_bounce.py: the hind pair (LH, RH) and the
# front pair (LF, RF) swing in turns; step, step height, swing time,
# double-support time, first swing
BOUNCE = (np.array([0.275, 0.0, 0.0]), 0.125, 0.26, 0.04, 0.1)


def anymal_bounce(cycles: int = 1, dtype=torch.float64, device=None,
                  options: Optional[OS.SolverOptions] = None
                  ) -> BounceProblem:
    """The ANYmal bounce OCP of examples/anymal_bounce.py over `cycles`
    cycles: a configuration cost with impact weights, joint limits,
    PeriodicSwingFootRef stacked over the four feet and PeriodicCoMRef in
    a MultiFrameTaskCost, the contact schedule (hind pair, double support,
    front pair, double support per cycle) discretised at dt 0.02 with 2
    cycles reserved impact slots, and an OCPSolver with the KKT-residual
    search to KKT 1e-6 in at most 150 iterations (tests/
    test_offline_gaits.py) when `options` is None."""
    from .costs.task_cost import (MultiFrameTaskCost, PeriodicCoMRef,
                                  PeriodicSwingFootRef)
    m = load_robot("anymal", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    contacts = make_contacts(m, list(FEET), baumgarte_time_step=0.05)
    nv = m.nv
    step_length, step_height, swing_time, double_support_time, t0 = BOUNCE
    q0 = torch.tensor(Q_STAND, **kw)
    qw = torch.tensor([0, 0, 0, 250000, 250000, 250000] + [0.0001] * 12,
                      **kw)
    vw = torch.tensor([100.0] * 6 + [1.0] * 12, **kw)
    qwi = torch.tensor([1.0] * 6 + [100.0] * 12, **kw)
    config_cost = make_config_cost(
        m, q_ref=q0, q_weight=qw, v_weight=vw, a_weight=1e-6,
        u_weight=1e-1, q_weight_terminal=qw, v_weight_terminal=vw,
        q_weight_impact=qwi, v_weight_impact=torch.full((nv,), 100.0, **kw),
        dv_weight_impact=torch.full((nv,), 1e-6, **kw))
    lim = make_joint_limits(m, u_limit=torch.full((12,), 80.0, **kw),
                            v_limit=torch.full((12,), 15.0, **kw))
    Rw, pw = rm.forward_kinematics(m, q0)
    plc = np.stack([rm.frame_placement(m, m.frame_id(f), Rw, pw)[1]
                    .double().cpu().numpy() for f in FEET])
    com0 = rm.com(m, q0).double().cpu().numpy()

    # the hind pair first at t0, the front pair half a cycle later; each
    # foot advances a full step per cycle
    period_full = 2.0 * swing_time + 2.0 * double_support_time
    front_t0 = t0 + swing_time + double_support_time
    starts = [front_t0, t0, front_t0, t0]            # LF, LH, RF, RH

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), **kw)

    foot_refs = PeriodicSwingFootRef(
        p0=t(plc), step_length=t(np.tile(step_length, (4, 1))),
        step_height=t([step_height] * 4), t0=t(starts),
        period_swing=t([swing_time] * 4), period=t([period_full] * 4))
    com_ref = PeriodicCoMRef(
        com0=t(com0), vcom=t(0.5 * step_length / swing_time), t0=t(t0),
        period_active=t(swing_time), period_inactive=t(double_support_time))
    zero3 = torch.zeros(3, **kw)
    task_cost = MultiFrameTaskCost(
        frame_ids=tuple(m.frame_id(f) for f in FEET),
        foot_weight=torch.full((3,), 1e6, **kw), foot_weight_terminal=zero3,
        foot_weight_impact=zero3, com_weight=torch.full((3,), 1e6, **kw),
        com_weight_terminal=zero3, com_weight_impact=zero3,
        foot_refs=foot_refs, com_ref=com_ref)

    LF, LH, RF, RH = range(4)
    sched = ContactSchedule(nc=4, default_friction=0.7)
    sched.init([True] * 4, plc.copy(), t0=0.0)
    pos = plc.copy()
    ts = t0
    for _ in range(cycles):
        sched.push_back([True, False, True, False], pos.copy(), ts)
        pos[LH] += step_length
        pos[RH] += step_length
        sched.push_back([True] * 4, pos.copy(), ts + swing_time)
        sched.push_back([False, True, False, True], pos.copy(),
                        ts + swing_time + double_support_time)
        pos[LF] += step_length
        pos[RF] += step_length
        sched.push_back([True] * 4, pos.copy(),
                        ts + 2 * swing_time + double_support_time)
        ts += 2 * swing_time + 2 * double_support_time

    T = t0 + cycles * (2 * double_support_time + 2 * swing_time)
    N = int(np.floor(T / 0.02))
    n_impacts = 2 * cycles
    grid = discretize(sched, 0.0, T, N, n_reserved=n_impacts, dtype=dtype,
                      device=m.device)
    if options is None:
        options = OS.SolverOptions(max_iter=150, kkt_tol=1e-6,
                                   enable_line_search="kkt")
    costs = (config_cost, task_cost)
    solver = OS.OCPSolver(m, contacts, costs, lim, T=T, N=N,
                          options=options, n_reserved_events=n_impacts)
    return BounceProblem(model=m, contacts=contacts, costs=costs,
                         limits=lim, schedule=sched, grid=grid,
                         solver=solver, q0=q0, v0=torch.zeros(nv, **kw),
                         T=T, N=N)


A1_FEET = ("FL_foot", "RL_foot", "FR_foot", "RR_foot")


def a1_q0() -> np.ndarray:
    """The Unitree A1 standing (base at 0.3181 m, each leg at hip 0, thigh
    0.67, calf -1.3)."""
    return np.array([0, 0, 0.3181, 0, 0, 0, 1] + [0.0, 0.67, -1.3] * 4)


def a1_terrain(x: float, y: float) -> float:
    """The height map of the A1 crawl: rolling bumps on a gentle ramp."""
    return 0.03 * math.sin(4.0 * x) * math.cos(3.0 * y) + 0.04 * x


def a1_crawl(N: int = 20, T: float = 0.5, dtype=torch.float64,
             device=None, t0: float = 0.0,
             options: OS.SolverOptions = OS.SolverOptions(
                 switching_constraints=True)) -> GaitProblem:
    """The A1 crawl on terrain (MPCCrawl on the feet A1_FEET, Baumgarte
    time 0.05): step (0.12, 0, 0), swing height 0.1, swing 0.25 s, stance
    0.05 s, first swing at 0.5 s (one foot at a time: RR, FR, RL, FL, one
    step every 0.3 s); the planner snaps placements to `a1_terrain`.
    Planned at t0 from standing; `warm_start` warms it as the MPC runs."""
    from .mpc.gait_mpc import MPCCrawl
    m = load_robot("a1", dtype=dtype, device=device)
    mpc = MPCCrawl(m, T=T, N=N, feet=list(A1_FEET), options=options,
                   baumgarte_time_step=0.05)
    planner = mpc.make_planner(terrain=a1_terrain)
    planner.set_gait_pattern(np.array([0.12, 0.0, 0.0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.25,
                         stance_time=0.05, swing_start_time=0.5)
    return _gait_problem(mpc, a1_q0(), t0, options)


@dataclasses.dataclass
class ArmProblem:
    model: rm.RobotModel
    cost: ConfigurationSpaceCost
    limits: JointLimits
    solver: object     # UnconstrOCPSolver or UnconstrParNMPCSolver
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


IIWA_Q_REF = (0, np.pi / 2, 0, np.pi / 2, 0, np.pi / 2, 0)
IIWA_Q0 = (np.pi / 2, 0, np.pi / 2, 0, np.pi / 2, 0, np.pi / 2)


def iiwa14_config(N: int = 60, T: float = 3.0, dtype=torch.float64,
                  device=None, options=None,
                  parnmpc: bool = False) -> ArmProblem:
    """The iiwa14 configuration-space OCP of the golden trace
    (tests/golden/make_golden.py): q driven from q0 to q_ref with q
    weight 10, v and a weights 0.01, no u weight, terminal weights 10 and
    0.01; torques within 50, velocities within pi/2; starting at rest.
    The solver is UnconstrOCPSolver, or UnconstrParNMPCSolver with
    parnmpc=True, with `options` of that solver (its defaults when
    None)."""
    m = load_robot("iiwa14", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    cost = make_config_cost(m, q_ref=torch.tensor(IIWA_Q_REF, **kw),
                            q_weight=10, v_weight=0.01, a_weight=0.01,
                            u_weight=0.0, q_weight_terminal=10,
                            v_weight_terminal=0.01)
    lim = make_joint_limits(m, u_limit=torch.full((7,), 50.0, **kw),
                            v_limit=torch.full((7,), np.pi / 2, **kw))
    mod = PN if parnmpc else US
    cls = PN.UnconstrParNMPCSolver if parnmpc else US.UnconstrOCPSolver
    solver = cls(m, cost, lim, T=T, N=N,
                 options=options if options is not None
                 else mod.SolverOptions())
    return ArmProblem(model=m, cost=cost, limits=lim, solver=solver,
                      q0=torch.tensor(IIWA_Q0, **kw),
                      v0=torch.zeros(7, **kw), T=T, N=N)


@dataclasses.dataclass
class TaskSpaceProblem:
    model: rm.RobotModel
    costs: tuple                 # (configuration cost, task-space cost)
    limits: JointLimits
    solver: US.UnconstrOCPSolver
    frame_id: int
    target: torch.Tensor
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


def iiwa14_task_space(N: int = 30, T: float = 1.5, dtype=torch.float64,
                      device=None, options=None) -> TaskSpaceProblem:
    """The iiwa14 task-space OCP (examples/iiwa14_task_space_ocp.py): from
    q0 = 0.5 in every joint at rest, the last frame (the end effector)
    tracks its start position moved by (0.1, 0.1, -0.1) with
    TaskSpace3DCost on a ConstantRef (weights 1000, terminal 10 times
    that), beside a configuration cost holding q0 (q weight 0.1, v and a
    0.01, terminal 0.1 and 0.01); torques within 100, velocities within
    pi; UnconstrOCPSolver with `options` (its defaults when None)."""
    from .costs.task_cost import ConstantRef, TaskSpace3DCost
    m = load_robot("iiwa14", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    fid = m.frame_id(m.frame_names[-1])
    q0 = torch.full((7,), 0.5, **kw)
    target = rm.frame_position(m, fid, q0) + torch.tensor([0.1, 0.1, -0.1],
                                                          **kw)
    cfg = make_config_cost(m, q_ref=q0, q_weight=0.1, v_weight=0.01,
                           a_weight=0.01, q_weight_terminal=0.1,
                           v_weight_terminal=0.01)
    w3 = torch.full((3,), 1000.0, **kw)
    task = TaskSpace3DCost(frame_id=fid, weight=w3, weight_terminal=10.0 * w3,
                           weight_impact=w3, ref=ConstantRef(p=target))
    lim = make_joint_limits(m, u_limit=torch.full((7,), 100.0, **kw),
                            v_limit=torch.full((7,), math.pi, **kw))
    solver = US.UnconstrOCPSolver(m, (cfg, task), lim, T=T, N=N,
                                  options=options if options is not None
                                  else US.SolverOptions())
    return TaskSpaceProblem(model=m, costs=(cfg, task), limits=lim,
                            solver=solver, frame_id=fid, target=target,
                            q0=q0, v0=torch.zeros(7, **kw), T=T, N=N)


def iiwa14_fleet(p: ArmProblem, B: int, seed: int = 0,
                 scale: float = 0.05):
    """(q0s (B, 7), v0s (B, 7)): the problem's initial configuration moved
    by scale * N(0, 1) (numpy seed), at rest."""
    rng = np.random.default_rng(seed)
    dq = torch.as_tensor(scale * rng.standard_normal((B, 7)),
                         dtype=p.model.dtype, device=p.model.device)
    return p.q0 + dq, p.v0.expand(B, 7).contiguous()


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
    (the caller warms the iterate, as `warm_start` does)."""
    from .mpc.gait_mpc import MPCBipedWalk
    m = load_robot("icub_lower_half", dtype=dtype, device=device)
    mpc = MPCBipedWalk(m, T=T, N=N, options=options)
    mpc.set_wrench_cone_rectangular(X=0.05, Y=0.025)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.22, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.7,
                         stance_time=0.0, swing_start_time=0.5)
    return _gait_problem(mpc, icub_walk_q0(m), 0.0 if t0 is None else t0,
                         options)


def warm_start(p: GaitProblem, t_target: float, control_dt: float,
               init_iters: int = 40):
    """Warm a gait problem's iterate the way the MPC runs: `init` at t = 0
    from standing (init_iters updates), then closed-loop MPC updates (two
    each) every control_dt up to t_target, the state moved by the plan's
    first velocity and acceleration. Returns (t, q, v) reached; p.mpc then
    holds the grid, cost stack and iterate at t."""
    mpc, m = p.mpc, p.model
    mpc.init(0.0, p.q0, p.v0, num_iters=init_iters)
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


def icub_soles(dtype=torch.float64, device=None):
    """The full iCub (nv 35: two legs and a torso whose last joint carries
    both arms) on surface contacts at both soles (17-row wrench cones on a
    0.1 x 0.05 rectangle): the tree of the chain kernel K6's nv 35
    instance. No MPC path runs it; it is checked kernel against plain.
    Returns (model, contacts)."""
    m = load_robot("icub", dtype=dtype, device=device)
    contacts = make_contacts(m, ("l_sole", "r_sole"),
                             types=(SURFACE, SURFACE), rect=(0.1, 0.05))
    return m, contacts


def chain_stages(model, contacts, S: int, seed: int = 0,
                 with_cost: bool = False):
    """Seeded inputs of the chain kernel K6 for S stages, in the order of
    ops/chain.chain (numpy seed): configurations moved from neutral by
    0.3 N(0, 1) in the tangent space, velocities and accelerations N(0, 1),
    contact forces 30 N(0, 1), friction 0.5 + 0.3 U(0, 1), p_ref 0.3
    N(0, 1), R_ref each contact frame's rotation turned by exp(0.2 N(0,
    1)) (references near the feet, as a walk sets them: the residual's
    rotation log stays clear of its branch cut at pi, where two correct
    evaluations may differ by 2 pi; the full iCub's soles sit near pi
    from the identity). With with_cost also the
    cost fold's 14 inputs: u N(0, 1), dt 0.02 + 0.03 U, task references
    0.3 N, task activity 0 or 1, the base-rotation reference the base
    quaternion of q moved by 0.1 N (a rotation log far from pi, where it is
    ill-conditioned), positive weights 0.1 + U, q_ref moved from neutral by
    0.1 N, v_ref 0.3 N and q_next moved from q by 0.05 N. Returns (args, cost), lists of
    (S, ...) tensors."""
    rng = np.random.default_rng(seed)
    kw = dict(dtype=model.dtype, device=model.device)
    nc, nv = contacts.n_contacts, model.nv

    def t(x):
        return torch.as_tensor(x, **kw).contiguous()

    def moved(q, scale):
        return rm.integrate(model, q, t(scale * rng.standard_normal(
            (S, nv))))

    q = moved(rm.neutral(model).expand(S, model.nq), 0.3)
    w = t(0.2 * rng.standard_normal((S, nc, 3)))
    from .ops import lie
    Rw, pw = rm.forward_kinematics(model, q)
    R_frame = torch.stack([rm.frame_placement(model, f, Rw, pw)[0]
                           for f in contacts.frame_ids], dim=1)
    args = [q, t(rng.standard_normal((S, nv))),
            t(rng.standard_normal((S, nv))),
            t(30.0 * rng.standard_normal((S, contacts.max_dimf))),
            t(0.5 + 0.3 * rng.uniform(size=(S, nc))),
            t(0.3 * rng.standard_normal((S, nc, 3))),
            (R_frame @ lie.so3_exp(w)).contiguous()]
    if not with_cost:
        return args, []
    nu, nt = model.dimu, 3 * nc + 3

    def weight(n):
        return t(0.1 + rng.uniform(size=(S, n)))

    cost = [t(rng.standard_normal((S, nu))),
            t(0.02 + 0.03 * rng.uniform(size=(S, 1))),
            t(0.3 * rng.standard_normal((S, nt))),
            t((rng.uniform(size=(S, nt)) < 0.5).astype(float)),
            moved(q, 0.1)[:, 3:7].contiguous(),
            weight(nv), weight(nv), weight(nv), weight(nu), weight(nt),
            weight(3), moved(rm.neutral(model).expand(S, model.nq), 0.1),
            t(0.3 * rng.standard_normal((S, nv))), moved(q, 0.05)]
    return args, cost

"""Shared builders for the PyTorch port's tests (tests/test_torch_*.py).

The ANYmal standing contact OCP of tests/test_golden_traces.py is built
with the JAX package, and its objects are handed to the port through
`robotoc_tpu_torch.convert` as field dictionaries of numpy arrays, so both
packages compute from the same inputs. Inputs the tests invent come from
numpy seeds.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from robotoc_tpu_torch import convert

# One intra-op thread: the port's tests run many tiny products batched
# over a fleet dim (a B = 2 fleet's 14 x 14 Riccati blocks); each such
# product started on the default thread pool costs milliseconds of thread
# hand-off on a CPU host that runs other test workers (on an 8-core host:
# 13.7 ms against 0.018 ms for a (2, 14, 14) product with eight threads
# against one), and the sizes here gain nothing from threads. What the
# tests compare, and to what tolerance, is unchanged.
torch.set_num_threads(1)

FEET = ["LF_FOOT", "LH_FOOT", "RF_FOOT", "RH_FOOT"]
Q_STAND = [0, 0, 0.4792, 0, 0, 0, 1, -0.1, 0.7, -1.0, -0.1, -0.7, 1.0, 0.1,
           0.7, -1.0, 0.1, -0.7, 1.0]


def fields(obj):
    """Fields of a JAX-package dataclass: arrays as numpy, statics as
    they are."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (str, bool, int, float, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def np_tree(x):
    """JAX pytree -> the same structure with numpy leaves."""
    return jax.tree.map(np.array, x)


def jax_fleet(fn, sol, *per_scenario):
    """A jitted one-scenario JAX function `fn(sol, *args)` on each scenario
    of a fleet (numpy Solution fields (B, ...), args (B, ...)), its outputs
    stacked over B as numpy: one trace for every scenario, where a vmap of
    the function would trace its batched form (a third longer for an
    update)."""
    from robotoc_tpu.solver import ocp_solver as JOS
    outs = []
    for b in range(len(per_scenario[0])):
        js = JOS.Solution(**{k: jnp.asarray(v[b]) for k, v in sol.items()})
        outs.append(np_tree(fn(js, *[jnp.asarray(a[b])
                                     for a in per_scenario])))
    return jax.tree.map(lambda *xs: np.stack(xs), *outs)


def jit_unoptimised(fn):
    """fn jitted with XLA's backend optimisation off: the same operations
    in the same order, a quarter less compile time for a one-off reference
    such as a whole update (its results agree with the optimised build's
    to the last digits the tests read)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def jax_init_solution(solver, grid, q, v):
    """A JAX OCPSolver's warm start, jitted: one compile in place of the
    eager dispatch of every op (the same values, a tenth of the time)."""
    return jax.jit(solver.init_solution)(grid, q, v)


def jax_mpc_solver(mpc, costs):
    """A JAX MPC's solver built as the MPC's `init` builds it (its model,
    contacts, limits, horizon, options and reserved impact slots) and
    handed to the MPC, with its warm start jitted (`jax_init_solution`):
    `init` then skips the eager dispatch of every op of the warm start
    (about 30 s a process on the CPU; the same values). The solver's own
    jitted update is the one the MPC would make."""
    from robotoc_tpu.solver.ocp_solver import OCPSolver
    solver = OCPSolver(mpc.model, mpc.contacts, costs, mpc.limits, mpc.T,
                       mpc.N, options=mpc._options,
                       n_reserved_events=mpc.n_reserved)
    solver.init_solution = jax.jit(solver.init_solution)
    mpc._solver = solver
    return solver


def jax_problem(N=4, dtype=jnp.float64):
    """The golden ANYmal standing OCP, JAX side."""
    from robotoc_tpu.constraints.joint_limits import make_joint_limits
    from robotoc_tpu.costs.config_cost import make_config_cost
    from robotoc_tpu.models import (forward_kinematics, frame_placement,
                                    load_robot)
    from robotoc_tpu.models.contacts import make_contacts
    from robotoc_tpu.planner.contact_sequence import (ContactSchedule,
                                                      discretize)
    m = load_robot("anymal", dtype=dtype)
    contacts = make_contacts(m, FEET, baumgarte_time_step=0.04)
    q0 = jnp.asarray(Q_STAND, dtype)
    qw = jnp.asarray([0, 0, 0, 250000, 250000, 250000] + [0.0001] * 12,
                     dtype)
    vw = jnp.asarray([100.0] * 6 + [1.0] * 12, dtype)
    cost = make_config_cost(m, q_ref=q0, q_weight=qw, v_weight=vw,
                            a_weight=1e-6, u_weight=1e-1,
                            q_weight_terminal=qw, v_weight_terminal=vw)
    lim = make_joint_limits(m, u_limit=jnp.full(12, 80.0, dtype),
                            v_limit=jnp.full(12, 15.0, dtype))
    Rw, pw = forward_kinematics(m, q0)
    plc = np.stack([np.asarray(frame_placement(m, m.frame_id(f), Rw, pw)[1])
                    for f in FEET])
    grid = discretize(ContactSchedule(nc=4).init([True] * 4, plc), 0.0, 0.5,
                      N, dtype=dtype, use_native=False)
    return dict(model=m, contacts=contacts, cost=cost, limits=lim,
                grid=grid, q0=q0, v0=jnp.zeros(18, dtype))


def to_torch(jp, dtype=torch.float64):
    """The JAX problem's objects converted to the port's, on the CPU."""
    kw = dict(dtype=dtype, device="cpu")
    return dict(
        model=convert.robot_model(fields(jp["model"]), **kw),
        contacts=convert.contact_model(fields(jp["contacts"]), **kw),
        cost=convert.config_cost(fields(jp["cost"]), **kw),
        limits=convert.joint_limits(fields(jp["limits"]), **kw),
        grid=convert.grid_data(fields(jp["grid"]), **kw),
        q0=torch.as_tensor(np.array(jp["q0"]), dtype=dtype),
        v0=torch.as_tensor(np.array(jp["v0"]), dtype=dtype))


def perturbed_solution(jsol, seed, scale=0.05):
    """Numpy fields of a JAX Solution moved off its warm start, so that
    every stage block is non-trivial. q moves in the tangent space
    through the JAX package's integrate; the PDIPM pairs stay positive."""
    from robotoc_tpu.models import load_robot
    from robotoc_tpu.models import robot as rm
    rng = np.random.default_rng(seed)
    f = fields(jsol)
    m = load_robot("anymal")
    S = f["q"].shape[0]
    f["q"] = np.asarray(rm.integrate(m, jnp.asarray(f["q"]),
                                     scale * rng.standard_normal((S, 18))))
    for name in ("v", "a", "u", "lmd", "gmm", "beta", "mu"):
        f[name] = f[name] + scale * rng.standard_normal(f[name].shape)
    f["f"] = f["f"] + 5.0 * rng.standard_normal(f["f"].shape)
    for name in ("s_lim", "z_lim", "s_cone", "z_cone"):
        f[name] = f[name] * np.exp(0.3 * rng.standard_normal(f[name].shape))
    return f


def assert_close(actual, desired, tol, name=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               rtol=tol, atol=tol, err_msg=name)


def deep_fields(obj):
    """fields() with dataclass-valued fields (references, nested costs)
    turned into field dicts too."""
    out = fields(obj)
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = deep_fields(v)
    return out


def jax_trot(N=10, dtype=jnp.float64, t0=0.35):
    """The mid-gait ANYmal trot (the JAX package's flagship problem at
    horizon N), JAX side: model, MPCTrot, grid and cost stack."""
    from robotoc_tpu.models import load_robot
    from robotoc_tpu.mpc.mpc_trot import MPCTrot
    m = load_robot("anymal", dtype=dtype)
    mpc = MPCTrot(m, T=0.5, N=N)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.15, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.25,
                         stance_time=0.0, swing_start_time=0.5)
    q0 = jnp.asarray(Q_STAND, dtype)
    v0 = jnp.zeros(18, dtype)
    mpc.planner.init(q0)
    mpc.config_cost = mpc.config_cost.replace(q_ref=q0)
    grid, costs = mpc._build_schedule_and_costs(t0, q0, v0)
    return dict(model=m, mpc=mpc, contacts=mpc.contacts, limits=mpc.limits,
                grid=grid, costs=costs, q0=q0, v0=v0)


def icub_q0(m):
    """The iCub lower half standing with bent knees, soles on z = 0 (the
    setup of tests/test_biped.py), through the JAX package."""
    from robotoc_tpu.models import forward_kinematics, frame_placement
    knee = np.pi / 6
    q0 = np.array([0, 0, 0, 0, 0, 0, 1,
                   0.5 * knee, 0, 0, -knee, 0.5 * knee, 0,
                   0.5 * knee, 0, 0, -knee, 0.5 * knee, 0])
    Rw, pw = forward_kinematics(m, jnp.asarray(q0))
    zs = [np.asarray(frame_placement(m, m.frame_id(f), Rw, pw)[1])[2]
          for f in ["l_sole", "r_sole"]]
    q0[2] = -0.5 * (zs[0] + zs[1])
    return q0


def jax_walk(N=6, dtype=jnp.float64, t0=0.62):
    """The iCub lower-half biped walk (tools/bench_icub_walk.py's problem at
    horizon N, planned at t0 from standing), JAX side: model, MPCBipedWalk,
    grid and cost stack, in the dict layout of jax_trot."""
    from robotoc_tpu.models import load_robot
    from robotoc_tpu.mpc.gait_mpc import MPCBipedWalk
    m = load_robot("icub_lower_half", dtype=dtype)
    mpc = MPCBipedWalk(m, T=0.7, N=N)
    mpc.set_wrench_cone_rectangular(X=0.05, Y=0.025)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.22, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.7,
                         stance_time=0.0, swing_start_time=0.5)
    q0 = jnp.asarray(icub_q0(m), dtype)
    v0 = jnp.zeros(18, dtype)
    mpc.planner.init(q0)
    mpc.config_cost = mpc.config_cost.replace(q_ref=q0)
    grid, costs = mpc._build_schedule_and_costs(t0, q0, v0)
    return dict(model=m, mpc=mpc, contacts=mpc.contacts, limits=mpc.limits,
                grid=grid, costs=costs, q0=q0, v0=v0)


A1_FEET = ["FL_foot", "RL_foot", "FR_foot", "RR_foot"]
A1_Q0 = [0, 0, 0.3181, 0, 0, 0, 1] + [0.0, 0.67, -1.3] * 4


def a1_terrain(x, y):
    """The height map of examples/a1_crawl_terrain_mpc.py, as floats."""
    return 0.03 * np.sin(4.0 * x) * np.cos(3.0 * y) + 0.04 * x


# the gait settings of robotoc_tpu_torch.problems (a1_crawl, anymal_gait):
# robot, MPC class, feet, step length, swing time, swing height, stance
# time, flying time
GAITS = {"crawl": ("a1", "MPCCrawl", A1_FEET, 0.12, 0.25, 0.1, 0.05, 0.0),
         "pace": ("anymal", "MPCPace", None, 0.05, 0.25, 0.08, 0.0, 0.0),
         "flying_trot": ("anymal", "MPCFlyingTrot", None, 0.15, 0.20, 0.10,
                         0.0, 0.06)}


def jax_gait(name, N=10, t0=0.35, dtype=jnp.float64, T=0.5,
             swing_start=0.5):
    """A gait MPC problem of GAITS (the A1 crawl on the terrain, the ANYmal
    pace or flying trot) planned at t0 from standing, JAX side, in the
    dict layout of jax_trot."""
    from robotoc_tpu.models import load_robot
    from robotoc_tpu.mpc import gait_mpc
    robot, cls, feet, step, swing, height, stance, flying = GAITS[name]
    m = load_robot(robot, dtype=dtype)
    kw = dict(feet=feet, baumgarte_time_step=0.05) if feet else {}
    mpc = getattr(gait_mpc, cls)(m, T=T, N=N, **kw)
    planner = mpc.make_planner(
        terrain=(lambda x, y: float(a1_terrain(x, y))) if feet else None)
    planner.set_gait_pattern(np.array([step, 0, 0]), 0.0)
    if flying > 0:
        mpc.set_gait_pattern(planner, swing_height=height, swing_time=swing,
                             flying_time=flying,
                             swing_start_time=swing_start)
    else:
        mpc.set_gait_pattern(planner, swing_height=height, swing_time=swing,
                             stance_time=stance,
                             swing_start_time=swing_start)
    q0 = jnp.asarray(A1_Q0 if feet else Q_STAND, dtype)
    v0 = jnp.zeros(m.nv, dtype)
    mpc.planner.init(q0)
    mpc.config_cost = mpc.config_cost.replace(q_ref=q0)
    grid, costs = mpc._build_schedule_and_costs(t0, q0, v0)
    return dict(model=m, mpc=mpc, contacts=mpc.contacts, limits=mpc.limits,
                grid=grid, costs=costs, q0=q0, v0=v0)


def costs_to_torch(costs, **kw):
    """A JAX cost stack converted to the port's, component by component."""
    from robotoc_tpu.costs.config_cost import ConfigurationSpaceCost
    from robotoc_tpu.costs.task_cost import BaseRotationCost
    out = []
    for c in costs:
        if isinstance(c, ConfigurationSpaceCost):
            out.append(convert.config_cost(deep_fields(c), **kw))
        elif isinstance(c, BaseRotationCost):
            out.append(convert.base_rotation_cost(deep_fields(c), **kw))
        else:
            out.append(convert.multi_frame_task_cost(deep_fields(c), **kw))
    return tuple(out)


def trot_to_torch(jt, dtype=torch.float64):
    """The JAX problem's objects (a gait problem of jax_trot, jax_walk or
    jax_gait) converted to the port's (CPU)."""
    kw = dict(dtype=dtype, device="cpu")
    return dict(
        model=convert.robot_model(fields(jt["model"]), **kw),
        contacts=convert.contact_model(fields(jt["contacts"]), **kw),
        limits=convert.joint_limits(fields(jt["limits"]), **kw),
        grid=convert.grid_data(fields(jt["grid"]), **kw),
        costs=costs_to_torch(jt["costs"], **kw),
        q0=torch.as_tensor(np.array(jt["q0"]), dtype=dtype),
        v0=torch.as_tensor(np.array(jt["v0"]), dtype=dtype),
        n_imp=jt["mpc"].n_reserved)


def trot_iterate(tp, seed, scale=0.05):
    """Numpy fields of the port's warm start on the converted trot problem,
    moved by seeded noise (q in the tangent space, the PDIPM pairs kept
    positive, the switching multipliers nonzero)."""
    from robotoc_tpu_torch.models import robot as trm
    from robotoc_tpu_torch.solver import ocp_solver as TOS
    sol = TOS.make_initial_solution(tp["model"], tp["contacts"],
                                    tp["limits"], 1e-3, tp["grid"],
                                    tp["q0"], tp["v0"])
    f = {k: np.array(v.numpy()) for k, v in vars(sol).items()}
    rng = np.random.default_rng(seed)
    S = f["q"].shape[0]
    f["q"] = trm.integrate(tp["model"], torch.as_tensor(f["q"]),
                           torch.as_tensor(scale * rng.standard_normal(
                               (S, 18)))).numpy()
    for name in ("v", "a", "u", "lmd", "gmm", "beta", "mu", "xi"):
        f[name] = f[name] + scale * rng.standard_normal(f[name].shape)
    f["f"] = f["f"] + 5.0 * rng.standard_normal(f["f"].shape)
    for name in ("s_lim", "z_lim", "s_cone", "z_cone"):
        f[name] = f[name] * np.exp(0.3 * rng.standard_normal(f[name].shape))
    return f


def anymal_states(model, n, seed):
    """n random ANYmal states, numpy: q (moved around standing in the
    tangent space by the port's integrate), v, a, contact forces."""
    from robotoc_tpu_torch.models import robot as trm
    rng = np.random.default_rng(seed)
    dq = 0.3 * rng.standard_normal((n, 18))
    q = trm.integrate(model, torch.as_tensor(Q_STAND, dtype=torch.float64)
                      .expand(n, 19), torch.as_tensor(dq)).numpy()
    return (q, rng.standard_normal((n, 18)), rng.standard_normal((n, 18)),
            30.0 * rng.standard_normal((n, 12)))


def rodrigues(w):
    """Rotation matrices exp(hat(w)) of rotation vectors w (..., 3),
    numpy."""
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 2] = -w[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


def close_tree(got, want, tol, name=""):
    """Nested sequences of arrays equal to `tol` relative to each array's
    largest magnitude (at least one)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, (tuple, list)):
            close_tree(g, w, tol, f"{name}[{i}]")
            continue
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max(initial=0.0)))
        assert_close(np.asarray(g) / scale, w / scale, tol, f"{name}[{i}]")


def icub_soles_jax(S=5, seed=2):
    """The JAX package's own data for its surface chain kernel test
    (tests/test_pallas_chain.py, test_chain_surface_matches_jacfwd): the
    full iCub on both soles (rect 0.1 x 0.05), S states from
    PRNGKey(seed), configurations moved from neutral by 0.3 N(0, 1),
    reference rotations R_ref = so3_exp(0.2 N(0, 1)) near the identity,
    while the soles sit near pi from it: the SE(3) log's rotation works
    near its branch cut. Returns (JAX model, JAX contacts, the seven
    inputs of the chain kernel as numpy)."""
    from robotoc_tpu.models import contacts as ct
    from robotoc_tpu.models import load_robot
    from robotoc_tpu.models import robot as rm
    from robotoc_tpu.ops import lie
    m = load_robot("icub")
    contacts = ct.make_contacts(m, ("l_sole", "r_sole"),
                                types=(ct.SURFACE, ct.SURFACE),
                                rect=(0.1, 0.05))
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    nc = contacts.n_contacts
    dq = 0.3 * jax.random.normal(ks[0], (S, m.nv), m.dtype)
    q = jax.vmap(lambda d: rm.integrate(m, rm.neutral(m), d))(dq)
    ins = (q, jax.random.normal(ks[1], (S, m.nv), m.dtype),
           jax.random.normal(ks[2], (S, m.nv), m.dtype),
           30.0 * jax.random.normal(ks[3], (S, contacts.max_dimf), m.dtype),
           0.5 + 0.3 * jax.random.uniform(ks[4], (S, nc), dtype=m.dtype),
           0.3 * jax.random.normal(ks[5], (S, nc, 3), m.dtype),
           lie.so3_exp(0.2 * jax.random.normal(ks[5], (S, nc, 3), m.dtype)))
    return m, contacts, [np.asarray(x) for x in ins]


def host_chain(host, model, contacts, ins, shapes):
    """K6's host build (csrc/host_shim.cpp, rtt_host_chain) on the port's
    model and the given float64 inputs, with the cost fold when `shapes`
    names its outputs; outputs filled with NaN first. `shapes` maps each
    output name to its shape."""
    import ctypes
    from robotoc_tpu_torch.ops import chain as chn
    names = [n for n in chn._OUTS + chn._COST_OUTS if n in shapes]
    ins = [torch.as_tensor(x).contiguous() for x in ins]
    got = {n: torch.full(tuple(shapes[n]), float("nan"), dtype=torch.float64)
           for n in names}
    consts, topo = chn.model_tables(model, contacts, torch.float64, "cpu")
    P = ctypes.c_void_p
    rc = host.rtt_host_chain(
        model.nv, int(len(names) > len(chn._OUTS)), contacts.n_contacts,
        contacts.types[0], P(consts.data_ptr()), P(topo.data_ptr()),
        (P * len(ins))(*[t.data_ptr() for t in ins]),
        (P * len(names))(*[got[n].data_ptr() for n in names]),
        ins[0].shape[0])
    assert rc == 0
    return got


IIWA_Q_REF = [0, np.pi / 2, 0, np.pi / 2, 0, np.pi / 2, 0]
IIWA_Q0 = [np.pi / 2, 0, np.pi / 2, 0, np.pi / 2, 0, np.pi / 2]


def jax_iiwa():
    """The iiwa14 configuration-space OCP of tests/test_golden_traces.py
    (q weight 10, v and a weights 0.01, terminal weights 10 and 0.01,
    torques within 50, velocities within pi/2), JAX side: model, cost,
    limits, q0, v0."""
    from robotoc_tpu.constraints.joint_limits import make_joint_limits
    from robotoc_tpu.costs.config_cost import make_config_cost
    from robotoc_tpu.models import load_robot
    m = load_robot("iiwa14")
    cost = make_config_cost(m, q_ref=jnp.asarray(IIWA_Q_REF), q_weight=10,
                            v_weight=0.01, a_weight=0.01, u_weight=0.0,
                            q_weight_terminal=10, v_weight_terminal=0.01)
    lim = make_joint_limits(m, u_limit=jnp.full(7, 50.0),
                            v_limit=jnp.full(7, np.pi / 2))
    return dict(model=m, cost=cost, limits=lim, q0=jnp.asarray(IIWA_Q0),
                v0=jnp.zeros(7))


def perturbed_arm_iterate(sol, seed, scale=0.3):
    """Numpy fields of a port iterate (UnconstrSolution or
    ParNMPCSolution) moved by seeded noise: the primal and the
    multipliers by scale * N(0, 1), the PDIPM pairs by exp(0.3 N(0, 1))
    factors (kept positive); the auxiliary matrices of ParNMPC stay."""
    rng = np.random.default_rng(seed)
    f = {k: np.array(v.numpy()) for k, v in vars(sol).items()}
    for name in ("q", "v", "a", "u", "lmd", "gmm", "beta"):
        f[name] = f[name] + scale * rng.standard_normal(f[name].shape)
    for name in ("slack", "dual"):
        f[name] = f[name] * np.exp(0.3 * rng.standard_normal(f[name].shape))
    return f

def jax_bounce(cycles=1):
    """The objects of examples/anymal_bounce.py's `main`, JAX side, built
    by the example's own lines (without the solve): model, contacts, the
    two costs, limits, contact schedule, grid, q0, v0, T, N and the
    reserved impact slots."""
    from robotoc_tpu.constraints.joint_limits import make_joint_limits
    from robotoc_tpu.costs.config_cost import make_config_cost
    from robotoc_tpu.costs.task_cost import (MultiFrameTaskCost,
                                             PeriodicCoMRef,
                                             PeriodicSwingFootRef)
    from robotoc_tpu.models import (com, forward_kinematics,
                                    frame_placement, load_robot)
    from robotoc_tpu.models.contacts import make_contacts
    from robotoc_tpu.planner.contact_sequence import (ContactSchedule,
                                                      discretize)
    LF, LH, RF, RH = range(4)
    m = load_robot("anymal")
    dtype = m.dtype
    contacts = make_contacts(m, FEET, baumgarte_time_step=0.05)
    nv = m.nv
    step_length = np.array([0.275, 0.0, 0.0])
    step_height = 0.125
    swing_time = 0.26
    double_support_time = 0.04
    t0 = 0.1
    q0 = jnp.asarray(Q_STAND, dtype)
    qw = jnp.asarray([0, 0, 0, 250000, 250000, 250000]
                     + [0.0001] * (nv - 6), dtype)
    vw = jnp.asarray([100.0] * 6 + [1.0] * (nv - 6), dtype)
    qwi = jnp.asarray([1.0] * 6 + [100.0] * (nv - 6), dtype)
    config_cost = make_config_cost(
        m, q_ref=q0, q_weight=qw, v_weight=vw, a_weight=1e-6,
        u_weight=1e-1, q_weight_terminal=qw, v_weight_terminal=vw,
        q_weight_impact=qwi, v_weight_impact=jnp.full(nv, 100.0, dtype),
        dv_weight_impact=jnp.full(nv, 1e-6, dtype))
    lim = make_joint_limits(m, u_limit=jnp.full(12, 80.0, dtype),
                            v_limit=jnp.full(12, 15.0, dtype))
    Rw, pw = forward_kinematics(m, q0)
    plc = np.stack([np.asarray(frame_placement(m, m.frame_id(f), Rw, pw)[1])
                    for f in FEET])
    com0 = np.asarray(com(m, q0))
    period_full = 2.0 * swing_time + 2.0 * double_support_time
    sl = jnp.asarray(step_length, dtype)
    sh = jnp.asarray(step_height, dtype)

    def swing_ref(i, t_start):
        return PeriodicSwingFootRef(
            p0=jnp.asarray(plc[i], dtype), step_length=sl, step_height=sh,
            t0=jnp.asarray(t_start, dtype),
            period_swing=jnp.asarray(swing_time, dtype),
            period=jnp.asarray(period_full, dtype))

    front_t0 = t0 + swing_time + double_support_time
    refs = [swing_ref(LF, front_t0), swing_ref(LH, t0),
            swing_ref(RF, front_t0), swing_ref(RH, t0)]
    foot_refs = jax.tree.map(lambda *x: jnp.stack(x), *refs)
    com_ref = PeriodicCoMRef(
        com0=jnp.asarray(com0, dtype),
        vcom=jnp.asarray(0.5 * step_length / swing_time, dtype),
        t0=jnp.asarray(t0, dtype),
        period_active=jnp.asarray(swing_time, dtype),
        period_inactive=jnp.asarray(double_support_time, dtype))
    task_cost = MultiFrameTaskCost(
        frame_ids=tuple(m.frame_id(f) for f in FEET),
        foot_weight=jnp.full(3, 1e6, dtype),
        foot_weight_terminal=jnp.zeros(3, dtype),
        foot_weight_impact=jnp.zeros(3, dtype),
        com_weight=jnp.full(3, 1e6, dtype),
        com_weight_terminal=jnp.zeros(3, dtype),
        com_weight_impact=jnp.zeros(3, dtype),
        foot_refs=foot_refs, com_ref=com_ref)
    sched = ContactSchedule(nc=4, default_friction=0.7)
    sched.init([True] * 4, plc.copy(), t0=0.0)
    pos = plc.copy()
    t = t0
    for _ in range(cycles):
        sched.push_back([True, False, True, False], pos.copy(), t)
        pos[LH] += step_length
        pos[RH] += step_length
        sched.push_back([True] * 4, pos.copy(), t + swing_time)
        sched.push_back([False, True, False, True], pos.copy(),
                        t + swing_time + double_support_time)
        pos[LF] += step_length
        pos[RF] += step_length
        sched.push_back([True] * 4, pos.copy(),
                        t + 2 * swing_time + double_support_time)
        t += 2 * swing_time + 2 * double_support_time
    T = t0 + cycles * (2 * double_support_time + 2 * swing_time)
    N = int(np.floor(T / 0.02))
    n_impacts = 2 * cycles
    grid = discretize(sched, 0.0, T, N, n_reserved=n_impacts, dtype=dtype)
    return dict(model=m, contacts=contacts, costs=(config_cost, task_cost),
                limits=lim, schedule=sched, grid=grid, q0=q0,
                v0=jnp.zeros(nv, dtype), T=T, N=N, n_imp=n_impacts)

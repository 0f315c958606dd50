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


def jax_init_solution(solver, grid, q, v):
    """A JAX OCPSolver's warm start, jitted: one compile in place of the
    eager dispatch of every op (the same values, a tenth of the time)."""
    return jax.jit(solver.init_solution)(grid, q, v)


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


def trot_to_torch(jt, dtype=torch.float64):
    """The JAX trot problem's objects converted to the port's (CPU)."""
    kw = dict(dtype=dtype, device="cpu")
    cfg, br, task = jt["costs"]
    return dict(
        model=convert.robot_model(fields(jt["model"]), **kw),
        contacts=convert.contact_model(fields(jt["contacts"]), **kw),
        limits=convert.joint_limits(fields(jt["limits"]), **kw),
        grid=convert.grid_data(fields(jt["grid"]), **kw),
        costs=(convert.config_cost(fields(cfg), **kw),
               convert.base_rotation_cost(deep_fields(br), **kw),
               convert.multi_frame_task_cost(deep_fields(task), **kw)),
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

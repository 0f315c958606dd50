"""The port's task-space costs, their references and DiscountedCost
against the JAX package, f64, on the CPU; and the iiwa14 task-space OCP
(the path that runs them) through UnconstrOCPSolver.solve.

  * Every cost (TaskSpace3DCost on a constant and on a periodic swing-foot
    reference, CoMCost on a periodic CoM reference, TaskSpace6DCost on an
    SE(3) reference, LocalContactForceCost, and DiscountedCost around a
    configuration cost): eval_* and quadratize_* at stage, terminal and impact, on
    seeded ANYmal states at seeded times, each output to 1e-10 of its
    largest magnitude. The JAX side is one jitted vmap of every case.
  * The periodic references on a batch of times, and the discrete-time
    references on tests/test_discrete_time_refs.py's schedule and on one
    with a flight, at every time of a fine grid: 1e-12.
  * The iiwa14 task-space OCP (examples/iiwa14_task_space_ocp.py) through
    the port's solve against the JAX package's Newton updates on the same
    problem: the KKT of every iterate to 1e-8 of max(1, |KKT|), the iteration
    count (12, JAX's), the final q to 1e-8 of max(1, max-abs) and the
    end effector's distance to its target.
"""
import functools

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp

from _torch_cases import (anymal_states, deep_fields, fields,
                          jit_unoptimised, rodrigues)

from robotoc_tpu.constraints.joint_limits import make_joint_limits as jlim
from robotoc_tpu.costs import base as jbase
from robotoc_tpu.costs import config_cost as jcc
from robotoc_tpu.costs import task_cost as jtc
from robotoc_tpu.costs.config_cost import make_config_cost as jcfg
from robotoc_tpu.models import load_robot as jload
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.planner.contact_sequence import ContactSchedule as JSched
from robotoc_tpu.solver import unconstr_ocp_solver as JUS
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.costs import task_cost as ttc
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.planner.contact_sequence import (
    ContactSchedule as TSched)

N_STATES, DT, NF = 6, 0.02, 12


def _jax_cases(m):
    """name -> the JAX cost of each case."""
    fid = m.frame_id("LF_FOOT")

    def w(n, x):
        return jnp.full(n, x)

    swing = jtc.PeriodicSwingFootRef(
        p0=jnp.asarray([0.3, 0.2, 0.0]), step_length=jnp.asarray(
            [0.15, 0.02, 0.0]), step_height=jnp.asarray(0.1),
        t0=jnp.asarray(0.1), period_swing=jnp.asarray(0.25),
        period=jnp.asarray(0.5), first_half=True)
    com = jtc.PeriodicCoMRef(
        com0=jnp.asarray([0.0, 0.0, 0.45]), vcom=jnp.asarray(
            [0.3, 0.05, 0.0]), t0=jnp.asarray(0.1),
        period_active=jnp.asarray(0.25), period_inactive=jnp.asarray(0.1))
    R = rodrigues(np.array([0.2, -0.3, 0.4]))
    task6 = jtc.TaskSpace6DCost(
        frame_id=fid, weight=jnp.asarray([2.0, 1.5, 1.0, 0.5, 0.7, 0.9]),
        weight_terminal=w(6, 1.0), weight_impact=w(6, 1.5),
        ref=jtc.SE3Ref(R=jnp.asarray(R), p=jnp.asarray([0.3, 0.1, 0.0])))
    com_cost = jtc.CoMCost(weight=jnp.asarray([2.0, 3.0, 4.0]),
                           weight_terminal=w(3, 1.0), weight_impact=w(3, 1.5),
                           ref=com)
    return {
        "task3d constant": jtc.TaskSpace3DCost(
            frame_id=fid, weight=jnp.asarray([2.0, 1.0, 3.0]),
            weight_terminal=w(3, 1.0), weight_impact=w(3, 1.5),
            ref=jtc.ConstantRef(p=jnp.asarray([0.3, 0.1, 0.0]))),
        "task3d periodic swing": jtc.TaskSpace3DCost(
            frame_id=m.frame_id("RH_FOOT"), weight=w(3, 5.0),
            weight_terminal=w(3, 2.0), weight_impact=w(3, 0.5), ref=swing),
        "com periodic": com_cost,
        "task6d": task6,
        "contact force": jtc.LocalContactForceCost(
            f_weight=jnp.linspace(0.2, 1.4, NF),
            f_ref=jnp.zeros(NF).at[2::3].set(80.0)),
        "discounted": jbase.DiscountedCost(jcfg(
            m, q_ref=jrm.neutral(m), q_weight=2.0, v_weight=1.0,
            a_weight=0.5, u_weight=0.1, q_weight_terminal=3.0,
            v_weight_terminal=1.0, q_weight_impact=1.0, v_weight_impact=1.0,
            dv_weight_impact=0.5), 0.9, 0.05, 0.1),
    }


def _port_cost(c):
    """The port's counterpart of a JAX cost, through convert."""
    kw = dict(device="cpu")
    if isinstance(c, jbase.DiscountedCost):
        return convert.discounted_cost(
            dict(base=_port_cost(c.base), gamma=c.gamma, dt_d=c.dt_d,
                 t0=c.t0), **kw)
    fn = {jcc.ConfigurationSpaceCost: convert.config_cost,
          jtc.TaskSpace3DCost: convert.task_space_3d_cost,
          jtc.CoMCost: convert.com_cost,
          jtc.TaskSpace6DCost: convert.task_space_6d_cost,
          jtc.LocalContactForceCost: convert.local_contact_force_cost}
    return fn[type(c)](deep_fields(c), **kw)


def _outputs(cost, model, q, v, a, u, f, t):
    """The six functions of one cost at one sample: eval stage, terminal,
    impact, then the quadratizations (dv = a at the impact)."""
    return (cost.eval_stage(model, q, v, a, u, f, t, DT),
            cost.eval_terminal(model, q, v, t),
            cost.eval_impact(model, q, v, a, t),
            tuple(cost.quadratize_stage(model, NF, q, v, a, u, f, t, DT)),
            tuple(cost.quadratize_terminal(model, q, v, t)),
            tuple(cost.quadratize_impact(model, q, v, a, t)))


@pytest.fixture(scope="module")
def costs_case():
    jm = jload("anymal")
    tm = convert.robot_model(fields(jm), device="cpu")
    q, v, a, f = anymal_states(tm, N_STATES, seed=11)
    rng = np.random.default_rng(12)
    u = rng.standard_normal((N_STATES, 12))
    # times across the references' active and inactive spans
    t = np.linspace(0.0, 1.3, N_STATES) + 0.01
    jcases = _jax_cases(jm)

    # one trace of one sample, run on each (a vmap's trace is half as long
    # again)
    run = jit_unoptimised(lambda *x: {k: _outputs(c, jm, *x)
                                      for k, c in jcases.items()})
    ins = [q, v, a, u, f, t]
    ref = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                       *[run(*[jnp.asarray(x[i]) for x in ins])
                         for i in range(N_STATES)])
    return tm, jcases, [torch.as_tensor(x) for x in ins], ref


def _flat(tree):
    out = []
    for x in tree:
        if isinstance(x, (tuple, list)):
            out.extend(_flat(x))
        else:
            out.append(x)
    return out


@pytest.mark.parametrize("name", list(_jax_cases(jload("anymal"))))
def test_cost_matches_jax(costs_case, name):
    tm, jcases, ins, ref = costs_case
    cost = _port_cost(jcases[name])
    got = vmap(lambda *x: _outputs(cost, tm, *x))(*ins)
    got, want = _flat(got), _flat(ref[name])
    assert len(got) == len(want) == 3 + 11 + 5 + 7
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-300)
        err = float(np.abs(g - w).max())
        assert err <= 1e-10 * scale, f"{name} output {i}: {err} > 1e-10 * " \
            f"{scale}"
    # the cases reach nonzero costs and gradients
    assert float(np.abs(want[3]).max()) > 0.0


# ---- references -----------------------------------------------------------

TIMES = np.linspace(-0.2, 1.6, 181)


def _same_ref(jref, tref, times=TIMES, tol=1e-12):
    jp, ja = jax.vmap(jref)(jnp.asarray(times))
    tp, ta = tref(torch.as_tensor(times))
    if isinstance(jp, tuple):
        for x, y in zip(tp, jp):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=tol)
    else:
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    return np.asarray(ja)


@pytest.mark.parametrize("first_half", [False, True])
def test_periodic_swing_foot_ref_matches_jax(first_half):
    j = jtc.PeriodicSwingFootRef(
        p0=jnp.asarray([0.3, -0.2, 0.01]), step_length=jnp.asarray(
            [0.15, 0.03, 0.0]), step_height=jnp.asarray(0.08),
        t0=jnp.asarray(0.2), period_swing=jnp.asarray(0.25),
        period=jnp.asarray(0.6), first_half=first_half)
    act = _same_ref(j, convert.periodic_swing_foot_ref(fields(j),
                                                       device="cpu"))
    assert 0 < act.sum() < len(act)


def test_periodic_com_ref_and_constant_refs_match_jax():
    j = jtc.PeriodicCoMRef(
        com0=jnp.asarray([0.0, 0.1, 0.45]), vcom=jnp.asarray(
            [0.3, 0.0, 0.01]), t0=jnp.asarray(0.15),
        period_active=jnp.asarray(0.2), period_inactive=jnp.asarray(0.15))
    _same_ref(j, convert.periodic_com_ref(fields(j), device="cpu"))
    c = jtc.ConstantRef(p=jnp.asarray([0.1, 0.2, 0.3]))
    _same_ref(c, convert.reference(fields(c), device="cpu"))
    s = jtc.SE3Ref(R=jnp.asarray(rodrigues(np.array([0.1, 0.2, -0.3]))),
                   p=jnp.asarray([0.1, 0.2, 0.3]))
    _same_ref(s, convert.reference(fields(s), device="cpu"))


def _schedules(cls):
    """tests/test_discrete_time_refs.py's schedule (stand, contact 0
    swings, stand), and a four-contact one with a flight between two
    swings (its midpoint smoothing)."""
    plc0 = np.array([[0.3, 0.2, 0.0], [-0.3, 0.2, 0.0]])
    plc1 = plc0.copy()
    plc1[0, 0] += 0.2
    a = cls(nc=2).init([True, True], plc0, t0=0.0)
    a.push_back([False, True], plc0, 0.1)
    a.push_back([True, True], plc1, 0.4)
    p4 = np.array([[0.3, 0.2, 0.0], [-0.3, 0.2, 0.0], [0.3, -0.2, 0.0],
                   [-0.3, -0.2, 0.0]])
    b = cls(nc=4).init([True] * 4, p4, t0=0.0)
    b.push_back([True, False, False, True], p4, 0.2)
    b.push_back([False] * 4, p4 + [0.1, 0, 0], 0.45)
    b.push_back([False, True, True, False], p4 + [0.15, 0, 0], 0.6)
    b.push_back([True] * 4, p4 + [0.3, 0, 0.02], 0.85)
    return {"stand swing stand": (a, 0.6), "flight": (b, 1.1)}


@pytest.mark.parametrize("case", ["stand swing stand", "flight"])
def test_discrete_time_refs_match_jax(case):
    (js, t_end), (ts, _) = _schedules(JSched)[case], _schedules(TSched)[case]
    times = np.linspace(-0.1, t_end + 0.2, 241)
    jrefs = jtc.make_discrete_time_swing_refs(js, t_end, 0.15, jnp.float64)
    trefs = ttc.make_discrete_time_swing_refs(ts, t_end, 0.15,
                                              device="cpu")
    assert len(trefs) == js.nc
    for jr, tr in zip(jrefs, trefs):
        _same_ref(jr, tr, times)
        # through convert from the JAX object's fields too
        _same_ref(jr, convert.reference(fields(jr), device="cpu"), times)
    c2c = np.tile([[0.0, 0.0, -0.45]], (js.nc, 1)) + 0.01 * np.arange(
        3 * js.nc).reshape(js.nc, 3)
    jc = jtc.make_discrete_time_com_ref(js, t_end, c2c, jnp.float64)
    tc_ = ttc.make_discrete_time_com_ref(ts, t_end, c2c, device="cpu")
    _same_ref(jc, tc_, times)
    _same_ref(jc, convert.discrete_time_com_ref(fields(jc), device="cpu"),
              times)


# ---- path A: the iiwa14 task-space OCP ------------------------------------

JAX_ITERATIONS = 12     # JAX's UnconstrOCPSolver.solve on this problem


@pytest.fixture(scope="module")
def task_space():
    """The JAX problem of examples/iiwa14_task_space_ocp.py, its KKT at
    each of JAX_ITERATIONS + 1 Newton updates from the warm start (the
    solve loop's iterates: one build per iteration, no line search) and
    its final iterate; the port's problem."""
    m = jload("iiwa14")
    fid = m.frame_id(m.frame_names[-1])
    q0 = jnp.full(7, 0.5)
    target = jrm.frame_position(m, fid, q0) + jnp.asarray([0.1, 0.1, -0.1])
    cfg = jcfg(m, q_ref=q0, q_weight=0.1, v_weight=0.01, a_weight=0.01,
               q_weight_terminal=0.1, v_weight_terminal=0.01)
    w3 = jnp.full(3, 1000.0)
    task = jtc.TaskSpace3DCost(frame_id=fid, weight=w3,
                               weight_terminal=10.0 * w3, weight_impact=w3,
                               ref=jtc.ConstantRef(p=target))
    lim = jlim(m, u_limit=jnp.full(7, 100.0), v_limit=jnp.full(7, np.pi))
    solver = JUS.UnconstrOCPSolver(m, (cfg, task), lim, T=1.5, N=30)
    v0 = jnp.zeros(7)
    upd = jit_unoptimised(functools.partial(
        JUS._update, m, (cfg, task), lim, 1.5 / 30, 1e-3, 0.995, 0.0))
    sol = solver.init_solution(q0, v0)
    hist = []
    for _ in range(JAX_ITERATIONS + 1):
        new, kkt, _, _ = upd(sol, q0, v0)
        hist.append(float(kkt))
        if len(hist) <= JAX_ITERATIONS:
            sol = new
    err = float(jnp.linalg.norm(jrm.frame_position(m, fid, sol.q[-1])
                                - target))
    return dict(hist=np.array(hist), q=np.asarray(sol.q), err=err,
                target=np.asarray(target),
                port=problems.iiwa14_task_space(device="cpu"))


def test_iiwa14_task_space_problem_matches_example(task_space):
    p = task_space["port"]
    assert p.frame_id == p.model.frame_id(p.model.frame_names[-1])
    np.testing.assert_allclose(p.target.numpy(), task_space["target"],
                               rtol=0, atol=1e-14)
    cfg, task = p.costs
    assert isinstance(task, ttc.TaskSpace3DCost)
    assert float(task.weight_terminal[0]) == 10.0 * float(task.weight[0])


def test_iiwa14_task_space_solve_matches_jax(task_space):
    p, hist = task_space["port"], task_space["hist"]
    # JAX's solve stops at the first iterate at or below kkt_tol
    assert hist[JAX_ITERATIONS] <= 1e-7 < hist[JAX_ITERATIONS - 1]
    sol, st = p.solver.solve(p.q0, p.v0)
    its = int(st["iterations"])
    assert its == JAX_ITERATIONS and bool(st["convergence"])
    got = np.concatenate([[float(p.solver.kkt_error(
        p.solver.init_solution(p.q0, p.v0), p.q0, p.v0))],
        st["kkt_history"][:its].numpy()])
    # to 1e-8 of max(1, |KKT|): the last iterates' KKT (1e-7) is a sum
    # of residuals that rounding moves by 1e-13
    assert np.all(np.abs(got - hist) <= 1e-8 * np.maximum(1.0, hist)), \
        (got, hist)
    q = sol.q.numpy()
    scale = max(1.0, float(np.abs(task_space["q"]).max()))
    assert float(np.abs(q - task_space["q"]).max()) <= 1e-8 * scale
    err = float((trm.frame_position(p.model, p.frame_id, sol.q[-1])
                 - p.target).norm())
    assert abs(err - task_space["err"]) <= 1e-8 * task_space["err"]
    assert err < 1e-4          # the end effector reached its target

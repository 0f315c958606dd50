"""The trot slice's host-side modules against the JAX package, f64, on the
mid-gait ANYmal trot at N = 10: CoM, the step references, the task costs,
the MPC's schedule and reference baking, align_solution, the switching
constraint and the impact quadratization of the cost stack. Inputs are
the JAX problem's objects converted to the port and numpy-seeded states.
On a B = 2 fleet of numpy-seeded iterates (tests/test_torch_trot_slice.py's):
the port's chain path (ops/chain, its plain version on the CPU) against
its per-stage jacfwd path, 1e-10; and the MPC layer (MPCTrot.init,
update_solution) on the port's own problem. The impact functions and the
impact stage are in tests/test_torch_impact.py, one update against the
JAX package in tests/test_torch_trot_slice.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (anymal_states, assert_close, close_tree, jax_trot,
                          jit_unoptimised, np_tree, trot_iterate,
                          trot_to_torch)

from robotoc_tpu.costs import base as jcost_base
from robotoc_tpu.dynamics import switching_constraint as jswc
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.costs import base as tcost_base
from robotoc_tpu_torch.dynamics import switching_constraint as tswc
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.solver import ocp_solver as TOS

TOL = 1e-10
N, B = 10, 2


@pytest.fixture(scope="module")
def case():
    jt = jax_trot(10)
    return jt, trot_to_torch(jt)


def test_com_and_frame_position(case):
    jt, tp = case
    q = torch.as_tensor(anymal_states(tp["model"], 3, 0)[0])
    ref = jit_unoptimised(jax.vmap(lambda x: jrm.com(jt["model"], x)))(
        q.numpy())
    assert_close(trm.com(tp["model"], q).numpy(), ref, TOL, "com")
    fid = tp["model"].frame_id("LF_FOOT")
    ref = jit_unoptimised(jax.vmap(lambda x: jrm.frame_position(
        jt["model"], fid, x)))(q.numpy())
    assert_close(trm.frame_position(tp["model"], fid, q).numpy(), ref, TOL)


def test_step_references(case):
    jt, tp = case
    _, br, task = jt["costs"]
    _, tbr, ttask = tp["costs"]
    ts = np.concatenate([np.asarray(jt["grid"].t),
                         np.linspace(0.0, 1.2, 41)])
    want = np_tree(jit_unoptimised(jax.vmap(
        lambda t: task._ref_active(t, jnp.float64)))(ts))
    got = ttask._ref_active(torch.as_tensor(ts))
    close_tree(got, want, 1e-14, "task refs")
    want = np_tree(jit_unoptimised(jax.vmap(lambda t: br.ref(t)[0]))(ts))
    assert_close(tbr.ref(torch.as_tensor(ts))[0].numpy(), want, 1e-14,
                 "base rotation ref")


@pytest.mark.parametrize("kind", ["stage", "terminal", "impact", "kin"])
def test_task_costs(case, kind):
    """BaseRotationCost and MultiFrameTaskCost at three states and times;
    "kin": the multi-frame cost with the task rows handed in."""
    jt, tp = case
    q, v, dv, _ = anymal_states(tp["model"], 3, 3)
    ts = np.array([0.36, 0.52, 0.7])
    dt = np.full(3, 0.025)
    nf = 12
    jm, tm = jt["model"], tp["model"]
    for jc, tc in zip(jt["costs"][1:], tp["costs"][1:]):
        if kind == "stage":
            def jfn(q, v, t, dt, c=jc):
                return c.quadratize_stage(jm, nf, q, v, v, v[6:], None, t, dt)

            def tfn(q, v, t, dt, c=tc):
                return c.quadratize_stage(tm, nf, q, v, v, v[6:], None, t, dt)
            args = (q, v, ts, dt)
        elif kind == "terminal":
            def jfn(q, v, t, c=jc):
                return c.quadratize_terminal(jm, q, v, t)

            def tfn(q, v, t, c=tc):
                return c.quadratize_terminal(tm, q, v, t)
            args = (q, v, ts)
        elif kind == "impact":
            def jfn(q, v, dv, t, c=jc):
                return c.quadratize_impact(jm, q, v, dv, t)

            def tfn(q, v, dv, t, c=tc):
                return c.quadratize_impact(tm, q, v, dv, t)
            args = (q, v, dv, ts)
        else:
            if not hasattr(jc, "kin_frame_ids"):
                continue

            def jfn(q, v, dv, t, dt, c=jc):
                task = c._task(jm, q)
                Jq = jrm.tangent_jacobian(jm, q, lambda x: c._task(jm, x))
                return (c.quadratize_stage_kin(jm, nf, q, v, v, v[6:], None,
                                               t, dt, task, Jq),
                        c.quadratize_impact_kin(jm, q, v, dv, t, task, Jq),
                        task, Jq)

            def tfn(q, v, dv, t, dt, task, Jq, c=tc):
                return (c.quadratize_stage_kin(tm, nf, q, v, v, v[6:], None,
                                               t, dt, task, Jq),
                        c.quadratize_impact_kin(tm, q, v, dv, t, task, Jq))
            args = (q, v, dv, ts, dt)
        want = np_tree(jit_unoptimised(jax.vmap(jfn))(*args))
        targs = [torch.as_tensor(a) for a in args]
        if kind == "kin":
            targs += [torch.as_tensor(want[2]), torch.as_tensor(want[3])]
            want = want[:2]
        got = torch.func.vmap(tfn)(*targs)
        close_tree(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want], TOL,
                    name=f"{kind} {type(tc).__name__}")


@pytest.mark.parametrize("t0", [0.35, 0.6])
def test_schedule_and_costs(t0):
    """The port's MPCTrot bakes the same grid and reference arrays as the
    JAX package's (mid-swing at 0.35 and 0.6)."""
    jt = jax_trot(10, t0=t0)
    tp = problems.anymal_trot(N=10, device="cpu", t0=t0)
    assert tp.mpc.n_reserved == jt["mpc"].n_reserved
    for name, val in vars(jt["grid"]).items():
        assert_close(getattr(tp.grid, name).numpy(), np.asarray(val), 1e-15,
                     name)
    jcfg, jbr, jtask = jt["costs"]
    cfg, br, task = tp.costs
    for name in ("q_ref", "v_ref", "q_weight", "v_weight", "a_weight",
                 "u_weight", "q_weight_terminal", "v_weight_terminal",
                 "q_weight_impact", "v_weight_impact", "dv_weight_impact"):
        assert_close(getattr(cfg, name).numpy(), np.asarray(
            getattr(jcfg, name)), 0.0, name)
    for jref, ref in ((jbr.ref, br.ref), (jtask.foot_refs, task.foot_refs),
                      (jtask.com_ref, task.com_ref)):
        for name, val in vars(jref).items():
            assert_close(getattr(ref, name).numpy(), np.asarray(val), 1e-15,
                         f"{type(ref).__name__}.{name}")
    assert task.frame_ids == tuple(jtask.frame_ids)
    for name in ("foot_weight", "com_weight", "foot_weight_impact"):
        assert_close(getattr(task, name).numpy(),
                     np.asarray(getattr(jtask, name)), 0.0, name)


def test_align_solution(case):
    """Warm start re-aligned from the t = 0.35 grid onto the t = 0.375
    grid, with manifold interpolation of q."""
    jt, tp = case
    jt2 = jax_trot(10, t0=0.375)
    f = trot_iterate(tp, seed=8)
    want = np_tree(JOS.align_solution(
        JOS.Solution(**{k: jnp.asarray(v) for k, v in f.items()}),
        jt["grid"], jt2["grid"], model=jt["model"]))
    got = TOS.align_solution(convert.solution(f, device="cpu"), tp["grid"],
                             convert.grid_data(vars(jt2["grid"]),
                                               device="cpu"),
                             model=tp["model"])
    for name, val in vars(want).items():
        close_tree([getattr(got, name).numpy()], [val], TOL, name=name)


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def fleet(case):
    """B scenarios, each at its own numpy-seeded iterate off the warm start
    and with its own perturbed initial state (test_torch_trot_slice.py's
    fleet)."""
    jt, tp = case
    its = [trot_iterate(tp, seed=20 + b) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    rng = np.random.default_rng(1)
    q0s = np.stack([np.asarray(jrm.integrate(
        jt["model"], jt["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    return jt, tp, sol, q0s, np.zeros((B, 18))


_PORT = {}


def _port(tp, sol, q0s, v0s, use_chain):
    """The port's fleet update on the module's fleet, computed once per
    route (the tests read it, none writes it)."""
    if use_chain not in _PORT:
        _PORT[use_chain] = TOS._update(
            tp["model"], tp["contacts"], tp["limits"], 1e-3, 0.995,
            tp["costs"], convert.solution(sol, device="cpu"), tp["grid"],
            torch.as_tensor(q0s), torch.as_tensor(v0s), n_imp=tp["n_imp"],
            enable_sw=True, use_chain=use_chain)
    return _PORT[use_chain]

def test_chain_path_matches_jacfwd_path(fleet):
    _, tp, sol, q0s, v0s = fleet
    a = _port(tp, sol, q0s, v0s, use_chain=True)
    b = _port(tp, sol, q0s, v0s, use_chain=False)
    _close_scaled(a[1].numpy(), b[1].numpy(), 1e-10, "kkt")
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu",
                 "s_cone", "z_cone", "xi"):
        _close_scaled(getattr(a[0], name).numpy(),
                      getattr(b[0], name).numpy(), 1e-10, name)


def test_mpc_trot_init_and_update():
    """MPCTrot on the port's own problem: a few initial Newton updates at
    t = 0.35, then one MPC update 0.025 s later (re-planned grid, aligned
    warm start, two updates); the KKT shrinks and stays finite."""
    p = problems.anymal_trot(N=N, device="cpu")
    kkt0 = p.mpc.init(0.35, p.q0, p.v0, num_iters=4)
    kkt1 = p.mpc.update_solution(0.375, 0.025, p.q0, p.v0)
    assert np.isfinite(kkt0) and np.isfinite(kkt1)
    assert kkt0 < 1e2
    assert p.mpc.sol.q.shape == (p.grid.n_slots, 19)
    assert p.mpc.kkt_error(0.375, p.q0, p.v0) > 0.0


def test_switching_constraint(case):
    jt, tp = case
    q, v, a, _ = anymal_states(tp["model"], 2, 6)
    g = {k: np.array(x) for k, x in vars(jt["grid"]).items()}

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64)

    mask = np.array([0.0, 1.0, 1.0, 0.0])
    for i in range(2):
        args = (q[i], v[i], a[i], 0.025, 0.02, g["p_ref"][9], g["R_ref"][9],
                mask)
        want = np_tree(jit_unoptimised(lambda *x: jswc.residual_and_jacs(
            jt["model"], jt["contacts"], *x))(*args))
        got = tswc.residual_and_jacs(tp["model"], tp["contacts"],
                                     *[T(x) for x in args])
        close_tree(got, want, TOL, name="residual_and_jacs")
        rng = np.random.default_rng(7 + i)
        G, c0 = rng.standard_normal((18, 48)), rng.standard_normal(18)
        want = np_tree(jit_unoptimised(lambda *x: jswc.condense(*x, 18, 12))(
            *want, G, c0))
        got = tswc.condense(*got, T(G), T(c0), 18, 12)
        close_tree(got, want, TOL, name="condense")


def test_quadratize_impact_container(case):
    """costs/base.quadratize_impact over the stack, with and without the
    task kinematics handed in."""
    jt, tp = case
    q, v, dv, _ = anymal_states(tp["model"], 1, 9)
    q = q[0]

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64)

    want = np_tree(jit_unoptimised(lambda *a: jcost_base.quadratize_impact(
        jt["costs"], jt["model"], *a))(q, v[0], dv[0], 0.6))
    got = tcost_base.quadratize_impact(tp["costs"], tp["model"], T(q),
                                       T(v[0]), T(dv[0]), T(0.6))
    close_tree(got, want, TOL, name="quadratize_impact")

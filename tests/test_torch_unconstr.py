"""The port's unconstrained solver (robotoc_tpu_torch/solver/
unconstr_ocp_solver.py, line_search/unconstr_line_search.py) and its
fixed-base robot, the iiwa14, against the JAX package in float64 on the
CPU.

The iiwa14's `rnea`, `rnea_derivatives`, `crba`, forward kinematics,
`integrate` and `difference` on seeded states, and the configuration cost
and joint limits (dim_passive 0), against JAX's, to 1e-10 relative. At N 6
(the smallest horizon the comparisons need: every stage kind, intermediate
and terminal, is present at any N; 6 keeps the JAX compiles short), from
a seeded iterate off the warm start: `_build_kkt` (the LQR data, the
expansion data and the performance index) and one `_update` against the
JAX functions under `jax.jit`, 1e-10 relative to each array's largest
magnitude (at least one); one step with the filter line search against
JAX's `_direction_step` with `ls_ctx`, its filter holding one earlier
iterate's pair that refuses the first rungs (a filter the solve loop
carries; from an empty filter no step of this problem backtracks): the
same accepted step, every field to 1e-8. The golden trace
tests/golden/iiwa14_config_ocp.npz (the JAX package's frozen f64 output)
through the port's `solve` at N 60 to the 1e-6 of
tests/test_golden_traces.py; tests/test_unconstr_solver.py's assertions
on the port at that file's N 20; and a B = 2 fleet against its two single
solves, 1e-10."""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (close_tree, fields, IIWA_Q0, jax_iiwa,
                          jit_unoptimised, np_tree, perturbed_arm_iterate)

from robotoc_tpu.constraints import joint_limits as jjl
from robotoc_tpu.costs import config_cost as jcc
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.solver import unconstr_ocp_solver as JU
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.constraints import joint_limits as tjl
from robotoc_tpu_torch.costs import config_cost as tcc
from robotoc_tpu_torch.line_search import line_search as tls
from robotoc_tpu_torch.line_search import unconstr_line_search as uls
from robotoc_tpu_torch.models import load_robot
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.solver import unconstr_ocp_solver as TU

GOLD = os.path.join(os.path.dirname(__file__), "golden",
                    "iiwa14_config_ocp.npz")
N, T = 6, 0.6
BARRIER, FTB = 1e-3, 0.995


@functools.lru_cache(maxsize=None)
def _jax():
    return jax_iiwa()


@functools.lru_cache(maxsize=None)
def _port(n=N, t=T, **opts):
    return problems.iiwa14_config(N=n, T=t, device="cpu",
                                  options=TU.SolverOptions(**opts))


@functools.lru_cache(maxsize=None)
def _states(S=8, seed=0):
    rng = np.random.default_rng(seed)
    return (np.asarray(IIWA_Q0) + 0.5 * rng.standard_normal((S, 7)),
            rng.standard_normal((S, 7)), rng.standard_normal((S, 7)))


# -- the fixed-base robot ----------------------------------------------------

def _dyn_jax(name):
    m = _jax()["model"]
    fns = {
        "rnea": lambda q, v, a: jrm.rnea(m, q, v, a),
        "rnea_derivatives": lambda q, v, a: jrm.rnea_derivatives(m, q, v,
                                                                 a),
        "crba": lambda q, v, a: jrm.crba(m, q),
        "forward_kinematics": lambda q, v, a: jrm.forward_kinematics(m, q),
        "integrate_difference": lambda q, v, a: (
            jrm.integrate(m, q, v), jrm.difference(m, q, a)),
    }
    return jit_unoptimised(jax.vmap(fns[name]))


def _dyn_port(name, q, v, a):
    m = load_robot("iiwa14", device="cpu")
    one = {
        "rnea": lambda q, v, a: trm.rnea(m, q, v, a),
        "rnea_derivatives": lambda q, v, a: trm.rnea_derivatives(m, q, v,
                                                                 a),
        "crba": lambda q, v, a: trm.crba(m, q),
        "forward_kinematics": lambda q, v, a: trm.forward_kinematics(m, q),
        "integrate_difference": lambda q, v, a: (
            trm.integrate(m, q, v), trm.difference(m, q, a)),
    }[name]
    return torch.func.vmap(one)(q, v, a)


@pytest.mark.parametrize("name", ["rnea", "rnea_derivatives", "crba",
                                  "forward_kinematics",
                                  "integrate_difference"])
def test_iiwa14_model_matches_jax(name):
    """The port's own iiwa14 description and fixed-base paths."""
    q, v, a = _states()
    want = np_tree(_dyn_jax(name)(*(jnp.asarray(x) for x in (q, v, a))))
    got = _dyn_port(name, *(torch.as_tensor(x) for x in (q, v, a)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    close_tree([g.numpy() for g in got], want, 1e-10, name)


def test_config_cost_and_joint_limits_match_jax():
    """ConfigurationSpaceCost and JointLimits with dim_passive 0 (one
    sample; the q error is q - q_ref, the limits cover every joint)."""
    jp, tp = _jax(), _port()
    assert tp.model.dim_passive == 0 and tp.model.dimu == 7
    q, v, a = (x[0] for x in _states())
    u = 30.0 * np.random.default_rng(3).standard_normal(7)
    s = np.exp(np.random.default_rng(4).standard_normal(56))
    z = np.exp(np.random.default_rng(5).standard_normal(56))
    J = [jnp.asarray(x) for x in (q, v, a, u, s, z)]
    P = [torch.as_tensor(x) for x in (q, v, a, u, s, z)]
    jm, jc, jl = jp["model"], jp["cost"], jp["limits"]
    tm, tc, tl = tp.model, tp.cost, tp.limits
    je = jjl.constraint_values(jm, jl, J[0], J[1], J[3], J[2])
    te = tjl.constraint_values(tm, tl, P[0], P[1], P[3], P[2])
    want = [jcc.quadratize_stage(jm, jc, J[0], J[1], J[2], J[3], 0.1),
            jcc.quadratize_terminal(jm, jc, J[0], J[1]), je,
            jjl.condense(jm, jl, je, J[4], J[5], BARRIER),
            jjl.dual_residual(jm, jl, J[5]),
            jjl.constraint_direction(jm, jl, J[1], J[2], J[3], J[0])]
    got = [tcc.quadratize_stage(tm, tc, P[0], P[1], P[2], P[3], 0.1),
           tcc.quadratize_terminal(tm, tc, P[0], P[1]), te,
           tjl.condense(tm, tl, te, P[4], P[5], BARRIER),
           tjl.dual_residual(tm, tl, P[5]),
           tjl.constraint_direction(tm, tl, P[1], P[2], P[3], P[0])]
    close_tree(np_tree([list(x) if isinstance(x, tuple) else x
                        for x in got]),
               np_tree([list(x) if isinstance(x, tuple) else x
                        for x in want]), 1e-10, "cost and limits")


# -- the build and the update at N 6 -----------------------------------------

@functools.lru_cache(maxsize=None)
def _jit(kind):
    """The JAX package's functions of the N 6 problem, jitted once each:
    its `_update` is `_build_kkt` then `_direction_step`, compiled here as
    two functions so that the build's compile serves all three tests."""
    jp = _jax()
    if kind == "build":
        return jit_unoptimised(lambda s, q, v: JU._build_kkt(
            jp["model"], (jp["cost"],), jp["limits"], T / N, BARRIER, 0.0,
            s, q, v))
    if kind == "step":
        return jit_unoptimised(lambda built, s: JU._direction_step(
            jp["model"], jp["limits"], BARRIER, FTB, built, s)[:3])
    return jit_unoptimised(lambda built, s, q, v, filt, it: JU._direction_step(
        jp["model"], jp["limits"], BARRIER, FTB, built, s,
        ((jp["cost"],), T / N, 0.0, q, v, filt, it, 0.75, 0.05)))


def _jax_built(js, q0, v0):
    return _jit("build")(js, jnp.asarray(q0), jnp.asarray(v0))


@functools.lru_cache(maxsize=None)
def _iterate(seed=1):
    """A seeded iterate off the port's warm start at N 6 (numpy fields)
    and the initial state."""
    tp = _port()
    warm = tp.solver.init_solution(tp.q0, tp.v0)
    return perturbed_arm_iterate(warm, seed), tp.q0.numpy(), tp.v0.numpy()


def _both(f):
    return (JU.UnconstrSolution(**{k: jnp.asarray(v) for k, v in f.items()}),
            convert.unconstr_solution(f, device="cpu"))


def test_build_kkt_matches_jax():
    f, q0, v0 = _iterate()
    js, ts = _both(f)
    data, aux, perf, dx0 = np_tree(_jax_built(js, q0, v0))
    tp = _port()
    got = TU._build_kkt(*tp.solver._args(), 0.0, ts.map(
        lambda x: x.unsqueeze(0)), torch.as_tensor(q0)[None],
        torch.as_tensor(v0)[None])
    tdata, taux, tperf, tdx0 = got
    for name in ("A", "B", "xres", "Qxx", "Qxu", "Quu", "lx", "lu",
                 "Qxx_N", "lx_N"):
        close_tree([getattr(tdata, name)[0].numpy()],
                   [getattr(data, name)], 1e-10, name)
    for name, val in aux.items():
        close_tree([taux[name][0].numpy()], [val], 1e-10, name)
    for name in ("cost", "cost_barrier", "primal_feasibility",
                 "dual_feasibility", "kkt_error"):
        np.testing.assert_allclose(getattr(tperf, name)[0].numpy(),
                                   getattr(perf, name), rtol=1e-10,
                                   err_msg=name)
    close_tree([tdx0[0].numpy()], [dx0], 1e-10, "dx0")


def test_update_matches_jax():
    f, q0, v0 = _iterate()
    js, ts = _both(f)
    new, kkt, a_p = np_tree(_jit("step")(_jax_built(js, q0, v0), js))
    tnew, tkkt, ta_p = TU._update(*_port().solver._args(), FTB, 0.0, ts,
                                  torch.as_tensor(q0), torch.as_tensor(v0))
    np.testing.assert_allclose(tkkt.numpy(), kkt, rtol=1e-10)
    np.testing.assert_allclose(ta_p.numpy(), a_p, rtol=1e-10)
    for name, val in fields(new).items():
        close_tree([getattr(tnew, name).numpy()], [val], 1e-10, name)


def test_filter_step_matches_jax():
    """The filter holds one earlier pair (slot 0; this step's slot is 1)
    that refuses the full step: its violation 0.999 of the full step's and
    its cost margin 1e-6 below the full step's cost. On this problem the
    cost and the violation of the trials both grow as the step shrinks,
    so every rung is refused and the search runs to its last rung, the
    first at most min_step 0.05 (the JAX loop's exit)."""
    f, q0, v0 = _iterate()
    js, ts = _both(f)
    tp = _port()
    sb = ts.map(lambda x: x.unsqueeze(0))
    qb, vb = torch.as_tensor(q0)[None], torch.as_tensor(v0)[None]
    built = TU._build_kkt(*tp.solver._args(), 0.0, sb, qb, vb)
    c, v, alphas = _ladder_pairs(tp, built, sb, qb, vb)
    last = int(np.argmax(alphas <= 0.05))     # the loop's exit rung
    assert last > 0 and alphas[last] <= 0.05
    assert (np.diff(c[:last + 1]) > 0).all()
    assert (np.diff(v[:last + 1]) > 0).all()
    v_e = 0.999 * v[0]
    c_e = c[0] * (1.0 - 1e-6) + 0.005 * v_e
    filt = uls.empty_filter(torch.float64, "cpu", (1,))
    filt[0, 0] = torch.tensor([c_e, v_e], dtype=torch.float64)
    new, kkt, a_p, _, filt_out = TU._direction_step(
        tp.model, tp.limits, BARRIER, FTB, built, sb,
        ((tp.cost,), T / N, 0.0, qb, vb, filt, 1, 0.75, 0.05))
    assert float(a_p[0]) == float(alphas[last])
    ref = np_tree(_jit("filter")(_jax_built(js, q0, v0), js,
                                 jnp.asarray(q0), jnp.asarray(v0),
                                 jnp.asarray(filt[0].numpy()),
                                 jnp.asarray(1)))
    rnew, rkkt, ra_p, _, rfilt = ref
    np.testing.assert_allclose(float(a_p[0]), ra_p, rtol=1e-10)
    np.testing.assert_allclose(filt_out[0].numpy(), rfilt, rtol=1e-8)
    for name, val in fields(rnew).items():
        close_tree([getattr(new, name)[0].numpy()], [val], 1e-8, name)


def _ladder_pairs(tp, built, sb, qb, vb):
    """(cost, violation, step) of each rung of the ladder of trial steps
    from the fraction-to-boundary step (numpy)."""
    step, _, a_max, _ = TU._direction_step(tp.model, tp.limits, BARRIER,
                                           FTB, built, sb)
    alphas = tls.ladder(a_max, uls.n_rungs(0.75, 0.05), 0.75)   # (R, 1)

    def along(name):
        d = (getattr(step, name) - getattr(sb, name)) / a_max[:, None, None]
        return getattr(sb, name) + alphas[..., None, None] * d

    trials = sb.replace(**{n: along(n) for n in ("q", "v", "a", "u",
                                                 "slack")})
    c, v = uls.eval_unconstr(tp.model, (tp.cost,), tp.limits, T / N,
                             BARRIER, 0.0, trials, qb, vb)
    return c[:, 0].numpy(), v[:, 0].numpy(), alphas[:, 0].numpy()


# -- solves -------------------------------------------------------------------

def test_golden_trace():
    """tests/golden/iiwa14_config_ocp.npz (N 60, T 3) to the 1e-6 (rtol
    and atol) of tests/test_golden_traces.py."""
    ref = np.load(GOLD)
    p = problems.iiwa14_config(device="cpu")
    sol, st = p.solver.solve(p.q0, p.v0)
    assert bool(st["convergence"]) and float(st["kkt_error"]) < 1e-7
    for name in ("q", "v", "a", "u"):
        np.testing.assert_allclose(getattr(sol, name).numpy(), ref[name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@functools.lru_cache(maxsize=None)
def _solved():
    """tests/test_unconstr_solver.py's problem (N 20, T 1), solved once."""
    p = _port(20, 1.0)
    return p, p.solver.solve(p.q0, p.v0)


def test_converges_to_kkt_tol():
    p, (sol, st) = _solved()
    assert float(st["kkt_error"]) < 1e-7
    assert int(st["iterations"]) < 30
    np.testing.assert_allclose(sol.q[0].numpy(), p.q0.numpy(), atol=1e-8)
    np.testing.assert_allclose(sol.v[0].numpy(), p.v0.numpy(), atol=1e-8)


def test_constraints_satisfied():
    p, (sol, _) = _solved()
    assert float(sol.u[:-1].abs().max()) <= 50.0 + 1e-6
    assert float(sol.v.abs().max()) <= np.pi / 2 + 1e-6
    assert bool((sol.q >= p.model.q_lower - 1e-6).all())
    assert bool((sol.q <= p.model.q_upper + 1e-6).all())


def test_dynamics_feasibility_at_solution():
    p, (sol, _) = _solved()
    dt = p.solver.dt
    ID = trm.rnea(p.model, sol.q[:-1], sol.v[:-1], sol.a[:-1])
    np.testing.assert_allclose(ID.numpy(), sol.u[:-1].numpy(), atol=1e-7)
    np.testing.assert_allclose((sol.q[:-1] + dt * sol.v[:-1]).numpy(),
                               sol.q[1:].numpy(), atol=1e-7)
    np.testing.assert_allclose((sol.v[:-1] + dt * sol.a[:-1]).numpy(),
                               sol.v[1:].numpy(), atol=1e-7)


def test_warm_start_converges_fast():
    p, (sol, _) = _solved()
    _, st2 = p.solver.solve(p.q0, p.v0, sol=sol)
    assert int(st2["iterations"]) <= 1


def test_fleet_equals_single_solves():
    """Scenario 0 is the problem's own initial state, scenario 1 moved by
    0.05 N(0, 1): each equals its own solve (iterations, KKT, fields to
    1e-10 of each field's largest magnitude, at least one)."""
    p, (sol0, st0) = _solved()
    q0s, v0s = problems.iiwa14_fleet(p, 2, seed=0)
    q0s[0] = p.q0
    sol_b, st_b = p.solver.solve(q0s, v0s)
    sol1, st1 = p.solver.solve(q0s[1], v0s[1])
    for b, (sol, st) in enumerate(((sol0, st0), (sol1, st1))):
        assert int(st_b["iterations"][b]) == int(st["iterations"])
        np.testing.assert_allclose(float(st_b["kkt_error"][b]),
                                   float(st["kkt_error"]), rtol=1e-6,
                                   atol=1e-12)
        close_tree([getattr(sol_b, n)[b].numpy() for n in fields(sol)],
                   [getattr(sol, n).numpy() for n in fields(sol)], 1e-10,
                   f"scenario {b}")

"""The port's Newton loop `OCPSolver.solve` against the JAX package's in
float64 on the CPU.

The golden ANYmal standing OCP at N 4 from its warm start, with the
initial state rotated by 1e-3 in yaw: four Newton iterations (kkt_tol 0)
without a line search and with the filter, against the JAX package's
`_solve` loop, iterate by iterate: the KKT history and the step-size
history (1e-8 and 1e-10 relative) and every final field (1e-7 of its
largest magnitude, at least one: this stiff problem's rounding grows
fast with the iterations, costates near 4e4; the JAX package's own two
compilations of the loop, OCPSolver.solve's while_loop and the body
functions below, differ by 1.7e-8 in beta, whose largest magnitude is
0.12, after six iterations, and the port sits 7.1e-9 from JAX in beta
after these four). The JAX reference runs `_solve`'s body
functions (`_build`, then `_direction_and_step` with the filter carried
and its slot the iteration count) jitted, with the while_loop's
condition and bookkeeping written out below: one trace of each function
in place of `OCPSolver.solve`'s two traces of the build per variant. A
B = 2 fleet (one scenario
reaching kkt_tol before the other, so that one is frozen while the other
runs) equals its two single-scenario solves (histories 1e-8, fields
1e-7 as above: batched products round differently, 2.3e-8 in beta after
five iterations). The barrier path with
statistics=True on tests/test_barrier_schedule.py's problem at N 4 (mu
from 1e-2 to 1e-5) meets that test's assertions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cases import (fields, jax_problem, jit_unoptimised, np_tree,
                          to_torch)
from test_barrier_schedule import _standing_problem

from robotoc_tpu.line_search import line_search as jls
from robotoc_tpu.riccati import lqr
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.solver import ocp_solver as TOS

N, ITERS = 4, 4


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def case():
    jp = jax_problem(N)
    tp = to_torch(jp)
    dq = torch.zeros(18, dtype=torch.float64)
    dq[5] = 1e-3
    q0 = trm.integrate(tp["model"], tp["q0"], dq)
    return jp, tp, q0


def _port_solver(tp, **opts):
    return TOS.OCPSolver(tp["model"], tp["contacts"], (tp["cost"],),
                         tp["limits"], T=0.5, N=N,
                         options=TOS.SolverOptions(**opts))


_JIT = {}


def _jax_fns(jp, search):
    """The JAX package's build and Newton step of the standing problem
    (OCPSolver's static options: barrier 1e-3, fraction-to-boundary 0.995,
    no impact slots, the serial Riccati), jitted once per module."""
    args = (jp["model"], jp["contacts"], jp["limits"], 1e-3)
    if "build" not in _JIT:
        _JIT["build"] = jit_unoptimised(lambda s, q, v: JOS._build(
            *args, 0, (jp["cost"],), s, jp["grid"], q, v))
    if search not in _JIT:
        _JIT[search] = jit_unoptimised(lambda s, q, v, built, filt, it:
                               JOS._direction_and_step(
                                   *args, 0.995, 0, (jp["cost"],), s,
                                   jp["grid"], q, v, built, riccati=lqr,
                                   enable_ls=search, filt=filt, ls_it=it))
    return _JIT["build"], _JIT[search]


def _jax_solve(jp, sol, q0, v0, max_iter, kkt_tol, search):
    """robotoc_tpu's `_solve` of one scenario: while (it < max_iter) &
    (kkt > kkt_tol) & ok, one step from the current build, the next build,
    the last good iterate kept on a non-finite KKT; the histories."""
    build, step = _jax_fns(jp, search)
    built = build(sol, q0, v0)
    kkt = jnp.sqrt(built[3])
    ok, it, filt = bool(jnp.isfinite(kkt)), 0, jls.empty_filter()
    kkt_h, alpha_h = [], []
    while it < max_iter and float(kkt) > kkt_tol and ok:
        out = step(sol, q0, v0, built, filt, jnp.asarray(it))
        if search == "filter":
            filt = out[4]
        built = build(out[0], q0, v0)
        kkt_new = jnp.sqrt(built[3])
        ok = bool(jnp.isfinite(kkt_new))
        if ok:
            sol, kkt = out[0], kkt_new
        kkt_h.append(float(kkt))
        alpha_h.append(float(out[2]))
        it += 1
    return sol, it, np.array(kkt_h), np.array(alpha_h), ok


@pytest.mark.parametrize("search", [False, "filter"])
def test_solve_matches_jax(case, search):
    jp, tp, q0 = case
    solver = _port_solver(tp, max_iter=ITERS, kkt_tol=0.0,
                          enable_line_search=search)
    warm = solver.init_solution(tp["grid"], tp["q0"], tp["v0"])
    sol, st = solver.solve(tp["grid"], q0, tp["v0"], sol=warm)
    jwarm = JOS.Solution(**{k: jnp.asarray(v.numpy())
                            for k, v in vars(warm).items()})
    ref_sol, its, kkt_h, alpha_h, ok = _jax_solve(
        jp, jwarm, jnp.asarray(q0.numpy()), jp["v0"], ITERS, 0.0, search)
    assert int(st["iterations"]) == its == ITERS
    np.testing.assert_allclose(st["kkt_history"].numpy(), kkt_h, rtol=1e-8)
    np.testing.assert_allclose(st["step_size_history"].numpy(), alpha_h,
                               rtol=1e-10)
    assert bool(st["numerical_failure"]) == (not ok)
    for name, val in fields(np_tree(ref_sol)).items():
        _close_scaled(getattr(sol, name).numpy(), val, 1e-7, name)


def test_fleet_solve_equals_single_solves(case):
    """Scenario 0 starts at the warm start's own initial state and reaches
    kkt_tol first; scenario 1 (rotated) runs on: each equals its own
    single-scenario solve (filter search, its filter carried per
    scenario)."""
    _, tp, q0 = case
    solver = _port_solver(tp, max_iter=5, kkt_tol=2.0,
                          enable_line_search="filter")
    warm = solver.init_solution(tp["grid"], tp["q0"], tp["v0"])
    q0s = torch.stack([tp["q0"], q0])
    v0s = torch.zeros(2, 18, dtype=torch.float64)
    fleet = warm.map(lambda x: x.expand((2,) + x.shape).contiguous())
    sol_b, st_b = solver.solve(tp["grid"], q0s, v0s, sol=fleet)
    its = [int(i) for i in st_b["iterations"]]
    assert its[0] < its[1], its
    for b in range(2):
        sol_1, st_1 = solver.solve(tp["grid"], q0s[b], v0s[b], sol=warm)
        assert int(st_1["iterations"]) == its[b]
        for key in ("kkt_error", "kkt_history", "step_size_history"):
            np.testing.assert_allclose(st_b[key][b].numpy(),
                                       st_1[key].numpy(), rtol=1e-8,
                                       err_msg=key)
        for name in TOS.Solution.__dataclass_fields__:
            _close_scaled(getattr(sol_b, name)[b].numpy(),
                          getattr(sol_1, name).numpy(), 1e-7, name)


def test_barrier_path_with_statistics():
    """tests/test_barrier_schedule.py::test_barrier_path_following_converges
    on the port, at N 4."""
    opts = dict(max_iter=30, kkt_tol=1e-7, barrier=1e-2, mu_min=1e-5,
                kkt_tol_mu=1e-4, mu_linear_decrease_factor=0.2,
                mu_superlinear_decrease_power=1.5)
    js, grid, q0, v0 = _standing_problem(JOS.SolverOptions(**opts), N=4)
    tp = to_torch(dict(model=js.model, contacts=js.contacts,
                       cost=js.costs[0], limits=js.limits, grid=grid, q0=q0,
                       v0=v0))
    solver = TOS.OCPSolver(tp["model"], tp["contacts"], (tp["cost"],),
                           tp["limits"], T=js.T, N=4,
                           options=TOS.SolverOptions(**opts))
    sol, st, stats = solver.solve(tp["grid"], tp["q0"], tp["v0"],
                                  statistics=True)
    assert bool(st["convergence"]), st
    assert float(st["kkt_error"]) < 1e-7
    assert stats.barrier[0] == 1e-2
    assert np.isclose(stats.barrier[-1], 1e-5)
    assert len(stats.barrier) >= 3
    assert stats.iter == len(stats.kkt_error) > 0
    assert stats.kkt_error[-1] < 1e-7
    assert all(np.isfinite(k) for k in stats.kkt_error)
    assert stats.convergence
    assert stats.cpu_time > 0.0

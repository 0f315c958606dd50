"""The port's contact-OCP Newton update end to end against the JAX package.

The golden ANYmal standing OCP at N = 4 for a fleet of B = 2 scenarios whose
initial configurations are moved by seeded noise: one port `_update` (fleet
dim written out) against the JAX `_update(use_pallas=False)` vmapped over
the fleet, from the same iterate (the updated Solution and the KKT error,
1e-8 in f64, relative to each field's largest magnitude when that exceeds
one: the Newton directions of this stiff problem reach 1e5 in the
costates, and their f64 rounding scales with them). Then the port alone
reproduces tests/golden/anymal_standing_ocp.npz on the CPU to the 1e-6 of
tests/test_golden_traces.py."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (assert_close, fields, jax_init_solution,
                          jax_problem, np_tree, to_torch)

from robotoc_tpu.models import robot as jrm
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.solver import ocp_solver as TOS

N, B = 4, 2
GOLD = os.path.join(os.path.dirname(__file__), "golden",
                    "anymal_standing_ocp.npz")


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _fleet_inputs(jp, seed):
    """B initial states moved by seeded noise and the warm-start iterate
    broadcast to the fleet (numpy fields, (B, ...))."""
    rng = np.random.default_rng(seed)
    q0s = np.stack([np.asarray(jrm.integrate(
        jp["model"], jp["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    v0s = np.zeros((B, 18))
    js = JOS.OCPSolver(jp["model"], jp["contacts"], (jp["cost"],),
                       jp["limits"], T=0.5, N=N)
    sol0 = fields(jax_init_solution(js, jp["grid"], jp["q0"], jp["v0"]))
    return q0s, v0s, {k: np.stack([v] * B) for k, v in sol0.items()}


_PROBLEMS = {}


def _problem(dtype=jnp.float64):
    """The JAX problem of one dtype, its port counterpart and its jitted
    fleet update, built once per module (one XLA compile per dtype)."""
    if dtype not in _PROBLEMS:
        jp = jax_problem(N, dtype=dtype)

        def upd(s, q, v):
            new, kkt, a_p, _ = JOS._update(
                jp["model"], jp["contacts"], jp["limits"], 1e-3, 0.995, 0,
                (jp["cost"],), s, jp["grid"], q, v, use_pallas=False)
            return new, kkt, a_p
        tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
        _PROBLEMS[dtype] = (jp, to_torch(jp, dtype=tdtype),
                            jax.jit(jax.vmap(upd)))
    return _PROBLEMS[dtype]


def _jax_update(sol, q0s, v0s, dtype):
    fn = _problem(dtype)[2]
    js = JOS.Solution(**{k: jnp.asarray(v, dtype) for k, v in sol.items()})
    return np_tree(fn(js, jnp.asarray(q0s, dtype), jnp.asarray(v0s, dtype)))


def _port_update(tp, sol, q0s, v0s, dtype):
    ts = convert.solution(sol, dtype=dtype, device="cpu")
    new, kkt, a_p, _ = TOS._update(
        tp["model"], tp["contacts"], tp["limits"], 1e-3, 0.995,
        (tp["cost"],), ts, tp["grid"], torch.as_tensor(q0s, dtype=dtype),
        torch.as_tensor(v0s, dtype=dtype))
    return new, kkt, a_p


@pytest.mark.parametrize("iterate", ["warm_start", "second"])
def test_update_matches_jax_f64(iterate):
    """From the warm start, and from the JAX package's own first iterate
    (so both packages take the second update from the same point)."""
    jp, tp, _ = _problem()
    q0s, v0s, sol = _fleet_inputs(jp, 0)
    if iterate == "second":
        sol = fields(_jax_update(sol, q0s, v0s, jnp.float64)[0])
    ref_sol, ref_kkt, ref_ap = _jax_update(sol, q0s, v0s, jnp.float64)
    new, kkt, a_p = _port_update(tp, sol, q0s, v0s, torch.float64)
    assert_close(kkt.numpy(), ref_kkt, 1e-8, "kkt")
    assert_close(a_p.numpy(), ref_ap, 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        _close_scaled(getattr(new, name).numpy(), val, 1e-8, name)


def test_update_f32_no_worse_than_jax_f32():
    """Both packages in float32 (JAX arrays built explicitly f32, since the
    test process runs JAX with x64 on). On this stiff problem the f32
    directions carry large rounding (the JAX package's own f32 step size
    differs from its f64 one by tens of percent), so the port's f32 update
    is held to the f64 update instead: per field, its distance from the
    f64 result is at most that of the JAX package's f32 update (plus 1e-3
    of the field's magnitude)."""
    jp64, tp64, _ = _problem()
    _, tp32, _ = _problem(jnp.float32)
    q0s, v0s, sol = _fleet_inputs(jp64, 3)
    ref32 = _jax_update(sol, q0s, v0s, jnp.float32)[0]
    new64 = _port_update(tp64, sol, q0s, v0s, torch.float64)[0]
    new32, kkt32, _ = _port_update(tp32, sol, q0s, v0s, torch.float32)
    assert kkt32.dtype == torch.float32
    for name, val in fields(ref32).items():
        got = getattr(new32, name)
        assert got.dtype == torch.float32, name
        exact = getattr(new64, name).numpy()
        err_port = float(np.abs(got.numpy() - exact).max(initial=0.0))
        err_jax = float(np.abs(val - exact).max(initial=0.0))
        scale = max(1.0, float(np.abs(exact).max(initial=0.0)))
        assert err_port <= err_jax + 1e-3 * scale, (name, err_port, err_jax)


def test_single_scenario_equals_fleet_member():
    jp, tp, _ = _problem()
    q0s, v0s, sol = _fleet_inputs(jp, 5)
    new_b, kkt_b, _ = _port_update(tp, sol, q0s, v0s, torch.float64)
    one = {k: v[1] for k, v in sol.items()}
    new_1, kkt_1, _ = _port_update(tp, one, q0s[1], v0s[1], torch.float64)
    assert kkt_1.dim() == 0
    assert_close(kkt_1.numpy(), kkt_b[1].numpy(), 1e-12)
    assert_close(new_1.q.numpy(), new_b.q[1].numpy(), 1e-12)
    kkt_e = TOS._kkt_error(tp["model"], tp["contacts"], tp["limits"], 1e-3,
                           (tp["cost"],), convert.solution(sol, device="cpu"),
                           tp["grid"], torch.as_tensor(q0s),
                           torch.as_tensor(v0s))
    assert_close(kkt_e.numpy(), kkt_b.numpy(), 1e-12)


def test_unported_options_raise():
    p = problems.anymal_standing(N=N, device="cpu")
    args = (p.model, p.contacts, (p.cost,), p.limits, p.T, p.N)
    for flag in ("parallel_riccati", "enable_line_search"):
        with pytest.raises(NotImplementedError):
            TOS.OCPSolver(*args, options=TOS.SolverOptions(**{flag: True}))
    with pytest.raises(NotImplementedError):
        TOS.OCPSolver(*args).solve(p.grid, p.q0, p.v0)


def test_golden_anymal_trace_through_the_port():
    """16 Newton updates of the port on the golden problem (f64, CPU)."""
    ref = np.load(GOLD)
    p = problems.anymal_standing(N=20, device="cpu")
    solver = TOS.OCPSolver(p.model, p.contacts, (p.cost,), p.limits, T=p.T,
                           N=p.N)
    sol = solver.init_solution(p.grid, p.q0, p.v0)
    for _ in range(16):
        sol, kkt, _, _ = solver.update(p.grid, p.q0, p.v0, sol)
    assert float(kkt) < 1e-6
    for name in ("q", "v", "a", "u", "f"):
        np.testing.assert_allclose(getattr(sol, name).numpy(), ref[name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)

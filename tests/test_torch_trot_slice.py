"""The port's trot MPC update end to end against the JAX package.

The mid-gait ANYmal trot at N = 10 (4 impact slots, switching
constraints, the gait cost stack) for a fleet of B = 2 scenarios, each at
its own numpy-seeded iterate off the warm start (switching multipliers
included) and with its own perturbed initial state: one port `_update`
(fleet dim written out) against the JAX `_update(use_pallas=False,
use_chain=False, enable_sw=True)` on each scenario, the KKT, step
size and every Solution field to 1e-8 relative to each field's largest
magnitude (at least one), as tests/test_torch_ocp_slice.py holds the
standing update. (The port's chain path against its jacfwd path on this
fleet, and the MPC layer on the port's own problem: tests/test_torch_trot.py.)

The closed loop: the port's MPCTrot (N 10) in the port's MPCSimulation
against the JAX MPCTrot in the JAX driver, from the same `init`, 4 ticks
with the feedback policy, the one-tick delay and two ticks per MPC update:
q, v, u and the KKT to 1e-8 of max(1, |x|). Every JAX reference of the
file goes through the one compiled update of that JAX MPCTrot (its
solver's jitted `_update`: the XLA path with the switching constraints on,
no search)."""
import numpy as np
import pytest
import torch

from _torch_cases import (Q_STAND, close_tree, fields, jax_fleet,
                          jax_mpc_solver, jax_trot, trot_iterate,
                          trot_to_torch)

from robotoc_tpu.models import robot as jrm
from robotoc_tpu.sim.mpc_simulation import MPCSimulation as JMPCSimulation
from robotoc_tpu.sim.simulator import LeggedSimulator as JLeggedSimulator
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.sim import MPCSimulation
from robotoc_tpu_torch.solver import ocp_solver as TOS

N, B = 10, 2


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def case():
    jt = jax_trot(N)
    # the MPC's solver (whose jitted `_update` every reference of the file
    # calls), made as its `init` makes it
    jax_mpc_solver(jt["mpc"], jt["costs"])
    tp = trot_to_torch(jt)
    its = [trot_iterate(tp, seed=20 + b) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    rng = np.random.default_rng(1)
    q0s = np.stack([np.asarray(jrm.integrate(
        jt["model"], jt["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    return jt, tp, sol, q0s, np.zeros((B, 18))


_PORT = {}


def _port(tp, sol, q0s, v0s, use_chain):
    """The port's fleet update on the module's case, computed once per
    route (the tests read it, none writes it)."""
    if use_chain not in _PORT:
        _PORT[use_chain] = _update(tp, sol, q0s, v0s, use_chain)
    return _PORT[use_chain]


def _update(tp, sol, q0s, v0s, use_chain):
    return TOS._update(tp["model"], tp["contacts"], tp["limits"], 1e-3,
                       0.995, tp["costs"], convert.solution(sol, device="cpu"),
                       tp["grid"], torch.as_tensor(q0s), torch.as_tensor(v0s),
                       n_imp=tp["n_imp"], enable_sw=True, use_chain=use_chain)


def test_trot_update_matches_jax_f64(case):
    jt, tp, sol, q0s, v0s = case

    solver = jt["mpc"]._solver
    o = solver.options
    assert o.switching_constraints and not solver.use_pallas and \
        o.barrier == 1e-3 and o.fraction_to_boundary_rule == 0.995 and \
        not o.enable_line_search and solver.n_reserved_events == \
        tp["n_imp"]

    def upd(s, q, v):
        return solver.update(jt["grid"], q, v, s, costs=jt["costs"])[:3]

    ref_sol, ref_kkt, ref_ap = jax_fleet(upd, sol, q0s, v0s)
    new, kkt, a_p, policy = _port(tp, sol, q0s, v0s, use_chain=True)
    assert policy.Mx is not None          # the switching branch ran
    _close_scaled(kkt.numpy(), ref_kkt, 1e-8, "kkt")
    _close_scaled(a_p.numpy(), ref_ap, 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        _close_scaled(getattr(new, name).numpy(), val, 1e-8, name)


def test_closed_loop_matches_jax(case):
    """MPCSimulation with MPCTrot in both packages from the same `init`
    (10 updates at t = 0, standing): 4 ticks of 2.5 ms with the feedback
    policy, the one-tick delay and two ticks per MPC update (two MPC
    updates of two Newton updates each), the plant at sim_dt 2.5e-4."""
    jm = case[0]["mpc"]
    run = dict(t0=0.0, q0=np.asarray(Q_STAND, float), simulation_time=0.01,
               control_dt=0.0025, feedback_policy=True, feedback_delay=True,
               simulation_steps_per_mpc_update=2)
    jkkt0 = jm.init(0.0, np.asarray(Q_STAND, float), np.zeros(18),
                    num_iters=10)
    want = JMPCSimulation(JLeggedSimulator(
        jm.model, jm.contacts, sim_dt=2.5e-4)).run(jm, **run).as_arrays()
    p = problems.anymal_trot_sim(N=N, device="cpu")
    kkt0 = p.mpc.init(0.0, p.q0, p.v0, num_iters=10)
    got = MPCSimulation(p.simulator).run(p.mpc, **run).as_arrays()
    close_tree([kkt0], [jkkt0], 1e-8, "init kkt")
    assert got["q"].shape == (4, 19) and got["u"].shape == (4, 12)
    assert np.all(np.isfinite(got["kkt"]))
    for name in ("t", "q", "v", "u", "kkt"):
        close_tree([got[name]], [want[name]], 1e-8, name)

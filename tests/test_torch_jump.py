"""The KKT-residual line search and the jump MPC of the port (MPCJump,
JumpFootStepPlanner) against the JAX package, f64, on the CPU.

Every JAX reference goes through one compiled update: the JAX MPCJump of
tests/test_mpc_jump.py (ANYmal, T 0.85, N 10, default options and limits:
two updates, switching constraints, the KKT search), whose solver's jitted
`_update` serves `init`, `update_solution` and the direct updates alike.

  * The jump OCP at t = 0 (stance, a full flight, the landing impact with
    its switching constraint): the grid, the cost and the warm start
    (1e-12); MPCJump's `init` with INIT_ITERS updates, then
    `update_solution` at T_SIDES, on either side of the lift-off: the
    grids, the iterate and the KKT to 1e-8.
  * Three more updates of the jump OCP at t = 0.35 (a flight, then the
    landing and its switching rows) from that iterate, against JAX's:
    each field to 1e-8 of its largest magnitude, the KKT and the step
    sizes to 1e-8 of max(1, |x|); each backtracks (the port's own rung
    index, from its ladder of trial builds). The jump OCP's backtracking
    updates at t = 0 (the fifth from the warm start) are ill-conditioned:
    its inputs moved by 1e-15 move its output by 6.5e-6 (the switching
    constrained Riccati's P reaches 8e9 there), so no two computations
    agree to 1e-8 on them; at t = 0.35 the same reading is 1e-12.
  * A B = 2 fleet of two scenarios on the t = 0.35 grid that backtrack a
    different number of times equals their single updates to 1e-12 (each
    field of its largest magnitude, the KKT and the step of max(1,
    |x|)).
  * JumpFootStepPlanner.plan to 1e-12, the landing targets 0.1 m ahead
    (1e-12); init(sto=True) refused.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cases import Q_STAND, fields, jax_mpc_solver

from robotoc_tpu.models import load_robot as jload
from robotoc_tpu.mpc import MPCJump as JMPCJump
from robotoc_tpu_torch import problems
from robotoc_tpu_torch.mpc import MPCJump
from robotoc_tpu_torch.solver import ocp_solver as TOS

INIT_ITERS = 2
T_SIDES = (0.25, 0.35)       # before and after the lift-off at 0.3


def _jax_mpc():
    mpc = JMPCJump(jload("anymal"), T=0.85, N=10)
    mpc.set_jump_pattern(jump_length=[0.1, 0.0, 0.0], jump_yaw=0.0,
                         flying_time=0.25, ground_time=0.3)
    return mpc


def _np_fields(sol):
    return {k: np.asarray(v) for k, v in fields(sol).items()}


def _close(got, want, tol, name, floor=0.0):
    """max |got - want| <= tol * max(floor, max |want|) (an all-zero field
    exactly when floor is 0)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(floor, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _same_sol(got, want, tol, tag=""):
    for name, val in want.items():
        _close(getattr(got, name), val, tol, f"{tag} {name}")


def _same_grid(got, want, tag):
    for name, val in want.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), val, rtol=0,
                                   atol=1e-12, err_msg=f"{tag} {name}")


@pytest.fixture(scope="module")
def rungs():
    """The port's KKT search, recording each call's rung index."""
    seen = []
    search = TOS._kkt_search

    def recording(*a, **kw):
        scale, k = search(*a, **kw)
        seen.append(k.clone())
        return scale, k

    TOS._kkt_search = recording
    yield seen
    TOS._kkt_search = search


@pytest.fixture(scope="module")
def jump(rungs):
    """The same run in both packages: the MPC's warm start at t = 0,
    `init` with INIT_ITERS updates, `update_solution` at T_SIDES (grid,
    iterate, KKT after each), then three direct updates on the last grid
    (iterates, KKT, steps; the port's with their rung indices)."""
    q0, v0 = jnp.asarray(Q_STAND), jnp.zeros(18)
    jm = _jax_mpc()
    jax_mpc_solver(jm, (jm.config_cost,))      # its warm start jitted
    jm.init(0.0, q0, v0, num_iters=0)          # plan, grid, warm start
    ref = dict(grid0=fields(jm.grid), warm=_np_fields(jm.sol),
               cost=fields(jm.config_cost), p0=jm._p_stance, p1=jm._p_land)
    ref["init_kkt"] = jm.init(0.0, q0, v0, num_iters=INIT_ITERS)
    ref["init_sol"] = _np_fields(jm.sol)
    ref["mpc"] = []
    for t in T_SIDES:
        k = jm.update_solution(t, 0.05, q0, v0, max_iter=2)
        ref["mpc"].append(dict(kkt=k, grid=fields(jm.grid),
                               sol=_np_fields(jm.sol)))
    ref["updates"], s = [], jm.sol
    for _ in range(3):
        s, kkt, a_p, _ = jm._solver.update(jm.grid, q0, v0, s,
                                           costs=(jm.config_cost,))
        ref["updates"].append((_np_fields(s), float(kkt), float(a_p)))

    p = problems.anymal_jump(device="cpu")
    mpc = p.mpc
    mpc.init(0.0, p.q0, p.v0, num_iters=0)
    port = dict(grid0=mpc.grid, warm=mpc.sol, cost=mpc.config_cost)
    port["init_kkt"] = mpc.init(0.0, p.q0, p.v0, num_iters=INIT_ITERS)
    port["init_sol"] = mpc.sol
    port["mpc"] = []
    for t in T_SIDES:
        k = mpc.update_solution(t, 0.05, p.q0, p.v0, max_iter=2)
        port["mpc"].append((k, mpc.grid, mpc.sol))
    port["updates"], s = [], mpc.sol
    for _ in range(3):
        n = len(rungs)
        s, kkt, a_p, policy = mpc._solver.update(
            mpc.grid, p.q0, p.v0, s, costs=(mpc.config_cost,))
        assert len(rungs) == n + 1      # one search, one ladder build
        port["updates"].append((s, kkt, a_p, policy, rungs[-1]))
    return ref, p, port


def test_jump_problem_matches_jax(jump):
    ref, p, port = jump
    mpc, grid = p.mpc, port["grid0"]
    assert isinstance(mpc, MPCJump) and mpc._options.enable_line_search \
        == "kkt" and mpc._solver.enable_sw and mpc.n_reserved == 1
    _same_grid(grid, ref["grid0"], "t 0")
    # stance, a flight with no contact active, the landing impact
    cm = grid.contact_mask.sum(dim=-1)
    assert float(cm[0]) == 4 and float(cm.min()) == 0
    assert float(grid.imp_mask.sum()) == 4
    for name, val in ref["cost"].items():
        if val is not None:
            np.testing.assert_allclose(
                getattr(port["cost"], name).numpy(), val, rtol=0,
                atol=1e-12, err_msg=name)
    _same_sol(port["warm"], ref["warm"], 1e-12, "warm start")


def test_planner_matches_jax(jump):
    ref, p, _ = jump
    np.testing.assert_allclose(p.mpc._p_stance, ref["p0"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(p.mpc._p_land, ref["p1"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(p.mpc._p_land[:, 0] - p.mpc._p_stance[:, 0],
                               0.1, rtol=0, atol=1e-12)
    # a turning jump from a moved configuration
    jm, tm = _jax_mpc(), MPCJump(p.model, T=0.85, N=10)
    q = np.array(Q_STAND)
    q[:3] += [0.05, -0.02, 0.01]
    for planner in (jm.planner, tm.planner):
        planner.set_jump_pattern([0.2, 0.05, 0.0], 0.3)
    want = jm.planner.plan(jnp.asarray(q))
    got = tm.planner.plan(torch.as_tensor(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_mpc_jump_init_matches_jax(jump):
    ref, _, port = jump
    _close(np.asarray(port["init_kkt"]), ref["init_kkt"], 1e-8, "init kkt",
           floor=1.0)
    _same_sol(port["init_sol"], ref["init_sol"], 1e-8, "init")


@pytest.mark.parametrize("i", [0, 1])
def test_mpc_jump_update_solution_matches_jax(jump, i):
    """update_solution from `init`'s iterate, on either side of the
    lift-off."""
    ref, p, port = jump
    k, grid, sol = port["mpc"][i]
    want = ref["mpc"][i]
    _same_grid(grid, want["grid"], f"t {T_SIDES[i]}")
    _close(np.asarray(k), want["kkt"], 1e-8, f"t {T_SIDES[i]} kkt",
           floor=1.0)
    _same_sol(sol, want["sol"], 1e-8, f"t {T_SIDES[i]}")
    # the first stage before the lift-off stands, after it flies
    assert float(grid.contact_mask[0].sum()) == (4 if i == 0 else 0)


def test_mpc_jump_control_interface(jump):
    _, p, _ = jump
    u0 = p.mpc.get_initial_control_input()
    assert u0.shape == (12,) and bool(torch.isfinite(u0).all())
    pol = p.mpc.get_control_policy(0.36)
    assert bool(torch.isfinite(pol.tauJ).all())


@pytest.mark.parametrize("i", [0, 1, 2])
def test_kkt_search_update_matches_jax(jump, i):
    ref, _, port = jump
    s, kkt, a_p, policy, _ = port["updates"][i]
    want_sol, want_kkt, want_step = ref["updates"][i]
    assert policy.Mx is not None            # the switching branch ran
    # the KKT and the step to 1e-8 of max(1, |x|)
    _close(kkt, want_kkt, 1e-8, f"update {i} kkt", floor=1.0)
    _close(a_p, want_step, 1e-8, f"update {i} step", floor=1.0)
    _same_sol(s, want_sol, 1e-8, f"update {i}")


def test_kkt_search_backtracks(jump):
    """Each of the three updates takes a rung past the full step; its
    step is at most that rung's fraction of the fraction-to-boundary
    step."""
    ks = [int(u[4]) for u in jump[2]["updates"]]
    assert min(ks) >= 1, ks
    for _, _, a_p, _, k in jump[2]["updates"]:
        assert float(a_p) <= 0.5 ** int(k) + 1e-15


def test_fleet_equals_single_updates(jump, rungs):
    """B = 2 on the t = 0.35 grid: the MPC's iterate (its update tries
    every rung and keeps the last) and the iterate the MPC reaches from
    one more `init` update through `update_solution` at 0.2 (its update
    stops at an earlier rung), against their single updates."""
    _, p, port = jump
    mpc, sv, cost = p.mpc, p.mpc._solver, (port["cost"],)
    g35, s35 = port["mpc"][1][1], port["mpc"][1][2]
    s = sv.update(port["grid0"], p.q0, p.v0, port["init_sol"],
                  costs=cost)[0]
    grid = mpc._grid(0.2)
    s = TOS.align_solution(s, port["grid0"], grid, model=p.model)
    for _ in range(2):
        s = sv.update(grid, p.q0, p.v0, s, costs=cost)[0]
    s = TOS.align_solution(s, grid, g35, model=p.model)
    singles = [port["updates"][0][:3], sv.update(g35, p.q0, p.v0, s,
                                                 costs=cost)[:3]]
    ks = [int(port["updates"][0][4]), int(rungs[-1])]
    assert ks[0] != ks[1], ks
    fleet = dataclasses.replace(s, **{
        f.name: torch.stack([getattr(x, f.name) for x in (s35, s)])
        for f in dataclasses.fields(s)})
    q0s, v0s = p.q0.expand(2, 19), p.v0.expand(2, 18)
    new, kkt, a_p, _ = sv.update(g35, q0s, v0s, fleet, costs=cost)
    assert rungs[-1].tolist() == ks
    for b, (s_1, k_1, a_1) in enumerate(singles):
        _close(kkt[b], k_1.numpy(), 1e-12, f"scenario {b} kkt", floor=1.0)
        _close(a_p[b], a_1.numpy(), 1e-12, f"scenario {b} step", floor=1.0)
        for f in dataclasses.fields(s_1):
            _close(getattr(new, f.name)[b], getattr(s_1, f.name).numpy(),
                   1e-12, f"scenario {b} {f.name}")


def test_init_with_sto_is_refused(jump):
    _, p, _ = jump
    mpc = MPCJump(p.model, T=0.85, N=10)
    with pytest.raises(NotImplementedError, match="STO"):
        mpc.init(0.0, p.q0, p.v0, sto=True)
    assert mpc.sol is None and mpc.t_lift is None

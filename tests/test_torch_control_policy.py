"""The control policy and the Raibert planner of the port against the JAX
package, f64, on the CPU, on the ANYmal pace.

  * The pace (MPCPace: lateral pairs, the base rotation through a
    ConfigurationSpaceCost on a StepConfigurationRef, so K6 runs without
    the cost fold) at N = 10, planned at t = 0.35 from standing (the first
    lift and its touchdown in the horizon), converted from the JAX
    package's problem: its grid, and one port update of a B = 2 fleet by
    the chain path against the per-stage jacfwd path, 1e-10. (The same
    update of the A1 crawl, whose stack is the pace's, is held against the
    JAX `_update` in tests/test_torch_gaits.py.)
  * ControlPolicy.from_solution on that update's solution and LQR policy,
    handed to the JAX package's ControlPolicy as numpy arrays, at times
    before the horizon, in its first stage interval, on both sides of the
    touchdown's impact slot and past its end: 1e-12, with control_input;
    a JAX ControlPolicy carried across by convert; a fleet's policy
    against its scenarios'; the MPC's get_control_policy and
    get_initial_control_input.
  * tests/test_gait_mpc.py::test_control_policy_shapes on the port.
  * The Raibert-heuristic planner over a sequence of plan calls (stance,
    swing and the step length from the averaged measured velocity)
    against the JAX planner: 1e-12.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cases import (FEET, Q_STAND, assert_close, jax_gait,
                          trot_iterate, trot_to_torch)

from robotoc_tpu.models import load_robot as jload
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.mpc import control_policy as jcp
from robotoc_tpu.mpc import foot_step_planner as jfsp
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.models import load_robot
from robotoc_tpu_torch.mpc import ControlPolicy
from robotoc_tpu_torch.mpc import foot_step_planner as tfsp
from robotoc_tpu_torch.ops import chain as chn
from robotoc_tpu_torch.solver import ocp_solver as TOS

N, B = 10, 2
POLICY = ("tauJ", "qJ", "dqJ", "Kp", "Kd")


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def case():
    jt = jax_gait("pace", N=N, t0=0.35)
    tp = trot_to_torch(jt)
    its = [trot_iterate(tp, seed=40 + b) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    rng = np.random.default_rng(3)
    q0s = np.stack([np.asarray(jrm.integrate(
        jt["model"], jt["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    return jt, tp, sol, q0s, np.zeros((B, 18))


_PORT = {}


def _port(tp, sol, q0s, v0s, use_chain=True):
    """The port's fleet update of the case by either route, computed once
    each (the tests read it, none writes it)."""
    if use_chain not in _PORT:
        _PORT[use_chain] = TOS._update(
            tp["model"], tp["contacts"], tp["limits"], 1e-3, 0.995,
            tp["costs"], convert.solution(sol, device="cpu"), tp["grid"],
            torch.as_tensor(q0s), torch.as_tensor(v0s), n_imp=tp["n_imp"],
            enable_sw=True, use_chain=use_chain)
    return _PORT[use_chain]


def test_pace_grid(case):
    _, tp, _, _, _ = case
    g = tp["grid"]
    # the right pair (RF, RH) lifts at 0.5 and lands at 0.75, when the
    # left pair (LF, LH) lifts
    assert tp["n_imp"] == 4 and float(g.imp_mask.sum()) == 2.0
    assert {tuple(r) for r in g.contact_mask.tolist()} == {
        (1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 1.0)}
    assert not chn.cost_fold_supported(tp["model"], tp["costs"],
                                       tp["contacts"])


def test_pace_chain_path_matches_jacfwd_path(case):
    _, tp, sol, q0s, v0s = case
    a = _port(tp, sol, q0s, v0s, use_chain=True)
    b = _port(tp, sol, q0s, v0s, use_chain=False)
    assert a[3].Mx is not None            # the switching branch ran
    _close_scaled(a[1].numpy(), b[1].numpy(), 1e-10, "kkt")
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu",
                 "s_cone", "z_cone", "xi"):
        _close_scaled(getattr(a[0], name).numpy(),
                      getattr(b[0], name).numpy(), 1e-10, name)


def _query_times(grid):
    """Before the horizon, inside its first stage interval, on both sides
    of the touchdown's impact slot, and past its end."""
    t = np.asarray(grid.t)
    imp = [i for i in range(len(t) - 1) if float(grid.is_impact[i]) > 0
           and float(np.asarray(grid.imp_mask[i]).sum()) > 0][0]
    return [t[0] - 0.01, t[0], t[0] + 0.3 * (t[1] - t[0]),
            t[0] + 0.9 * (t[1] - t[0]), t[imp] - 1e-3, t[imp],
            t[imp] + 1e-3, t[-1] + 0.05]


def _numpy_inputs(new, policy, b):
    """Scenario b of the port's update (solution, LQR policy) as the numpy
    objects the JAX package's ControlPolicy reads."""
    sol = SimpleNamespace(**{n: getattr(new, n)[b].numpy()
                             for n in ("u", "q", "v")})
    return sol, SimpleNamespace(K=policy.K[b].numpy())


def test_control_policy_matches_jax(case):
    jt, tp, sol, q0s, v0s = case
    new, _, _, policy = _port(tp, sol, q0s, v0s)
    rng = np.random.default_rng(5)
    for b in range(B):
        one = new.map(lambda x: x[b])
        gains = dataclasses.replace(policy, K=policy.K[b:b + 1])
        jsol, jgains = _numpy_inputs(new, policy, b)
        for t in _query_times(jt["grid"]):
            want = jcp.ControlPolicy.from_solution(jt["model"], jt["grid"],
                                                   jsol, jgains, t)
            got = ControlPolicy.from_solution(tp["model"], tp["grid"], one,
                                              gains, t)
            assert got.t == want.t
            for name in POLICY:
                assert_close(getattr(got, name).numpy(),
                             getattr(want, name), 1e-12, f"{name} at {t}")
            qm, dqm = rng.standard_normal(12), rng.standard_normal(12)
            u_want = want.control_input(qm, dqm)
            assert_close(got.control_input(qm, dqm).numpy(), u_want, 1e-12,
                         f"u at {t}")
            # the JAX policy itself, carried across
            moved = convert.control_policy(
                {"t": want.t, **{n: getattr(want, n) for n in POLICY}},
                device="cpu")
            assert_close(moved.control_input(torch.as_tensor(qm),
                                             torch.as_tensor(dqm)).numpy(),
                         u_want, 1e-12, f"carried u at {t}")


def test_control_policy_of_a_fleet(case):
    """A fleet's policy (solution and gains with a leading B) equals its
    scenarios' policies."""
    _, tp, sol, q0s, v0s = case
    new, _, _, policy = _port(tp, sol, q0s, v0s)
    for t in _query_times(tp["grid"]):
        fleet = ControlPolicy.from_solution(tp["model"], tp["grid"], new,
                                            policy, t)
        qm = torch.as_tensor(np.random.default_rng(6).standard_normal(
            (B, 12)))
        u = fleet.control_input(qm, qm)
        for b in range(B):
            one = ControlPolicy.from_solution(
                tp["model"], tp["grid"], new.map(lambda x: x[b]),
                dataclasses.replace(policy, K=policy.K[b:b + 1]), t)
            for name in POLICY:
                assert torch.equal(getattr(fleet, name)[b],
                                   getattr(one, name)), name
            assert_close(u[b].numpy(), one.control_input(qm[b], qm[b])
                         .numpy(), 1e-14)


def test_mpc_control_policy():
    """The MPC's get_control_policy is the policy of its solution and its
    last update's gains; get_initial_control_input the first torque."""
    p = problems.anymal_gait("pace", N=6, device="cpu")
    p.mpc.init(0.0, p.q0, p.v0, num_iters=1)
    mpc = p.mpc
    assert torch.equal(mpc.get_initial_control_input(), mpc.sol.u[0])
    for t in (0.0, 0.01, 0.2):
        got = mpc.get_control_policy(t)
        want = ControlPolicy.from_solution(p.model, mpc.grid, mpc.sol,
                                           mpc.lqr_policy, t)
        for name in POLICY:
            assert torch.equal(getattr(got, name), getattr(want, name))
        assert got.Kp.shape == (12, 12) and got.tauJ.shape == (12,)


def test_control_policy_shapes():
    model = load_robot("anymal", device="cpu")

    class G:
        t = torch.linspace(0, 0.5, 11, dtype=torch.float64)
        is_impact = torch.zeros(11, dtype=torch.float64)

    class S:
        u = torch.ones((11, 12), dtype=torch.float64)
        q = torch.zeros((11, 19), dtype=torch.float64)
        v = torch.zeros((11, 18), dtype=torch.float64)

    class P:
        K = torch.zeros((10, 12, 36), dtype=torch.float64)

    cp = ControlPolicy.from_solution(model, G, S, P, 0.12)
    assert cp.tauJ.shape == (12,) and cp.Kp.shape == (12, 12)
    u = cp.control_input(np.zeros(12), np.zeros(12))
    assert u.shape == (12,)


def test_raibert_planner_matches_jax():
    """The trot planner in its Raibert mode (and a crawl planner, the base
    class's mode with its own period) over a sequence of plan calls: all
    feet in stance, then each swing set, with a measured base velocity
    that changes between calls; positions, CoMs and rotations 1e-12."""
    jm, tm = jload("anymal"), load_robot("anymal", device="cpu")
    rng = np.random.default_rng(7)
    q = np.asarray(Q_STAND, float)
    for kind in ("trot", "crawl"):
        if kind == "trot":
            jp = jfsp.TrotFootStepPlanner(jm, FEET)
            tp = tfsp.TrotFootStepPlanner(tm, FEET)
            for p in (jp, tp):
                p.set_raibert_gait_pattern(np.array([0.3, 0.05, 0]), 0.2,
                                           0.25, 0.05, 0.3)
            swings = [(), (1, 2), (1, 2), (), (0, 3), (0, 3), ()]
        else:
            cycle = ((3,), (2,), (1,), (0,))
            jp = jfsp.GaitFootStepPlanner(jm, FEET, cycle)
            tp = tfsp.GaitFootStepPlanner(tm, FEET, cycle)
            for p in (jp, tp):
                p.set_raibert_gait_pattern(np.array([0.2, 0, 0]), -0.1, 1.2,
                                           0.2)
            swings = [(), (3,), (3,), (2,), (1,), (), (0,)]
        assert tp.enable_raibert and tp.enable_stance_phase == \
            jp.enable_stance_phase
        jp.init(jnp.asarray(q))
        tp.init(q)
        for k, sw in enumerate(swings):
            t = 0.05 * k
            v = np.concatenate([0.3 * rng.standard_normal(3), np.zeros(15)])
            active = [i not in sw for i in range(4)]
            want = jp.plan(t, jnp.asarray(q), v, active, 6)
            got = tp.plan(t, q, v, active, 6)
            for i, (g, w) in enumerate(zip(got, want)):
                assert_close(g, np.asarray(w), 1e-12, f"{kind} plan {k}.{i}")
            assert_close(tp.step_length, jp.step_length, 1e-12)
            assert tp.current_step == jp.current_step

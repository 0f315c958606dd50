"""The periodic gaits of the port (MPCPace, MPCCrawl, MPCFlyingTrot) against
the JAX package, f64, on the CPU.

  * The gait classes, their planners and tests/test_gait_mpc.py's
    assertions on the port: crawl cycle order, pace cycle, no contact
    active in the flying trot's flight, the crawl's base rotation through a
    ConfigurationSpaceCost with a StepConfigurationRef (and a Newton solve
    converging on it).
  * The schedules and reference arrays (`_build_schedule_and_costs`) of
    the A1 crawl, the ANYmal pace and the flying trot, as the port's
    problems build them and at tests/test_gait_mpc.py's settings, against
    the JAX MPCs planning the same way: grid times, contact and impact
    masks and every reference at every grid time, 1e-12.
  * StepConfigurationRef and ConfigurationSpaceCost with q_ref_fn (values
    and quadratization at stage, impact and terminal times): 1e-12. The
    cost fold refuses a stack with a time-varying reference in both
    packages.
  * One f64 update of a B = 2 fleet of the A1 crawl (N 10, planned at t =
    0.6 with the rear-right foot in swing: two touchdowns and a lift in the
    horizon) against the JAX `_update`, each field to 1e-8 of its largest
    magnitude; the port's chain path (K6's function without the cost fold,
    its task rows feeding the stack) against its per-stage jacfwd path,
    1e-10. The same for one f64 update of a B = 2 fleet of the ANYmal pace
    (N 10, planned at 0.35 s from standing: two feet lifting together and
    their touchdown in the horizon, the stack not folded).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (A1_FEET, A1_Q0, Q_STAND, assert_close, fields,
                          jax_fleet, jax_gait, jit_unoptimised, np_tree,
                          trot_iterate, trot_to_torch)

from robotoc_tpu.costs import config_cost as jcc
from robotoc_tpu.models import load_robot as jload
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.mpc import gait_mpc as jgm
from robotoc_tpu.mpc import refs as jrefs
from robotoc_tpu.ops import pallas_chain as pch
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.costs import config_cost as tcc
from robotoc_tpu_torch.models import load_robot
from robotoc_tpu_torch.mpc import gait_mpc as tgm
from robotoc_tpu_torch.mpc import refs as trefs
from robotoc_tpu_torch.ops import chain as chn
from robotoc_tpu_torch.solver import ocp_solver as TOS

B = 2


@pytest.fixture(scope="module")
def anymal():
    return load_robot("anymal", device="cpu")


def test_gait_classes_and_planners(anymal):
    assert tgm.MPCPace.CYCLE == jgm.MPCPace.CYCLE == ((2, 3), (0, 1))
    assert tgm.MPCCrawl.CYCLE == jgm.MPCCrawl.CYCLE == ((3,), (2,), (1,),
                                                       (0,))
    assert tgm.MPCFlyingTrot.CYCLE == jgm.MPCFlyingTrot.CYCLE
    for cls in ("MPCPace", "MPCCrawl", "MPCFlyingTrot", "MPCBipedWalk"):
        assert (getattr(tgm, cls).BASE_ROT_VIA_CONFIG_REF
                == getattr(jgm, cls).BASE_ROT_VIA_CONFIG_REF)
    for name, cls in (("pace", tgm.MPCPace), ("crawl", tgm.MPCCrawl),
                      ("flying_trot", tgm.MPCFlyingTrot)):
        planner = getattr(tgm, f"{name}_foot_step_planner")(anymal)
        assert planner.cycle == cls.CYCLE
    assert tgm.MPCPace(anymal, T=0.5, N=10).CYCLE == ((2, 3), (0, 1))


def test_crawl_cycle_order(anymal):
    mpc = tgm.MPCCrawl(anymal, T=0.5, N=10)
    planner = mpc.make_planner()
    assert planner.cycle == ((3,), (2,), (1,), (0,))
    planner.set_gait_pattern(np.array([0.1, 0, 0]), 0.0)
    planner.init(np.asarray(Q_STAND))
    positions, coms, _ = planner.plan(0.0, Q_STAND, np.zeros(18),
                                      [True] * 4, 8)
    # one foot moves per step, in the order RH(3), RF(2), LH(1)
    moved = [list(np.where(np.abs(positions[k + 1] - positions[k]).sum(1)
                           > 1e-12)[0]) for k in (1, 2, 3)]
    assert moved == [[3], [2], [1]]
    # the CoM advances a quarter step per crawl step (steady state)
    assert np.isclose(coms[3][0] - coms[2][0], 0.025, atol=1e-9)


def test_schedule_building_flying_trot(anymal):
    mpc = tgm.MPCFlyingTrot(anymal, T=0.6, N=12)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.2, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.15,
                         flying_time=0.06, swing_start_time=0.2)
    mpc.planner.init(np.asarray(Q_STAND))
    grid, _ = mpc._build_schedule_and_costs(
        0.0, torch.tensor(Q_STAND, dtype=torch.float64),
        torch.zeros(18, dtype=torch.float64))
    t, cm = grid.t.numpy(), grid.contact_mask.numpy()
    # during flight (t ~ 0.38) no contact is active
    assert cm[int(np.argmin(np.abs(t - 0.38)))].sum() == 0
    # pair B = (1, 2) swings first: pair A = (0, 3) stands at t ~ 0.3
    i_st = int(np.argmin(np.abs(t - 0.3)))
    assert cm[i_st][0] == 1 and cm[i_st][3] == 1 and cm[i_st].sum() == 2


def test_crawl_mpc_periodic_config_ref(anymal):
    """The crawl tracks its base rotation through a ConfigurationSpaceCost
    with a time-varying StepConfigurationRef, and Newton updates on it
    converge."""
    mpc = tgm.MPCCrawl(anymal, T=0.5, N=10)
    assert mpc.BASE_ROT_VIA_CONFIG_REF
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.04, 0, 0]), 0.0)
    mpc.set_gait_pattern(planner, swing_height=0.05, swing_time=0.2,
                         stance_time=0.0, swing_start_time=0.3)
    kkt = mpc.init(0.0, Q_STAND, np.zeros(18), num_iters=12)
    refs = [c for c in mpc._costs
            if isinstance(c, tcc.ConfigurationSpaceCost)
            and c.q_ref_fn is not None]
    assert len(refs) == 1
    assert isinstance(refs[0].q_ref_fn, trefs.StepConfigurationRef)
    assert np.isfinite(kkt) and kkt < 1e-2


# ---- schedules and references against the JAX MPCs --------------------

def _jax_test_gait_mpc(name):
    """The JAX MPC of `name` at tests/test_gait_mpc.py's settings (ANYmal,
    swing start 0.2 s; the flying trot at its own test's), and the port's
    built the same way."""
    cls, kw = {"pace": ("MPCPace", dict(stance_time=0.0)),
               "crawl": ("MPCCrawl", dict(stance_time=0.0)),
               "flying_trot": ("MPCFlyingTrot", dict(flying_time=0.06))}[name]
    T, N, swing = (0.6, 12, 0.15) if name == "flying_trot" else (0.5, 10,
                                                                 0.25)
    out = []
    for mod, m in ((jgm, jload("anymal")),
                   (tgm, load_robot("anymal", device="cpu"))):
        mpc = getattr(mod, cls)(m, T=T, N=N)
        planner = mpc.make_planner()
        planner.set_gait_pattern(np.array([0.15, 0, 0]), 0.0)
        mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=swing,
                             swing_start_time=0.2, **kw)
        mpc.planner.init(np.asarray(Q_STAND))
        out.append(mpc)
    return out


def _jax_problem_mpc(name):
    """The JAX MPC of the port's problem `name` (problems.a1_crawl,
    problems.anymal_gait) and the port's."""
    jt = jax_gait(name, N=10, t0=0.0)
    tp = (problems.a1_crawl(N=10, device="cpu") if name == "crawl" else
          problems.anymal_gait(name, N=10, device="cpu", t0=0.0))
    return jt["mpc"], tp.mpc


def _refs_at(costs, ts, jax_side):
    """Every reference of a gait stack at the times ts, as numpy: the
    configuration references, the base-rotation reference, the feet and
    CoM references with their activities."""
    out = []
    for c in costs:
        if hasattr(c, "q_ref_fn"):
            if c.q_ref_fn is not None:
                out.append(np_tree(jax.vmap(c.q_ref_fn)(ts)) if jax_side
                           else c.q_ref_fn(torch.as_tensor(ts)).numpy())
        elif hasattr(c, "ref"):
            out.append(np_tree(jax.vmap(lambda t: c.ref(t)[0])(ts))
                       if jax_side else c.ref(torch.as_tensor(ts))[0]
                       .numpy())
        else:
            ref = (np_tree(jax.vmap(lambda t: c._ref_active(
                t, jnp.float64))(ts)) if jax_side
                else [x.numpy() for x in c._ref_active(torch.as_tensor(ts))])
            out.extend(ref)
    return out


@pytest.mark.parametrize("case", [
    ("pace", _jax_test_gait_mpc), ("crawl", _jax_test_gait_mpc),
    ("flying_trot", _jax_test_gait_mpc), ("crawl", _jax_problem_mpc),
    ("pace", _jax_problem_mpc), ("flying_trot", _jax_problem_mpc)],
    ids=["pace", "crawl", "flying_trot", "a1_crawl_problem", "pace_problem",
         "flying_trot_problem"])
def test_schedule_and_refs_match_jax(case):
    """The grid and every reference at every grid time (and on a fine time
    grid), planned at several times in turn from standing, the planner's
    state carried between them as the MPC carries it."""
    name, make = case
    jmpc, tmpc = make(name)
    q0 = np.asarray(A1_Q0 if name == "crawl" and make is _jax_problem_mpc
                    else Q_STAND, float)
    jq = jnp.asarray(q0)
    tq = torch.as_tensor(q0)
    jmpc.config_cost = jmpc.config_cost.replace(q_ref=jq)
    tmpc.config_cost = dataclasses.replace(tmpc.config_cost, q_ref=tq)
    assert tmpc.n_reserved == jmpc.n_reserved and tmpc.K == jmpc.K
    for t0 in (0.0, 0.35, 0.6, 0.78):
        jgrid, jcosts = jmpc._build_schedule_and_costs(
            t0, jq, jnp.zeros(jq.shape[0] - 1))
        tgrid, tcosts = tmpc._build_schedule_and_costs(
            t0, tq, torch.zeros(tq.shape[0] - 1, dtype=torch.float64))
        for fname, val in vars(jgrid).items():
            assert_close(getattr(tgrid, fname).numpy(), np.asarray(val),
                         1e-12, f"t0 {t0} grid.{fname}")
        ts = np.concatenate([np.asarray(jgrid.t),
                             np.linspace(t0 - 0.1, t0 + 0.7, 33)])
        want = _refs_at(jcosts, ts, True)
        got = _refs_at(tcosts, ts, False)
        assert len(got) == len(want) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, 1e-12, f"t0 {t0} reference {i}")
        assert [type(c).__name__ for c in tcosts] == [
            type(c).__name__ for c in jcosts]


# ---- StepConfigurationRef and the configuration cost with q_ref_fn ----

def _seeded_config_ref(seed=3, K=5):
    """Field dict of a StepConfigurationRef: ANYmal's standing q, K + 1 yaw
    quaternions (a slerp that turns both ways), sorted swing starts, one
    slot invalid."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(0.3 * rng.standard_normal(K + 1))
    quat = np.stack([np.zeros(K + 1), np.zeros(K + 1), np.sin(0.5 * yaw),
                     np.cos(0.5 * yaw)], axis=1)
    quat[2] = -quat[2]                # the shortest-arc sign correction
    valid = np.ones(K)
    valid[-1] = 0.0
    return dict(q=np.asarray(Q_STAND, float), quat_steps=quat,
                t_start=np.sort(0.2 + rng.uniform(0, 1.0, K)),
                swing_time=np.asarray(0.25), valid=valid)


def test_step_configuration_ref_matches_jax():
    f = _seeded_config_ref()
    jref = jrefs.StepConfigurationRef(**{k: jnp.asarray(v)
                                         for k, v in f.items()})
    tref = convert.step_configuration_ref(f, device="cpu")
    ts = np.linspace(0.0, 1.6, 81)
    want = np.asarray(jit_unoptimised(jax.vmap(jref))(ts))
    assert_close(tref(torch.as_tensor(ts)).numpy(), want, 1e-12, "q_ref(t)")
    # a 0-dim time (one stage under vmap) gives one configuration
    assert_close(tref(torch.tensor(0.6, dtype=torch.float64)).numpy(),
                 np.asarray(jref(0.6)), 1e-12, "q_ref(0.6)")


def _config_costs(mod, model, ref, weights):
    """A configuration cost of package `mod` (config_cost module) on the
    time-varying reference `ref` with q weights `weights` (stage;
    terminal and impact twice and three times them)."""
    return mod.make_config_cost(
        model, q_ref_fn=ref, q_weight=weights, v_weight=0.5, a_weight=0.01,
        u_weight=0.1, q_weight_terminal=2 * weights, v_weight_terminal=0.2,
        q_weight_impact=3 * weights, v_weight_impact=0.3,
        dv_weight_impact=0.01)


def _config_cost_quads(cost, model, q, v, a, u, dv, t):
    """The stage (dt 0.02), impact and terminal quadratizations of a
    configuration cost at one state and time."""
    return (cost.quadratize_stage(model, 12, q, v, a, u, None, t, 0.02),
            cost.quadratize_impact(model, q, v, dv, t),
            cost.quadratize_terminal(model, q, v, t))


def _config_cost_evals(cost, model, q, v, a, u, dv, t):
    """The same terms' values alone (what the line search evaluates)."""
    return (cost.eval_stage(model, q, v, a, u, None, t, 0.02),
            cost.eval_impact(model, q, v, dv, t),
            cost.eval_terminal(model, q, v, t))


_COST_TERMS = {}


def _cost_terms(anymal):
    """The JAX package's and the port's (stage, impact, terminal) terms
    for the gait stacks' base-rotation weights (the base-rotation rows
    only) and seeded dense weights, at states and times in and between
    swing windows; computed once (one JAX compile, the weights an
    argument)."""
    if _COST_TERMS:
        return _COST_TERMS
    f = _seeded_config_ref()
    jm = jload("anymal")
    rng = np.random.default_rng(4)
    qs = np.asarray(jax.vmap(lambda d: jrm.integrate(
        jm, jnp.asarray(Q_STAND), d))(0.2 * rng.standard_normal((4, 18))))
    v, a, dv = (rng.standard_normal((4, 18)) for _ in range(3))
    args = (qs, v, a, rng.standard_normal((4, 12)), dv,
            np.array([0.0, 0.45, 0.71, 1.3]))
    w_rot = np.zeros(18)
    w_rot[3:6] = 1000.0
    jref = jrefs.StepConfigurationRef(**{k: jnp.asarray(x)
                                         for k, x in f.items()})
    tref = convert.step_configuration_ref(f, device="cpu")

    @jit_unoptimised
    def jax_quads(w, *a):
        jc = _config_costs(jcc, jm, jref, w)
        return jax.vmap(lambda *x: _config_cost_quads(jc, jm, *x))(*a)

    for i, w in enumerate((w_rot, 0.1 + rng.uniform(size=18))):
        tc = _config_costs(tcc, anymal, tref, torch.as_tensor(w))
        targs = [torch.as_tensor(x) for x in args]
        _COST_TERMS[i] = (
            np_tree(jax_quads(jnp.asarray(w), *args)),
            torch.func.vmap(lambda *x: _config_cost_quads(tc, anymal, *x))(
                *targs),
            torch.func.vmap(lambda *x: _config_cost_evals(tc, anymal, *x))(
                *targs))
    return _COST_TERMS


@pytest.mark.parametrize("kind", ["stage", "impact", "terminal"])
def test_config_cost_with_q_ref_fn_matches_jax(anymal, kind):
    """The configuration cost on a StepConfigurationRef: its Gauss-Newton
    blocks at the stage, impact and terminal times, and its value alone
    (the eval_* functions) against the quadratization's cost."""
    k = ("stage", "impact", "terminal").index(kind)
    for i, (want, got, vals) in _cost_terms(anymal).items():
        for j, (g, w) in enumerate(zip(got[k], want[k])):
            assert_close(g.numpy(), w, 1e-12, f"{kind} weights {i} block {j}")
        assert_close(vals[k].numpy(), want[k][0], 1e-12,
                     f"{kind} weights {i} value")


def test_cost_fold_refuses_a_time_varying_reference():
    """K6's cost fold reads one constant q_ref: the pace's and crawl's
    stacks (a second configuration cost with q_ref_fn) and a trot stack
    whose configuration cost has a q_ref_fn are refused by both
    packages' predicates; the trot's and flying trot's stacks fold."""
    for name, folds in (("pace", False), ("flying_trot", True)):
        jt = jax_gait(name, N=4)
        tp = trot_to_torch(jt)
        assert pch.cost_fold_supported(jt["model"], jt["costs"],
                                       jt["contacts"]) is folds
        assert chn.cost_fold_supported(tp["model"], tp["costs"],
                                       tp["contacts"]) is folds
        if folds:
            cfg, br, task = tp["costs"]
            ref = convert.step_configuration_ref(_seeded_config_ref(),
                                                 device="cpu")
            moved = (dataclasses.replace(cfg, q_ref_fn=ref), br, task)
            assert not chn.cost_fold_supported(tp["model"], moved,
                                               tp["contacts"])
            jcfg, jbr, jtask = jt["costs"]
            jmoved = (jcfg.replace(q_ref_fn=jrefs.StepConfigurationRef(
                **{k: jnp.asarray(v) for k, v in
                   _seeded_config_ref().items()})), jbr, jtask)
            assert not pch.cost_fold_supported(jt["model"], jmoved,
                                               jt["contacts"])


# ---- one update of the A1 crawl against the JAX package --------------

def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def crawl():
    jt = jax_gait("crawl", N=10, t0=0.6)
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
    if use_chain not in _PORT:
        _PORT[use_chain] = TOS._update(
            tp["model"], tp["contacts"], tp["limits"], 1e-3, 0.995,
            tp["costs"], convert.solution(sol, device="cpu"), tp["grid"],
            torch.as_tensor(q0s), torch.as_tensor(v0s), n_imp=tp["n_imp"],
            enable_sw=True, use_chain=use_chain)
    return _PORT[use_chain]


def test_a1_crawl_grid(crawl):
    _, tp, _, _, _ = crawl
    g, contacts = tp["grid"], tp["contacts"]
    assert tuple(contacts.frame_ids) == tuple(
        tp["model"].frame_id(f) for f in A1_FEET)
    assert tp["n_imp"] == 4 and int(g.is_impact.sum()) == 4
    # RR in swing at 0.6; it lands at 0.75, FR lifts at 0.8 and lands at
    # 1.05: two touchdowns of one foot each
    assert float(g.imp_mask.sum()) == 2.0
    assert g.contact_mask[0].tolist() == [1.0, 1.0, 1.0, 0.0]
    assert not chn.cost_fold_supported(tp["model"], tp["costs"], contacts)


def _jax_update(jt, tp, sol, q0s, v0s):
    """The JAX `_update` of a gait problem (XLA path) on each scenario of
    a fleet, compiled once without backend optimisation."""
    def upd(s, q, v):
        new, kkt, a_p, _ = JOS._update(
            jt["model"], jt["contacts"], jt["limits"], 1e-3, 0.995,
            tp["n_imp"], jt["costs"], s, jt["grid"], q, v, enable_sw=True,
            use_pallas=False, use_chain=False)
        return new, kkt, a_p

    return jax_fleet(jit_unoptimised(upd), sol, q0s, v0s)


def test_a1_crawl_update_matches_jax_f64(crawl):
    jt, tp, sol, q0s, v0s = crawl
    ref_sol, ref_kkt, ref_ap = _jax_update(jt, tp, sol, q0s, v0s)
    new, kkt, a_p, policy = _port(tp, sol, q0s, v0s, use_chain=True)
    assert policy.Mx is not None          # the switching branch ran
    _close_scaled(kkt.numpy(), ref_kkt, 1e-8, "kkt")
    _close_scaled(a_p.numpy(), ref_ap, 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        _close_scaled(getattr(new, name).numpy(), val, 1e-8, name)


def test_a1_crawl_chain_path_matches_jacfwd_path(crawl):
    _, tp, sol, q0s, v0s = crawl
    a = _port(tp, sol, q0s, v0s, use_chain=True)
    b = _port(tp, sol, q0s, v0s, use_chain=False)
    _close_scaled(a[1].numpy(), b[1].numpy(), 1e-10, "kkt")
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu",
                 "s_cone", "z_cone", "xi"):
        _close_scaled(getattr(a[0], name).numpy(),
                      getattr(b[0], name).numpy(), 1e-10, name)


# ---- one update of the ANYmal pace against the JAX package -------------

@pytest.fixture(scope="module")
def pace():
    jt = jax_gait("pace", N=10, t0=0.35)
    tp = trot_to_torch(jt)
    its = [trot_iterate(tp, seed=30 + b) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    rng = np.random.default_rng(2)
    q0s = np.stack([np.asarray(jrm.integrate(
        jt["model"], jt["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    return jt, tp, sol, q0s, np.zeros((B, 18))


def test_pace_update_matches_jax_f64(pace):
    jt, tp, sol, q0s, v0s = pace
    g = tp["grid"]
    # two feet lift together and touch down together in the horizon; the
    # stack (a second configuration cost on a time-varying reference) does
    # not fold
    assert float(g.imp_mask.sum()) == 2.0 and int(g.is_impact.sum()) >= 1
    assert float(g.contact_mask.sum(dim=-1).min()) == 2.0
    assert not chn.cost_fold_supported(tp["model"], tp["costs"],
                                       tp["contacts"])
    ref_sol, ref_kkt, ref_ap = _jax_update(jt, tp, sol, q0s, v0s)
    new, kkt, a_p, policy = TOS._update(
        tp["model"], tp["contacts"], tp["limits"], 1e-3, 0.995,
        tp["costs"], convert.solution(sol, device="cpu"), tp["grid"],
        torch.as_tensor(q0s), torch.as_tensor(v0s), n_imp=tp["n_imp"],
        enable_sw=True, use_chain=True)
    assert policy.Mx is not None          # the switching branch ran
    _close_scaled(kkt.numpy(), ref_kkt, 1e-8, "kkt")
    _close_scaled(a_p.numpy(), ref_ap, 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        _close_scaled(getattr(new, name).numpy(), val, 1e-8, name)

"""The iCub lower half on surface contacts: the port's modules against the
JAX package, f64, on `icub_lower_half`.

  * the description (dims, chain levels, FK, RNEA, CRBA);
  * the surface paths of models/contacts (Baumgarte residual with R_ref,
    the fused impact derivatives, the post-impact spatial velocity; the
    fused stage derivatives through K6's plain version in
    tests/test_torch_chain.py), the wrench cone, the switching
    constraint's 6-row log6 placement rows, the impact stage on 6-D
    impulses;
  * the contact schedule with rotations, the biped foot-step planner and
    MPCBipedWalk._build_schedule_and_costs (grid and cost references);
all at 1e-10 relative to each output's largest magnitude (at least one),
on numpy-seeded states. And the cases of tests/test_biped.py run through
the port, with the standing OCP (problems.icub_standing) held to the gate
that test sets the JAX package: KKT < 1e-6 after 12 updates."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (close_tree, deep_fields, icub_q0, jax_walk,
                          jit_unoptimised, np_tree, rodrigues, trot_iterate,
                          trot_to_torch)

from robotoc_tpu.constraints import friction_cone as jfc
from robotoc_tpu.dynamics import switching_constraint as jswc
from robotoc_tpu.models import contacts as jct
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.ocp import impact_stage as jistage
from robotoc_tpu.planner import contact_sequence as jcs
from robotoc_tpu_torch import problems
from robotoc_tpu_torch.constraints import friction_cone as tfc
from robotoc_tpu_torch.dynamics import switching_constraint as tswc
from robotoc_tpu_torch.models import contacts as tct
from robotoc_tpu_torch.models import load_robot
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.ocp import impact_stage as tistage
from robotoc_tpu_torch.planner import contact_sequence as tcs
from robotoc_tpu_torch.solver import ocp_solver as TOS

TOL = 1e-10


def T(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def case():
    jw = jax_walk(6)
    return jw, trot_to_torch(jw)


def icub_states(n, seed):
    """n iCub states around the bent-knee stance, numpy: q (moved in the
    tangent space), v, a, 6-D wrenches of the two soles."""
    m = load_robot("icub_lower_half", device="cpu")
    rng = np.random.default_rng(seed)
    q0 = T(problems.icub_walk_q0(m)).expand(n, 19)
    q = trm.integrate(m, q0, T(0.2 * rng.standard_normal((n, 18)))).numpy()
    return (q, rng.standard_normal((n, 18)), rng.standard_normal((n, 18)),
            30.0 * rng.standard_normal((n, 12)))


# ---------------------------------------------------------------------------
# 1. the description
# ---------------------------------------------------------------------------

def test_description_matches_jax(case):
    jw, tp = case
    jm, tm = jw["model"], load_robot("icub_lower_half", device="cpu")
    assert (tm.nq, tm.nv, tm.nj, tm.dimu) == (19, 18, 13, 12)
    assert (jm.nq, jm.nv, jm.nj, jm.dimu) == (tm.nq, tm.nv, tm.nj, tm.dimu)
    assert tuple(jrm.chain_levels(jm)) == tuple(trm.chain_levels(tm))
    assert trm.chain_levels(tm) == ((0, (0,)),) + tuple(
        (1, (i, i + 6)) for i in range(1, 7))
    q, v, a, _ = icub_states(3, 1)
    wants = np_tree(jit_unoptimised(jax.vmap(lambda q, v, a: (
        jrm.forward_kinematics(jm, q), jrm.rnea(jm, q, v, a),
        jrm.crba(jm, q))))(q, v, a))
    for i in range(3):
        want = jax.tree.map(lambda x: x[i], wants)
        got = (trm.forward_kinematics(tm, T(q[i])),
               trm.rnea(tm, T(q[i]), T(v[i]), T(a[i])),
               trm.crba(tm, T(q[i])))
        close_tree(got, want, TOL, name="fk/rnea/crba")


# ---------------------------------------------------------------------------
# 2. contacts: surface paths
# ---------------------------------------------------------------------------

def test_surface_contact_functions(case):
    jw, tp = case
    jm, jc, tm, tc = jw["model"], jw["contacts"], tp["model"], tp["contacts"]
    q, v, a, f = icub_states(3, 2)
    fric = np.full((3, 2), 0.6)
    p_ref = 0.1 * np.random.default_rng(3).standard_normal((3, 2, 3))
    R_ref = rodrigues(0.1 * np.random.default_rng(4).standard_normal(
        (3, 2, 3)))
    want = np_tree(jit_unoptimised(jax.vmap(lambda *x: jct.baumgarte_residual(
        jm, jc, *x)))(q, v, a, p_ref, R_ref))
    got = torch.func.vmap(lambda *x: tct.baumgarte_residual(tm, tc, *x))(
        *map(T, (q, v, a, p_ref, R_ref)))
    close_tree([got], [want], TOL, name="baumgarte_residual")
    # the stage derivatives (fused_stage_derivatives) are held against JAX
    # through K6's plain version in tests/test_torch_chain.py
    args = (q, a, v, f, fric)
    want = np_tree(jit_unoptimised(jax.vmap(
        lambda *x: jct.fused_impact_derivatives(
        jm, jc, *x, with_task=True)))(*args))
    got = torch.func.vmap(lambda *x: tct.fused_impact_derivatives(
        tm, tc, *x, with_task=True))(*map(T, args))
    close_tree(got, want, TOL, name="fused_impact_derivatives")
    want = np_tree(jit_unoptimised(jax.vmap(
        lambda *x: jct.impact_velocity_residual(
        jm, jc, *x)))(q, v))
    got = torch.func.vmap(lambda *x: tct.impact_velocity_residual(
        tm, tc, *x))(T(q), T(v))
    close_tree([got], [want], TOL, name="impact_velocity_residual")


def test_surface_baumgarte_zero_at_rest_and_position_gain(case):
    """tests/test_biped.py's Baumgarte cases through the port."""
    _, tp = case
    m, c = tp["model"], tp["contacts"]
    q0 = T(problems.icub_walk_q0(m))
    Rw, pw = trm.forward_kinematics(m, q0)
    plc = [trm.frame_placement(m, fid, Rw, pw) for fid in c.frame_ids]
    p_ref = torch.stack([p for _, p in plc])
    R_ref = torch.stack([R for R, _ in plc])
    z = torch.zeros(18, dtype=torch.float64)
    r = tct.baumgarte_residual(m, c, q0, z, z, p_ref, R_ref)
    assert r.shape == (12,)
    assert float(r.abs().max()) < 1e-9
    shift = p_ref + T([0.01, 0.0, 0.0])
    r = tct.baumgarte_residual(m, c, q0, z, z, shift, R_ref).reshape(2, 6)
    for k in range(2):
        expect = float(c.kp[k]) * (R_ref[k].T @ (p_ref[k] - shift[k]))
        assert torch.allclose(r[k, :3], expect, rtol=1e-6)
        assert float(r[k, 3:].abs().max()) < 1e-9


# ---------------------------------------------------------------------------
# 3. the wrench cone
# ---------------------------------------------------------------------------

def test_wrench_cone(case):
    jw, tp = case
    jm, jc, tm, tc = jw["model"], jw["contacts"], tp["model"], tp["contacts"]
    mu, X, Y = np.array([0.5, 0.7]), np.array([0.05, 0.1]), np.array(
        [0.025, 0.05])
    close_tree([tfc.wrench_cone_matrix(T(mu), T(X), T(Y))],
               [np.stack([np.asarray(jfc.wrench_cone_matrix(
                   mu[k], X[k], Y[k], jnp.float64)) for k in range(2)])],
               TOL, name="wrench_cone_matrix")
    q = T(problems.icub_walk_q0(tm))
    # tests/test_biped.py: a pure normal force lies inside the cone, which
    # has no configuration dependence; a CoP outside the sole does not
    f = torch.zeros(12, dtype=torch.float64)
    f[2] = f[8] = 100.0
    g, dgdf, dgdq = tfc.residual_and_jac(tm, tc, q, f, T([0.7, 0.7]))
    assert g.shape == (34,) and dgdf.shape == (34, 12)
    assert dgdq.shape == (34, 18)
    assert bool((g < 0).all()) and float(dgdq.abs().max()) == 0.0
    f_bad = f.clone()
    f_bad[4] = 100.0 * 0.2
    assert float(tfc.residual_and_jac(tm, tc, q, f_bad, T([0.7, 0.7]))[0]
                 .max()) > 0
    _, _, _, fs = icub_states(2, 5)
    want = np_tree(jit_unoptimised(jax.vmap(lambda f: jfc.residual_and_jac(
        jm, jc, jnp.asarray(q.numpy()), f, jnp.asarray([0.6, 0.5]))))(fs))
    for i in range(2):
        got = tfc.residual_and_jac(tm, tc, q, T(fs[i]), T([0.6, 0.5]))
        close_tree(got, [w[i] for w in want], TOL, name="residual_and_jac")


# ---------------------------------------------------------------------------
# 4. switching constraint, 5. impact stage
# ---------------------------------------------------------------------------

def test_switching_constraint_surface_rows(case):
    jw, tp = case
    q, v, a, _ = icub_states(2, 6)
    R = rodrigues(0.05 * np.random.default_rng(8).standard_normal((2, 3)))
    p = 0.1 * np.random.default_rng(9).standard_normal((2, 3))
    for mask in (np.array([0.0, 1.0]), np.array([1.0, 1.0])):
        args = (q[0], v[0], a[0], 0.028, 0.028, p, R, mask)
        want = np_tree(jit_unoptimised(lambda *x: jswc.residual_and_jacs(
            jw["model"], jw["contacts"], *x))(*args))
        got = tswc.residual_and_jacs(tp["model"], tp["contacts"],
                                     *map(T, args))
        assert got[0].shape == (12,)
        assert float(got[0][:6].abs().max()) == 0.0 or mask[0] == 1.0
        close_tree(got, want, TOL, name="residual_and_jacs")


def test_impact_stage_surface(case):
    """stage_pre of the walk's impact slots (one touchdown of a sole with a
    6-D impulse, the rest pass-throughs)."""
    jw, tp = case
    f = trot_iterate(tp, seed=4)
    g = {k: np.array(v) for k, v in vars(jw["grid"]).items()}
    idx = np.nonzero(g["is_impact"][:-1])[0]
    assert g["imp_mask"][idx].sum() == 1.0
    pick = lambda x: x[idx]                                # noqa: E731
    args = (pick(g["t"][:-1]), pick(g["dt"]), np.full(len(idx), 1e-3),
            *[pick(f[k][:-1]) for k in ("q", "v", "a", "u", "f", "beta",
                                        "mu", "lmd", "gmm")],
            pick(f["lmd"][1:]), pick(f["gmm"][1:]), pick(f["q"][1:]),
            pick(f["v"][1:]), *[pick(f[k]) for k in ("s_lim", "z_lim",
                                                    "s_cone", "z_cone")],
            pick(g["imp_mask"][:-1]), pick(g["p_ref"][:-1]),
            pick(g["friction"][:-1]))
    want = np_tree(jit_unoptimised(jax.vmap(lambda *a: jistage.stage_pre(
        jw["model"], jw["contacts"], jw["costs"], jw["limits"], *a)))(*args))
    got = torch.func.vmap(lambda *a: tistage.stage_pre(
        tp["model"], tp["contacts"], tp["costs"], tp["limits"], *a))(
        *map(T, args))
    assert set(got) == set(want)
    for k in want:
        close_tree([got[k].numpy()], [want[k]], TOL, name=k)


# ---------------------------------------------------------------------------
# 6. schedule and planner, 7. MPCBipedWalk
# ---------------------------------------------------------------------------

def test_schedule_with_rotations(case):
    R = rodrigues(0.1 * np.random.default_rng(10).standard_normal((3, 2,
                                                                     3)))
    p = np.random.default_rng(11).standard_normal((3, 2, 3))
    grids = []
    for mod, kw in ((jcs, dict(use_native=False)), (tcs, dict(device="cpu"))):
        s = mod.ContactSchedule(nc=2).init([True, True], p[0], rotations=R[0])
        s.push_back([True, False], p[1], 0.3, rotations=R[1])
        s.push_back([False, True], p[2], 0.55, rotations=R[2])
        grids.append(mod.discretize(s, 0.0, 0.7, 6, n_reserved=3, **kw))
    for f in dataclasses.fields(grids[1]):
        close_tree([getattr(grids[1], f.name).numpy()],
                   [np.asarray(getattr(grids[0], f.name))], TOL, name=f.name)


def test_biped_planner_and_walk_schedule(case):
    """MPCBipedWalk at t = 0.62 (one sole in swing, a touchdown and a lift
    in the horizon): planner output, grid and every cost reference."""
    jw, tp = case
    pw = problems.icub_walk(N=6, device="cpu", t0=0.62)
    assert pw.mpc.CYCLE == jw["mpc"].CYCLE == ((1,), (0,))
    assert pw.mpc.n_reserved == jw["mpc"].n_reserved == 3
    assert pw.mpc.contacts.types == jw["contacts"].types == (6, 6)
    close_tree([pw.mpc.contacts.rect.numpy()],
               [np.asarray(jw["contacts"].rect)], 0.0, name="rect")
    for f in dataclasses.fields(pw.grid):
        close_tree([getattr(pw.grid, f.name).numpy()],
                   [np.asarray(getattr(jw["grid"], f.name))], TOL,
                   name=f.name)
    g = pw.grid
    assert float(g.imp_mask.sum()) == 1.0
    assert float((g.R_ref - torch.eye(3, dtype=g.R_ref.dtype)).abs().max()
                 ) == 0.0
    for jc, tc in zip(jw["costs"], pw.costs):
        close_tree(_leaves(deep_fields(tc)), _leaves(deep_fields(jc)), TOL,
                   name=type(tc).__name__)
    q = icub_q0(jw["model"])
    for t, active in ((0.62, [True, False]), (1.3, [False, True])):
        want = jw["mpc"].planner.plan(t, jnp.asarray(q), jnp.zeros(18),
                                      active, jw["mpc"].K)
        got = pw.mpc.planner.plan(t, q, np.zeros(18), active, pw.mpc.K)
        close_tree(got, [np.asarray(x) for x in want], TOL, name="plan")


def _leaves(d):
    """Tensor/array leaves of a nested field dict, in key order."""
    out = []
    for k in sorted(d):
        v = d[k]
        if isinstance(v, dict):
            out += _leaves(v)
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            out.append(np.asarray(v.numpy() if isinstance(v, torch.Tensor)
                                  else v))
    return out


# ---------------------------------------------------------------------------
# tests/test_biped.py's standing OCP through the port
# ---------------------------------------------------------------------------

def test_biped_standing_ocp_converges():
    p = problems.icub_standing(N=4, device="cpu")
    assert p.contacts.max_dimf == 12 and p.contacts.cone_dims == (17, 17)
    assert p.contacts.dimc_cone == 34
    assert p.contacts.force_mask(T([1.0, 0.0])).tolist() == [1.0] * 6 + [
        0.0] * 6
    s = TOS.OCPSolver(p.model, p.contacts, (p.cost,), p.limits, T=p.T,
                      N=p.N)
    sol = s.init_solution(p.grid, p.q0, p.v0)
    for _ in range(12):
        sol, _, _, _ = s.update(p.grid, p.q0, p.v0, sol)
    kkt = float(s.kkt_error(p.grid, p.q0, p.v0, sol))
    assert np.isfinite(kkt) and kkt < 1e-6
    # the weight is carried: world-frame vertical forces sum to m g
    R = p.grid.R_ref[0]
    fz = torch.stack([(R[0] @ sol.f[k, 0:3])[2] + (R[1] @ sol.f[k, 6:9])[2]
                      for k in range(p.N)])
    mg = float(p.model.total_mass) * 9.81
    assert torch.allclose(fz, torch.full_like(fz, mg), rtol=0.05)

"""The ANYmal bounce (examples/anymal_bounce.py, one cycle) on the port
against the JAX package, f64, on the CPU: the first offline multi-event
OCP with a two-cost stack that K6 does not fold.

  * One `_update` with the KKT-residual search at a seeded iterate against
    the JAX `_update` (XLA path) compiled once without backend
    optimisation: the KKT, the step size and every Solution field to 1e-8
    of max(1, |x|).
  * K6's host build (csrc/host_shim.cpp, g++, no cost fold) against
    `chain_plain` on the update's own inputs at every stage slot, 1e-12.
  * `problems.anymal_bounce(cycles=1)` against the JAX objects built as
    the example builds them (without calling `main`): the contact
    schedule, the grid (N 35, two reserved impact slots, both touchdowns
    in them), the configuration cost and the task cost with its stacked
    references, 1e-12.
  * The four PeriodicSwingFootRef stacked in one reference and the
    PeriodicCoMRef inside MultiFrameTaskCost at every grid time (the
    stage, impact and terminal slots), and the task cost's stage, impact
    and terminal quadratizations at those slots on one state, 1e-12.

Every test shares one build of the bounce in each package.
"""
import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (Q_STAND, close_tree, deep_fields, fields,
                          host_chain, jax_bounce, jit_unoptimised,
                          trot_iterate)

from robotoc_tpu_torch import convert, kernels, problems
from robotoc_tpu_torch.ops import chain as chn
from robotoc_tpu_torch.solver import ocp_solver as TOS


@pytest.fixture(scope="module")
def case():
    """The bounce's objects in both packages: JAX built by the example's
    own lines, the port's by problems.anymal_bounce."""
    return jax_bounce(), problems.anymal_bounce(cycles=1, device="cpu")


@pytest.fixture(scope="module")
def update(case):
    """One KKT-search update of the bounce at a seeded iterate, in both
    packages."""
    from robotoc_tpu.solver import ocp_solver as JOS
    jb, p = case
    tp = dict(model=p.model, contacts=p.contacts, limits=p.limits,
              grid=p.grid, q0=p.q0, v0=p.v0)
    it = trot_iterate(tp, seed=5)

    def upd(s, q, v):
        new, kkt, a_p, _ = JOS._update(
            jb["model"], jb["contacts"], jb["limits"], 1e-3, 0.995,
            jb["n_imp"], jb["costs"], s, jb["grid"], q, v, enable_ls="kkt",
            enable_sw=False, use_pallas=False, use_chain=False)
        return new, kkt, a_p

    js = JOS.Solution(**{k: jnp.asarray(v) for k, v in it.items()})
    want = jax.tree.map(np.asarray, jit_unoptimised(upd)(js, jb["q0"],
                                                        jb["v0"]))
    got = TOS._update(p.model, p.contacts, p.limits, 1e-3, 0.995, p.costs,
                      convert.solution(it, device="cpu"), p.grid, p.q0,
                      p.v0, n_imp=2, enable_sw=False, use_chain=True,
                      enable_ls="kkt")
    return it, want, got


def test_kkt_search_update_matches_jax(update):
    _, (ref_sol, ref_kkt, ref_ap), (new, kkt, a_p, _) = update
    close_tree([kkt.numpy()], [ref_kkt], 1e-8, "kkt")
    close_tree([a_p.numpy()], [ref_ap], 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        close_tree([getattr(new, name).numpy()], [val], 1e-8, name)
    assert np.isfinite(float(kkt)) and 0.0 < float(a_p) <= 1.0


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = kernels.host_library()
    lib.rtt_host_chain.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 \
        + [ctypes.c_longlong]
    lib.rtt_host_chain.restype = ctypes.c_int
    return lib


def test_k6_host_build_on_the_bounce_slots(case, update, host):
    """K6 without the fold on the update's chain inputs at every stage
    slot (stance, the swings of either pair, and the impact slots)."""
    _, p = case
    it = update[0]
    s = convert.solution(it, device="cpu")
    g = p.grid
    rowmask = p.contacts.force_mask(g.contact_mask[:-1])
    ins = [x.contiguous() for x in (
        s.q[:-1], s.v[:-1], s.a[:-1], s.f[:-1] * rowmask, g.friction[:-1],
        g.p_ref[:-1], g.R_ref[:-1])]
    assert float(g.contact_mask[:-1].sum(dim=-1).min()) == 2.0
    want = chn.chain_plain(p.model, p.contacts, *ins)
    got = host_chain(host, p.model, p.contacts, ins,
                     {n: tuple(v.shape) for n, v in want.items()})
    close_tree([got[n].numpy() for n in want],
               [want[n].numpy() for n in want], 1e-12, "K6")


# ---- the bounce's problem (examples/anymal_bounce.py, one cycle) ---------

def _same_fields(got, want, tol, tag):
    """Field dicts (nested for references) equal to tol, absolute."""
    for name, val in want.items():
        g = got[name]
        if isinstance(val, dict):
            _same_fields(g, val, tol, f"{tag}.{name}")
        elif isinstance(val, np.ndarray):
            np.testing.assert_allclose(np.asarray(g), val, rtol=0, atol=tol,
                                       err_msg=f"{tag}.{name}")
        else:
            assert g == val, f"{tag}.{name}"


def _torch_fields(obj):
    """deep_fields for the port's dataclasses (tensors as numpy)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _torch_fields(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.numpy()
        else:
            out[f.name] = v
    return out


def test_bounce_problem_matches_jax(case):
    jb, p = case
    assert (p.T, p.N) == (jb["T"], jb["N"]) and p.N == 35
    assert p.solver.n_reserved_events == jb["n_imp"] == 2
    assert p.solver.options.enable_line_search == "kkt" and \
        p.solver.options.kkt_tol == 1e-6
    assert not p.solver.enable_sw
    # the schedule: phase by phase
    assert len(p.schedule.phases) == len(jb["schedule"].phases) == 5
    for a, b in zip(p.schedule.phases, jb["schedule"].phases):
        assert a.start_time == b.start_time
        np.testing.assert_array_equal(a.active, b.active)
        np.testing.assert_allclose(a.placements, b.placements, rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(a.friction, b.friction)
    # the grid: both touchdowns in the reserved impact slots
    _same_fields({k: getattr(p.grid, k).numpy() for k in
                  fields(jb["grid"])}, fields(jb["grid"]), 1e-12, "grid")
    assert float(p.grid.imp_mask.sum()) == 4.0
    assert int(p.grid.is_impact.sum()) == 2
    # the two costs, references included; the stack does not fold
    for got, want in zip(p.costs, jb["costs"]):
        _same_fields(_torch_fields(got), deep_fields(want), 1e-12,
                     type(want).__name__)
    assert p.costs[1].foot_refs.p0.shape == (4, 3)
    assert not chn.cost_fold_supported(p.model, p.costs, p.contacts)
    # convert carries the JAX task cost across to the same object
    conv = convert.multi_frame_task_cost(deep_fields(jb["costs"][1]),
                                         device="cpu")
    _same_fields(_torch_fields(conv), deep_fields(jb["costs"][1]), 0.0,
                 "converted")


def test_stacked_references_match_jax(case):
    """The task cost's references at every grid time, and its stage,
    impact and terminal quadratizations at one slot of each kind."""
    jb, p = case
    jtask, ttask = jb["costs"][1], p.costs[1]
    jm = jb["model"]
    ts = np.asarray(jb["grid"].t)
    is_imp = np.asarray(jb["grid"].is_impact) > 0
    stage = int(np.nonzero(~is_imp[:-1])[0][12])
    impact = int(np.nonzero(is_imp)[0][0])
    rng = np.random.default_rng(4)
    q = np.asarray(Q_STAND) + np.concatenate(
        [0.02 * rng.standard_normal(3), np.zeros(4),
         0.05 * rng.standard_normal(12)])
    v, dv = rng.standard_normal(18), rng.standard_normal(18)
    args = [jnp.asarray(x) for x in (q, v, dv)]

    @jit_unoptimised
    def jfn(ts_, q_, v_, dv_):
        refs = jax.vmap(lambda t: jtask._ref_active(t, jm.dtype))(ts_)
        qs = jtask.quadratize_stage(jm, 12, q_, v_, v_, v_[6:], v_[6:],
                                    ts_[stage], 0.02)
        qi = jtask.quadratize_impact(jm, q_, v_, dv_, ts_[impact])
        qt = jtask.quadratize_terminal(jm, q_, v_, ts_[-1])
        return refs, qs, qi, qt

    want = jfn(jnp.asarray(ts), *args)
    tt = torch.as_tensor(ts)
    qt_, vt_, dvt_ = [torch.as_tensor(x) for x in (q, v, dv)]
    got = (ttask._ref_active(tt),
           ttask.quadratize_stage(p.model, 12, qt_, vt_, vt_, vt_[6:],
                                  vt_[6:], tt[stage], 0.02),
           ttask.quadratize_impact(p.model, qt_, vt_, dvt_, tt[impact]),
           ttask.quadratize_terminal(p.model, qt_, vt_, tt[-1]))
    close_tree([x.numpy() for x in got[0]],
               [np.asarray(x) for x in want[0]], 1e-12, "refs")
    # the references move: feet swing and the CoM advances over the grid
    act = got[0][1].numpy()
    assert act[:, :12].max() == 1.0 and act[:, :12].min() == 0.0
    for name, g, w in zip(("stage", "impact", "terminal"), got[1:],
                          want[1:]):
        close_tree([x.numpy() for x in g], [np.asarray(x) for x in w],
                   1e-12, name)

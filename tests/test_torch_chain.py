"""The chain kernel K6's plain version and its host build (ops/chain.py,
csrc/chain_stage.cuh) against the JAX package.

Inputs: the stage slots of the mid-gait ANYmal trot at N = 10 (point
contacts) and of the mid-gait iCub walk at N = 6 (surface contacts), impact
slots included, as the solver feeds them, at iterates moved off the warm
start by numpy-seeded noise. Both variants: without the cost fold (the
standing stacks) and with it (the gait stacks).
  * chain_plain against the XLA oracles: fused_stage_derivatives
    (with_task), quadratize_stage of the stack and state_equation, 1e-9
    relative to each output's magnitude (at least one);
  * chain_plain against pallas_chain.make_chain(interpret=True): 1e-6, the
    interpret-mode floor of the Pallas kernel's polynomial acos;
  * the g++ build of K6's arithmetic against chain_plain: 1e-12.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (jax_trot, jax_walk, rodrigues, trot_iterate,
                          trot_to_torch)

from robotoc_tpu.costs import base as jcost_base
from robotoc_tpu.models import contacts as jct
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.ops import pallas_chain as pch
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert, kernels
from robotoc_tpu_torch.models.contacts import POINT, SURFACE, make_contacts
from robotoc_tpu_torch.ops import chain as chn
from robotoc_tpu_torch.solver import ocp_solver as TOS

NAMES = {False: chn._OUTS, True: chn._OUTS + chn._COST_OUTS}


def _case(jt, seed, scale):
    tp = trot_to_torch(jt)
    f = trot_iterate(tp, seed=seed, scale=scale)
    g = {k: np.array(v) for k, v in vars(jt["grid"]).items()}
    rowmask = np.repeat(g["contact_mask"][:-1], tp["contacts"].types,
                        axis=-1)
    ins = (f["q"][:-1], f["v"][:-1], f["a"][:-1], f["f"][:-1] * rowmask,
           g["friction"][:-1], g["p_ref"][:-1], g["R_ref"][:-1])
    # the cost-fold inputs, port side (a fleet of one) and JAX side
    sol_t = convert.solution(f, device="cpu").map(lambda x: x.unsqueeze(0))
    grid_t = TOS._fleet(sol_t, tp["grid"], tp["q0"][None], tp["v0"][None])[1]
    cost_t = chn.cost_fold_inputs(tp["model"], tp["contacts"], tp["costs"],
                                  grid_t, sol_t)
    cost_j = jax.jit(lambda s: pch.cost_fold_inputs(
        jt["model"], jt["contacts"], jt["costs"], jt["grid"], s))(
        JOS.Solution(**{k: jnp.asarray(v) for k, v in f.items()}))
    return dict(jt=jt, tp=tp, f=f, g=g, ins=ins, cost_t=cost_t,
                cost_j=cost_j)


@pytest.fixture(scope="module")
def case():
    return _case(jax_trot(10), seed=11, scale=0.1)


@pytest.fixture(scope="module")
def surface_case():
    """The walk's stage slots (two soles, 6-D wrenches; one sole in swing,
    a touchdown in the horizon), R_ref moved off the identity so that the
    SE(3)-log residual sees a rotation."""
    c = _case(jax_walk(6), seed=12, scale=0.1)
    w = 0.1 * np.random.default_rng(13).standard_normal(
        c["ins"][6].shape[:-1])
    c["ins"] = c["ins"][:6] + (rodrigues(w),)
    return c


def _plain(case, with_cost):
    tp = case["tp"]
    ins = [torch.as_tensor(x) for x in case["ins"]]
    cost = case["cost_t"] if with_cost else ()
    return chn.chain_plain(tp["model"], tp["contacts"], *ins, *cost)


def _close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol} * {scale:.3e}"


def test_cost_fold_inputs_match_jax(case):
    for i, (t, j) in enumerate(zip(case["cost_t"], case["cost_j"])):
        _close(t.numpy(), np.asarray(j), 1e-14, f"cost input {i}")


def _xla_oracles(case):
    """The XLA oracles' outputs, cost fold included, computed once per
    case: both variants of chain_plain are held against them."""
    if "xla" in case:
        return case["xla"]
    jt, g, f = case["jt"], case["g"], case["f"]
    m, contacts = jt["model"], jt["contacts"]

    def one(q, v, a, fe, fr, pr, R, u, t, dt, qn):
        res = jct.fused_stage_derivatives(m, contacts, q, v, a, fe, fr, pr,
                                          R, with_task=True)
        ((tau, C, gc, dgdf), (dtq, dtv, M), (dCq, dCv, J), dgdq) = res[:4]
        out = dict(tau=tau, dtau_dq=dtq, dtau_dv=dtv, M=M, C=C, dCdq=dCq,
                   dCdv=dCv, J=J, g=gc, dgdq=dgdq, dgdf=dgdf, task=res[4][0],
                   dtask=res[4][1])
        quad = jcost_base.quadratize_stage(jt["costs"], m,
                                           contacts.max_dimf, q, v, a, u,
                                           None, t, dt)
        r = jrm.difference(m, q, qn) - dt * v
        J1 = jrm.d_difference_dq1(m, q, qn)
        J0 = jrm.d_difference_dq0(m, q, qn)
        J1inv = jnp.linalg.inv(J1[:6, :6])
        Cinv = jnp.eye(m.nv, dtype=q.dtype).at[:6, :6].set(J1inv)
        out.update(cq_cost=quad.cost[None], cq_lq=quad.lq, cq_lv=quad.lv,
                   cq_la=quad.la, cq_lu=quad.lu, cq_Wq=quad.Qqq,
                   se_Aqq6=(-Cinv @ J0)[:6, :6], se_J1binv=J1inv,
                   se_xres=-(Cinv @ r))
        return out

    case["xla"] = jax.jit(jax.vmap(one))(*case["ins"], f["u"][:-1],
                                         g["t"][:-1], g["dt"], f["q"][1:])
    return case["xla"]


def _check_xla_oracles(case, with_cost):
    ref = _xla_oracles(case)
    got = _plain(case, with_cost)
    for name in NAMES[with_cost]:
        _close(got[name].numpy(), ref[name], 1e-9, name)


def _check_pallas_interpret(case, with_cost):
    """chain_plain against the Pallas kernel in interpret mode, run once
    per case with the cost fold (its other outputs are the no-fold
    variant's)."""
    if "pallas" not in case:
        jt = case["jt"]
        fn = pch.make_chain(jt["model"], jt["contacts"], interpret=True,
                            with_cost=True)
        case["pallas"] = jax.jit(fn)(*case["ins"], *case["cost_j"])
    ref = case["pallas"]
    got = _plain(case, with_cost)
    for name in NAMES[with_cost]:
        _close(got[name].numpy(), ref[name], 1e-6, name)


def _check_host_build(case, host, with_cost):
    tp = case["tp"]
    ins = [torch.as_tensor(x).contiguous() for x in case["ins"]]
    ins += [c.contiguous() for c in case["cost_t"]] if with_cost else []
    want = _plain(case, with_cost)
    names = NAMES[with_cost]
    got = {n: torch.full(want[n].shape, float("nan"), dtype=torch.float64)
           for n in names}
    consts, topo = chn.model_tables(tp["model"], tp["contacts"],
                                    torch.float64, "cpu")
    P = ctypes.c_void_p
    rc = host.rtt_host_chain(
        int(with_cost), tp["contacts"].n_contacts, tp["contacts"].types[0],
        P(consts.data_ptr()), P(topo.data_ptr()),
        (P * len(ins))(*[t.data_ptr() for t in ins]),
        (P * len(names))(*[got[n].data_ptr() for n in names]),
        ins[0].shape[0])
    assert rc == 0
    for name in names:
        _close(got[name].numpy(), want[name].numpy(), 1e-12, name)


def _check_op_count(case):
    """K6's operation count (csrc/chain_flops.cpp, the roofline bound's
    numerator): additive over stages, larger with the cost fold, below
    what charging every tangent column the stage's value arithmetic would
    give, and below the count of the kernel's own arithmetic."""
    tp = case["tp"]
    ins = [torch.as_tensor(x) for x in case["ins"]]
    counts = {}
    for with_cost in (False, True):
        cost = case["cost_t"] if with_cost else ()
        val, tan = chn.op_count(tp["model"], tp["contacts"], *ins, *cost)
        h = ins[0].shape[0] // 2
        parts = [chn.op_count(tp["model"], tp["contacts"],
                              *[x[sl] for x in ins + list(cost)])
                 for sl in (slice(0, h), slice(h, None))]
        assert (val, tan) == tuple(map(sum, zip(*parts)))
        assert 0 < val < tan < 3 * 18 * val
        written = chn.op_count(tp["model"], tp["contacts"], *ins, *cost,
                               as_written=True)
        assert written[0] >= 3 * 18 * val and written[1] > tan
        counts[with_cost] = val + tan
    assert counts[True] > counts[False]


@pytest.mark.parametrize("with_cost", [False, True])
def test_chain_plain_matches_xla_oracles(case, with_cost):
    _check_xla_oracles(case, with_cost)


@pytest.mark.parametrize("with_cost", [False, True])
def test_chain_plain_matches_pallas_interpret(case, with_cost):
    _check_pallas_interpret(case, with_cost)


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = kernels.host_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtt_host_chain.argtypes = [I, I, I, P, P, P, P, ctypes.c_longlong]
    lib.rtt_host_chain.restype = I
    return lib


@pytest.mark.parametrize("with_cost", [False, True])
def test_host_build_matches_chain_plain(case, host, with_cost):
    _check_host_build(case, host, with_cost)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not "
                    "installed")
def test_op_count_charges_values_once(case):
    _check_op_count(case)


# ---- surface contacts (the iCub soles) --------------------------------

def test_surface_cost_fold_inputs_match_jax(surface_case):
    test_cost_fold_inputs_match_jax(surface_case)


@pytest.mark.parametrize("with_cost", [False, True])
def test_surface_chain_plain_matches_xla_oracles(surface_case, with_cost):
    _check_xla_oracles(surface_case, with_cost)


@pytest.mark.parametrize("with_cost", [False, True])
def test_surface_chain_plain_matches_pallas_interpret(surface_case,
                                                      with_cost):
    _check_pallas_interpret(surface_case, with_cost)


@pytest.mark.parametrize("with_cost", [False, True])
def test_surface_host_build_matches_chain_plain(surface_case, host,
                                                with_cost):
    _check_host_build(surface_case, host, with_cost)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not "
                    "installed")
def test_op_count_surface(surface_case):
    _check_op_count(surface_case)


def test_use_chain_needs_the_kernels(case):
    """use_chain runs K6 through `chain`; with the kernels switched off
    there is no route for it, and the solver refuses the combination."""
    tp = case["tp"]
    with pytest.raises(ValueError):
        TOS.OCPSolver(tp["model"], tp["contacts"], tp["costs"], tp["limits"],
                      T=0.5, N=10, options=TOS.SolverOptions(
                          use_kernels=False, use_chain=True))
    assert not TOS.OCPSolver(
        tp["model"], tp["contacts"], tp["costs"], tp["limits"], T=0.5, N=10,
        options=TOS.SolverOptions(use_kernels=False)).use_chain


def test_chain_refuses_mixed_stacks(case):
    """K6 takes stacks of one contact type: a mixed point/surface stack
    raises in the wrapper (on any device), the plain version and the
    operation count; uniform stacks of either type are supported."""
    tp = case["tp"]
    m = tp["model"]
    mixed = make_contacts(m, ["LF_FOOT", "RF_FOOT"], types=(POINT, SURFACE))
    surf = make_contacts(m, ["LF_FOOT", "RF_FOOT"], types=(SURFACE, SURFACE))
    z = torch.zeros(2, 19, dtype=torch.float64)
    args = (z, z[:, :18], z[:, :18], torch.zeros(2, 9, dtype=z.dtype),
            torch.ones(2, 2, dtype=z.dtype),
            torch.zeros(2, 2, 3, dtype=z.dtype))
    assert not chn.chain_supported(m, mixed)
    assert chn.chain_supported(m, surf) and chn.chain_supported(
        m, tp["contacts"])
    for fn in (chn.chain, chn.chain_plain, chn.op_count):
        with pytest.raises(NotImplementedError):
            fn(m, mixed, *args)

"""The flying trot (MPCFlyingTrot) on the port against the JAX package, f64,
on the CPU: the first path with stage slots where no contact is active.

The ANYmal flying trot of problems.anymal_gait (step 0.15 m, swing 0.20
s, a 0.06 s flight between steps) at N = 12, planned at t = 0.35 from
standing: the first swing, the flight (every contact inactive) and the
touchdown after it in the horizon, the gait stack folded into K6. A fleet
of B = 2 scenarios, each at its own numpy-seeded iterate off the warm
start and with its own perturbed initial state:
  * one port `_update` against the JAX `_update(use_pallas=False,
    use_chain=False, enable_sw=True)` on each scenario, the KKT, step size
    and every Solution field to 1e-8 of the field's largest magnitude; the
    port's chain path against its per-stage jacfwd path, 1e-10;
  * at the flight slots, the host builds of the kernels (csrc/host_shim.cpp,
    g++) on the update's own inputs against their plain versions, 1e-12:
    K6 with the cost fold (Baumgarte and cone rows under a zero contact
    mask), K1's contact-space inverse with every contact row inactive, Kc
    with every cone row masked.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from _torch_cases import (fields, host_chain, jax_fleet, jax_gait,
                          jit_unoptimised, trot_iterate, trot_to_torch)

from robotoc_tpu.models import robot as jrm
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert, kernels
from robotoc_tpu_torch.ops import chain as chn
from robotoc_tpu_torch.ops import condense as cd
from robotoc_tpu_torch.solver import ocp_solver as TOS

N, B = 12, 2


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def case():
    jt = jax_gait("flying_trot", N=N, t0=0.35)
    tp = trot_to_torch(jt)
    its = [trot_iterate(tp, seed=30 + b) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    rng = np.random.default_rng(2)
    q0s = np.stack([np.asarray(jrm.integrate(
        jt["model"], jt["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    return jt, tp, sol, q0s, np.zeros((B, 18))


def _flight_slots(tp):
    """Stage slots of the grid where no contact is active, and not an
    impact slot."""
    g = tp["grid"]
    cm, imp = g.contact_mask[:-1], g.is_impact[:-1]
    return [i for i in range(cm.shape[0])
            if float(cm[i].sum()) == 0 and float(imp[i]) == 0]


_PORT = {}


def _port(tp, sol, q0s, v0s, use_chain):
    if use_chain not in _PORT:
        _PORT[use_chain] = TOS._update(
            tp["model"], tp["contacts"], tp["limits"], 1e-3, 0.995,
            tp["costs"], convert.solution(sol, device="cpu"), tp["grid"],
            torch.as_tensor(q0s), torch.as_tensor(v0s), n_imp=tp["n_imp"],
            enable_sw=True, use_chain=use_chain)
    return _PORT[use_chain]


def test_flying_trot_grid_has_flight_then_touchdown(case):
    _, tp, _, _, _ = case
    g = tp["grid"]
    flight = _flight_slots(tp)
    assert len(flight) >= 1
    t = g.t.numpy()
    assert all(0.7 - 1e-9 <= t[i] <= 0.76 + 1e-9 for i in flight)
    # the touchdown after the flight: an impact slot at 0.76 landing the
    # swing pair (LH, RF)
    imp = [i for i in range(g.n_slots - 1)
           if float(g.is_impact[i]) > 0 and float(g.imp_mask[i].sum()) > 0]
    assert len(imp) == 1 and abs(t[imp[0]] - 0.76) < 1e-9
    assert g.imp_mask[imp[0]].tolist() == [0.0, 1.0, 1.0, 0.0]
    assert imp[0] > max(flight)
    assert chn.cost_fold_supported(tp["model"], tp["costs"], tp["contacts"])


def test_flying_trot_update_matches_jax_f64(case):
    jt, tp, sol, q0s, v0s = case

    def upd(s, q, v):
        new, kkt, a_p, _ = JOS._update(
            jt["model"], jt["contacts"], jt["limits"], 1e-3, 0.995,
            tp["n_imp"], jt["costs"], s, jt["grid"], q, v, enable_sw=True,
            use_pallas=False, use_chain=False)
        return new, kkt, a_p

    ref_sol, ref_kkt, ref_ap = jax_fleet(jit_unoptimised(upd), sol, q0s,
                                         v0s)
    new, kkt, a_p, policy = _port(tp, sol, q0s, v0s, use_chain=True)
    assert policy.Mx is not None          # the switching branch ran
    _close_scaled(kkt.numpy(), ref_kkt, 1e-8, "kkt")
    _close_scaled(a_p.numpy(), ref_ap, 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        _close_scaled(getattr(new, name).numpy(), val, 1e-8, name)


def test_flying_trot_chain_path_matches_jacfwd_path(case):
    _, tp, sol, q0s, v0s = case
    a = _port(tp, sol, q0s, v0s, use_chain=True)
    b = _port(tp, sol, q0s, v0s, use_chain=False)
    _close_scaled(a[1].numpy(), b[1].numpy(), 1e-10, "kkt")
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu",
                 "s_cone", "z_cone", "xi"):
        _close_scaled(getattr(a[0], name).numpy(),
                      getattr(b[0], name).numpy(), 1e-10, name)


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = kernels.host_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtt_host_k1.argtypes = [ctypes.c_longlong] + [P] * 12
    lib.rtt_host_kc.argtypes = [I, ctypes.c_longlong] + [P] * 6
    lib.rtt_host_chain.argtypes = [I, I, I, I, P, P, P, P, ctypes.c_longlong]
    for name in ("k1", "kc", "chain"):
        getattr(lib, f"rtt_host_{name}").restype = I
    return lib


def _flight_inputs(case):
    """The update's K6 inputs (with the cost fold) and condense inputs at
    the flight slots of both scenarios."""
    _, tp, sol, q0s, v0s = case
    s_b, g_b, _, _, _ = TOS._fleet(convert.solution(sol, device="cpu"),
                                   tp["grid"], torch.as_tensor(q0s),
                                   torch.as_tensor(v0s))
    S1 = g_b.dt.shape[1]
    idx = torch.tensor([b * S1 + i for b in range(B)
                        for i in _flight_slots(tp)])
    rowmask = tp["contacts"].force_mask(g_b.contact_mask[:, :-1])
    chain_in = [TOS._flat(x)[idx].contiguous() for x in (
        s_b.q[:, :-1], s_b.v[:, :-1], s_b.a[:, :-1],
        s_b.f[:, :-1] * rowmask, g_b.friction[:, :-1], g_b.p_ref[:, :-1],
        g_b.R_ref[:, :-1])]
    cost_in = [x[idx].contiguous() for x in chn.cost_fold_inputs(
        tp["model"], tp["contacts"], tp["costs"], g_b, s_b)]
    pre = TOS.stage_pre_all(tp["model"], tp["contacts"], tp["limits"], 1e-3,
                            tp["costs"], s_b, g_b, n_imp=tp["n_imp"],
                            use_chain=True)
    return chain_in, cost_in, {k: pre[k][idx].contiguous()
                               for k in cd.IN_NAMES}


def test_host_builds_at_flight_slots(case, host):
    _, tp, _, _, _ = case
    chain_in, cost_in, x = _flight_inputs(case)
    S = x["M"].shape[0]
    assert S >= 2 and float(x["inactive"].min()) == 1.0   # no row active
    assert float(x["d_cone"].abs().max()) == 0.0          # no cone row
    want = chn.chain_plain(tp["model"], tp["contacts"], *chain_in, *cost_in)
    got = host_chain(host, tp["model"], tp["contacts"], chain_in + cost_in,
                     {n: tuple(v.shape) for n, v in want.items()})
    for n in want:
        _close_scaled(got[n].numpy(), want[n].numpy(), 1e-12, f"K6 {n}")

    def run(fn, ins, shapes, *lead):
        outs = [torch.full((S,) + sh, float("nan"), dtype=torch.float64)
                for sh in shapes]
        assert fn(*lead, S, *[ctypes.c_void_p(t.data_ptr())
                              for t in ins + outs]) == 0
        return outs

    nv, nf, nu = 18, 12, 12
    k1_in = [x[n] for n in ("M", "J", "inactive", "Tw1", "Tw2", "r1", "e2")]
    k1 = run(host.rtt_host_k1, k1_in, ((nv, nv), (nv, nf), (nf, nf),
                                       (nv + nf, 2 * nv + nu), (nv + nf,)))
    for name, g, w in zip(("inv11", "inv12", "Sinv", "G", "c0"), k1,
                          cd.k1_plain(*k1_in)):
        _close_scaled(g.numpy(), w.numpy(), 1e-12, f"K1 {name}")
    kc_in = [x["dgdq"], x["dgdf"], x["d_cone"]]
    kc = run(host.rtt_host_kc, kc_in, ((nv, nv), (nv, nf), (nf, nf)),
             x["dgdq"].shape[1])
    for g, w in zip(kc, cd.kc_plain(*kc_in)):
        _close_scaled(g.numpy(), w.numpy(), 1e-12, "Kc")
        assert float(w.abs().max()) == 0.0

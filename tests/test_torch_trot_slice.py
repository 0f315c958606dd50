"""The port's trot MPC update end to end against the JAX package.

The mid-gait ANYmal trot at N = 10 (4 impact slots, switching
constraints, the gait cost stack) for a fleet of B = 2 scenarios, each at
its own numpy-seeded iterate off the warm start (switching multipliers
included) and with its own perturbed initial state: one port `_update`
(fleet dim written out) against the JAX `_update(use_pallas=False,
use_chain=False, enable_sw=True)` vmapped over the fleet, the KKT, step
size and every Solution field to 1e-8 relative to each field's largest
magnitude (at least one), as tests/test_torch_ocp_slice.py holds the
standing update. The port's chain path (ops/chain, its plain version on
the CPU) against its per-stage jacfwd path: 1e-10. And the MPC layer
(MPCTrot.init, update_solution) runs on the port's own problem."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (fields, jax_trot, np_tree, trot_iterate,
                          trot_to_torch)

from robotoc_tpu.models import robot as jrm
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert, problems
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
    tp = trot_to_torch(jt)
    its = [trot_iterate(tp, seed=20 + b) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    rng = np.random.default_rng(1)
    q0s = np.stack([np.asarray(jrm.integrate(
        jt["model"], jt["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    return jt, tp, sol, q0s, np.zeros((B, 18))


def _port(tp, sol, q0s, v0s, use_chain):
    return TOS._update(tp["model"], tp["contacts"], tp["limits"], 1e-3,
                       0.995, tp["costs"], convert.solution(sol, device="cpu"),
                       tp["grid"], torch.as_tensor(q0s), torch.as_tensor(v0s),
                       n_imp=tp["n_imp"], enable_sw=True, use_chain=use_chain)


def test_trot_update_matches_jax_f64(case):
    jt, tp, sol, q0s, v0s = case

    def upd(s, q, v):
        new, kkt, a_p, _ = JOS._update(
            jt["model"], jt["contacts"], jt["limits"], 1e-3, 0.995,
            tp["n_imp"], jt["costs"], s, jt["grid"], q, v, enable_sw=True,
            use_pallas=False, use_chain=False)
        return new, kkt, a_p

    js = JOS.Solution(**{k: jnp.asarray(v) for k, v in sol.items()})
    ref_sol, ref_kkt, ref_ap = np_tree(jax.jit(jax.vmap(upd))(
        js, jnp.asarray(q0s), jnp.asarray(v0s)))
    new, kkt, a_p, policy = _port(tp, sol, q0s, v0s, use_chain=True)
    assert policy.Mx is not None          # the switching branch ran
    _close_scaled(kkt.numpy(), ref_kkt, 1e-8, "kkt")
    _close_scaled(a_p.numpy(), ref_ap, 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        _close_scaled(getattr(new, name).numpy(), val, 1e-8, name)


def test_chain_path_matches_jacfwd_path(case):
    _, tp, sol, q0s, v0s = case
    a = _port(tp, sol, q0s, v0s, use_chain=True)
    b = _port(tp, sol, q0s, v0s, use_chain=False)
    _close_scaled(a[1].numpy(), b[1].numpy(), 1e-10, "kkt")
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu",
                 "s_cone", "z_cone", "xi"):
        _close_scaled(getattr(a[0], name).numpy(),
                      getattr(b[0], name).numpy(), 1e-10, name)


def test_mpc_trot_init_and_update():
    """MPCTrot on the port's own problem: a few initial Newton updates at
    t = 0.35, then one MPC update 0.025 s later (re-planned grid, aligned
    warm start, two updates); the KKT shrinks and stays finite."""
    p = problems.anymal_trot(N=N, device="cpu")
    kkt0 = p.mpc.init(0.35, p.q0, p.v0, num_iters=4)
    kkt1 = p.mpc.update_solution(0.375, 0.025, p.q0, p.v0)
    assert np.isfinite(kkt0) and np.isfinite(kkt1)
    assert kkt0 < 1e2
    assert p.mpc.sol.q.shape == (p.grid.n_slots, 19)
    assert p.mpc.kkt_error(0.375, p.q0, p.v0) > 0.0

"""The port's biped-walk MPC update end to end against the JAX package.

The iCub lower-half walk (MPCBipedWalk, two surface contacts with 17-row
wrench cones) at N = 4, planned at t = 0.62 with one sole in swing: a
touchdown with a 6-D impulse, a lift, 3 impact slots and the switching
rows of the touchdown. A fleet of B = 2 scenarios, each at its own
numpy-seeded iterate near the warm start (switching multipliers included)
and with its own perturbed initial state: one port `_update` (fleet dim
written out) against the JAX `_update(use_pallas=False, use_chain=False,
enable_sw=True)` on each scenario, the KKT, step size and every
Solution field to 1e-8 relative to each field's largest magnitude (at
least one), as tests/test_torch_trot_slice.py holds the trot. The port's
chain path (ops/chain: K6's function with its surface branch and the cost
fold, its plain version on the CPU) against its per-stage jacfwd path:
1e-10.

The iterate stays within 1e-3 of the warm start: this single-support
problem is ill-conditioned away from it (from a cold mid-gait iterate
moved by 0.05, a 1e-15 relative change of the inputs moves the f64
update by up to 3e-8 of a field's magnitude, in the port as in the JAX
package), and the comparison would measure that rounding, not the port.
"""
import numpy as np
import pytest
import torch

from _torch_cases import (fields, jax_fleet, jax_walk, jit_unoptimised,
                          trot_iterate, trot_to_torch)

from robotoc_tpu.models import robot as jrm
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert
from robotoc_tpu_torch.solver import ocp_solver as TOS

N, B = 4, 2


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def case():
    jw = jax_walk(N)
    tp = trot_to_torch(jw)
    its = [trot_iterate(tp, seed=20 + b, scale=1e-3) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    rng = np.random.default_rng(1)
    q0s = np.stack([np.asarray(jrm.integrate(
        jw["model"], jw["q0"], 0.01 * rng.standard_normal(18)))
        for _ in range(B)])
    return jw, tp, sol, q0s, np.zeros((B, 18))


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


def test_walk_grid_has_a_touchdown_and_switching_rows(case):
    jw, tp, _, _, _ = case
    g = tp["grid"]
    assert tp["n_imp"] == 3 and int(g.is_impact.sum()) == 3
    assert float(g.imp_mask.sum()) == 1.0          # one sole lands
    assert tp["contacts"].types == (6, 6)
    assert tp["contacts"].dimc_cone == 34


def test_walk_update_matches_jax_f64(case):
    jw, tp, sol, q0s, v0s = case

    def upd(s, q, v):
        new, kkt, a_p, _ = JOS._update(
            jw["model"], jw["contacts"], jw["limits"], 1e-3, 0.995,
            tp["n_imp"], jw["costs"], s, jw["grid"], q, v, enable_sw=True,
            use_pallas=False, use_chain=False)
        return new, kkt, a_p

    ref_sol, ref_kkt, ref_ap = jax_fleet(jit_unoptimised(upd), sol, q0s, v0s)
    new, kkt, a_p, policy = _port(tp, sol, q0s, v0s, use_chain=True)
    assert policy.Mx is not None          # the switching branch ran
    _close_scaled(kkt.numpy(), ref_kkt, 1e-8, "kkt")
    _close_scaled(a_p.numpy(), ref_ap, 1e-8, "step size")
    for name, val in fields(ref_sol).items():
        _close_scaled(getattr(new, name).numpy(), val, 1e-8, name)


def test_walk_chain_path_matches_jacfwd_path(case):
    _, tp, sol, q0s, v0s = case
    a = _port(tp, sol, q0s, v0s, use_chain=True)
    b = _port(tp, sol, q0s, v0s, use_chain=False)
    _close_scaled(a[1].numpy(), b[1].numpy(), 1e-10, "kkt")
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu",
                 "s_cone", "z_cone", "xi"):
        _close_scaled(getattr(a[0], name).numpy(),
                      getattr(b[0], name).numpy(), 1e-10, name)

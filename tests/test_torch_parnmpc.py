"""The port's ParNMPC solver (robotoc_tpu_torch/parnmpc/solver.py) against
the JAX package in float64 on the CPU.

On the iiwa14 configuration-space problem at N 6 (every stage kind, the
first with the measured state before it, the terminal with the terminal
cost, is present at any N; 6 keeps the JAX compiles short), from a seeded
iterate off the warm start: `_stage_terms` against JAX's under
`jax.jit`; `kkt_inverse` on those terms against the JAX package's
Schur-complement inverse (parnmpc/solver.py:271-287, written out below on
its `spd_inverse`) and against the dense inverse of the assembled KKT
block; one `_update` against JAX's; the line search's evaluation
`_eval_parnmpc` on trial iterates against JAX's. 1e-10 relative to each
array's largest magnitude (at least one). Then tests/test_parnmpc.py's
two cases and the
ParNMPC case of tests/test_unconstr_solver.py on the port at their N 20."""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (close_tree, fields, jax_iiwa, jit_unoptimised,
                          np_tree, perturbed_arm_iterate)

from robotoc_tpu.ops.linalg import spd_inverse
from robotoc_tpu.parnmpc import solver as JP
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.parnmpc import solver as TP

N, T = 6, 0.6
BARRIER, FTB = 1e-3, 0.995


@functools.lru_cache(maxsize=None)
def _jax():
    return jax_iiwa()


@functools.lru_cache(maxsize=None)
def _port(n=N, t=T, **opts):
    return problems.iiwa14_config(N=n, T=t, device="cpu", parnmpc=True,
                                  options=TP.SolverOptions(**opts))


@functools.lru_cache(maxsize=None)
def _iterate(seed=1):
    """A seeded iterate off the port's warm start (numpy fields; the aux
    matrices the terminal Hessian) and the initial state."""
    tp = _port()
    warm = tp.solver.init_solution(tp.q0, tp.v0)
    return perturbed_arm_iterate(warm, seed), tp.q0.numpy(), tp.v0.numpy()


@functools.lru_cache(maxsize=None)
def _jit(kind):
    jp = _jax()
    args = (jp["model"], (jp["cost"],), jp["limits"], T / N, BARRIER, 0.0)
    if kind == "terms":
        return jit_unoptimised(lambda s, q, v: JP._stage_terms(*args, s, q, v))
    if kind == "inverse":
        return jit_unoptimised(jax.vmap(_jax_kkt_inverse))
    if kind == "eval":
        return jit_unoptimised(
            lambda s, q, v: JP._eval_parnmpc(*args, s, q, v))
    return jit_unoptimised(lambda s, q, v: JP._update(
        *args[:5], FTB, 0.0, False, 0.75, 0.05, s, q, v)[:3])


def _jax_kkt_inverse(Qaa, Qaq, Qav, Qqq, Qqv, Qvv):
    """robotoc_tpu/parnmpc/solver.py:271-287 (a closure of `_update`
    there), on the JAX package's spd_inverse."""
    nv, dt = 7, T / N
    eye = jnp.eye(nv)
    Z = jnp.zeros((nv, nv))
    F = jnp.block([[Z, -eye, dt * eye], [dt * eye, Z, -eye]])
    H = jnp.block([[Qaa, Qaq, Qav], [Qaq.T, Qqq, Qqv], [Qav.T, Qqv.T, Qvv]])
    Hi = spd_inverse(H)
    FHi = F @ Hi
    Si = spd_inverse(FHi @ F.T)
    TR = Si @ FHi
    BR = Hi - FHi.T @ TR
    return jnp.concatenate([jnp.concatenate([-Si, TR], axis=1),
                            jnp.concatenate([TR.T, BR], axis=1)], axis=0)


def _both(f):
    return (JP.ParNMPCSolution(**{k: jnp.asarray(v) for k, v in f.items()}),
            convert.parnmpc_solution(f, device="cpu"))


@functools.lru_cache(maxsize=None)
def _terms():
    """(JAX terms (numpy), port terms) of the seeded iterate."""
    f, q0, v0 = _iterate()
    js, ts = _both(f)
    want = np_tree(_jit("terms")(js, jnp.asarray(q0), jnp.asarray(v0)))
    got = TP._stage_terms(*_port().solver._args(), 0.0,
                          ts.map(lambda x: x.unsqueeze(0)),
                          torch.as_tensor(q0)[None],
                          torch.as_tensor(v0)[None])
    return want, got


def test_stage_terms_match_jax():
    want, got = _terms()
    names = ("Fq", "Fv", "la", "lq", "lv", "Qaa", "Qaq", "Qav", "Qqq", "Qqv",
             "Qvv", "kkt_sq")
    for name, w, g in zip(names, want[:12], got[:12]):
        close_tree([g[0].numpy()], [w], 1e-10, name)
    for name, w in want[12].items():
        close_tree([got[12][name][0].numpy()], [w], 1e-10, name)


def test_kkt_inverse_matches_jax():
    """On the iterate's condensed Hessian blocks (the aux of the next stage
    added as `_update` adds it)."""
    want, got = _terms()
    f = _iterate()[0]
    blocks = [np.array(w) for w in want[5:11]]
    nv = 7
    aux_next = np.concatenate([f["aux"][1:], np.zeros((1, 14, 14))])
    blocks[3] = blocks[3] + aux_next[:, :nv, :nv]
    blocks[4] = blocks[4] + aux_next[:, :nv, nv:]
    blocks[5] = blocks[5] + aux_next[:, nv:, nv:]
    ref = np.asarray(_jit("inverse")(*(jnp.asarray(b) for b in blocks)))
    inv = TP.kkt_inverse(*(torch.as_tensor(b) for b in blocks), T / N)
    close_tree([inv.numpy()], [ref], 1e-10, "kkt inverse")
    # the inverse of the assembled block [[0, F], [F^T, H]]
    Qaa, Qaq, Qav, Qqq, Qqv, Qvv = blocks
    H = np.block([[Qaa, Qaq, Qav],
                  [np.swapaxes(Qaq, 1, 2), Qqq, Qqv],
                  [np.swapaxes(Qav, 1, 2), np.swapaxes(Qqv, 1, 2), Qvv]])
    eye, Z, dt = np.eye(nv), np.zeros((nv, nv)), T / N
    F = np.block([[Z, -eye, dt * eye], [dt * eye, Z, -eye]])
    K = np.block([[np.broadcast_to(np.zeros((14, 14)), (N, 14, 14)),
                   np.broadcast_to(F, (N, 14, 21))],
                  [np.broadcast_to(F.T, (N, 21, 14)), H]])
    close_tree([inv.numpy() @ K], [np.broadcast_to(np.eye(35), K.shape)],
               1e-8, "inverse times block")


def test_update_matches_jax():
    f, q0, v0 = _iterate()
    js, ts = _both(f)
    ref_sol, ref_kkt, ref_ap = np_tree(_jit("update")(
        js, jnp.asarray(q0), jnp.asarray(v0)))
    new, kkt, a_p, _ = TP._update(
        *_port().solver._args(), FTB, 0.0, False, 0.75, 0.05,
        ts.map(lambda x: x.unsqueeze(0)), torch.as_tensor(q0)[None],
        torch.as_tensor(v0)[None])
    np.testing.assert_allclose(kkt[0].numpy(), ref_kkt, rtol=1e-10)
    np.testing.assert_allclose(a_p[0].numpy(), ref_ap, rtol=1e-10)
    for name, val in fields(ref_sol).items():
        close_tree([getattr(new, name)[0].numpy()], [val], 1e-10, name)


def test_eval_parnmpc_matches_jax():
    """The filter search's evaluation (cost + barrier, l1 violation) of
    ParNMPC iterates, on the seeded iterate and two rungs of trial steps
    toward the update's result (leading ladder dim, as the search calls
    it); the search itself is line_search.py's, held against JAX in
    tests/test_torch_unconstr.py and tests/test_torch_line_search.py."""
    f, q0, v0 = _iterate()
    js, ts = _both(f)
    new = np_tree(_jit("update")(js, jnp.asarray(q0), jnp.asarray(v0)))[0]
    rungs = []
    for alpha in (0.0, 0.3, 1.0):
        rungs.append({k: (f[k] + alpha * (np.asarray(getattr(new, k))
                                          - f[k])
                          if k in ("q", "v", "a", "u", "slack") else f[k])
                      for k in f})
    want = [np_tree(_jit("eval")(_both(r)[0], jnp.asarray(q0),
                                 jnp.asarray(v0))) for r in rungs]
    stacked = convert.parnmpc_solution(
        {k: np.stack([r[k] for r in rungs])[:, None] for k in f},
        device="cpu")
    c, v = TP._eval_parnmpc(*_port().solver._args(), 0.0, stacked,
                            torch.as_tensor(q0)[None],
                            torch.as_tensor(v0)[None])
    assert c.shape == v.shape == (3, 1)
    np.testing.assert_allclose(c[:, 0].numpy(), [w[0] for w in want],
                               rtol=1e-10)
    np.testing.assert_allclose(v[:, 0].numpy(), [w[1] for w in want],
                               rtol=1e-10)


# -- solves at N 20 (tests/test_parnmpc.py, tests/test_unconstr_solver.py) --

@functools.lru_cache(maxsize=None)
def _solved():
    p = _port(20, 1.0)
    return p, p.solver.solve(p.q0, p.v0)


def test_parnmpc_converges():
    _, (_, st) = _solved()
    assert float(st["kkt_error"]) < 1e-7, st
    assert int(st["iterations"]) < 60
    assert not bool(st["numerical_failure"])


def test_parnmpc_matches_riccati_solver():
    """tests/test_parnmpc.py:51-56: stage i of ParNMPC owns grid i+1; the
    two solvers discretise by backward and forward Euler, so they agree to
    O(dt)."""
    p, (sol_p, _) = _solved()
    rc = problems.iiwa14_config(N=20, T=1.0, device="cpu")
    sol_r, st_r = rc.solver.solve(rc.q0, rc.v0)
    assert bool(st_r["convergence"])
    dt = 1.0 / 20
    np.testing.assert_allclose(sol_p.q.numpy(), sol_r.q[1:].numpy(),
                               atol=5.0 * dt)
    np.testing.assert_allclose(sol_p.v[3:].numpy(), sol_r.v[4:].numpy(),
                               atol=5.0 * dt)
    np.testing.assert_allclose(sol_p.q[-1].numpy(), sol_r.q[-1].numpy(),
                               atol=2.0 * dt)


def test_parnmpc_line_search_converges():
    """tests/test_unconstr_solver.py:105-129 on the port."""
    p = _port(20, 1.0, enable_line_search=True, max_iter=60, kkt_tol=1e-6)
    _, st = p.solver.solve(p.q0, p.v0)
    assert float(st["kkt_error"]) < 1e-6
    assert not bool(st["numerical_failure"])

"""The port's line search (robotoc_tpu_torch/line_search) against the JAX
package's in float64 on the CPU.

The four cases of tests/test_line_search_filter.py on the port's filter
functions; `eval_ocp` (cost + barrier, l1 primal feasibility) on a
perturbed B = 2 standing fleet (N 4) and on a B = 2 trot fleet (N 6,
impact slots) against JAX's, jitted and vmapped over the fleet, to
1e-10 relative; and one port update with the merit search on a B = 2
standing fleet against two JAX `OCPSolver.update` calls with
enable_line_search=True, from initial states rotated or lifted by 1e-3
(the second scenario backtracks, asserted against the fraction-to-
boundary step): the same accepted step per scenario, and every field to
1e-8 of its largest magnitude (at least one), as
tests/test_torch_ocp_slice.py holds the update."""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (fields, jax_problem, jax_trot, jit_unoptimised,
                          np_tree, perturbed_solution, to_torch, trot_iterate,
                          trot_to_torch)

from robotoc_tpu.line_search import line_search as jls
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert
from robotoc_tpu_torch.line_search import line_search as ls
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.solver import ocp_solver as TOS

B = 2


def _close_scaled(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


# -- the filter (tests/test_line_search_filter.py's cases) ---------------

def test_empty_filter_accepts():
    filt = ls.empty_filter()
    assert bool(ls.filter_accepts(filt, 10.0, 5.0))
    assert bool(ls.filter_accepts(filt, float("inf"), 0.0))


def test_filter_accept_reject_matches_reference():
    filt = ls.filter_augment(ls.empty_filter(), 0, 1.0, 1.0)
    rate = 0.005
    kw = dict(cost_rate=rate, viol_rate=rate)
    assert bool(ls.filter_accepts(filt, 1.0 - 2 * rate, 1.0, **kw))
    assert bool(ls.filter_accepts(filt, 5.0, 0.9, **kw))
    assert not bool(ls.filter_accepts(filt, 1.0, 1.0, **kw))
    assert not bool(ls.filter_accepts(filt, 2.0, 1.5, **kw))
    filt = ls.filter_augment(filt, 1, 100.0, 100.0)
    assert bool(ls.filter_accepts(filt, 2.0, 1.5, **kw))


def test_filter_augment_drops_nonfinite():
    filt = ls.filter_augment(ls.empty_filter(), 0, float("nan"), 1.0)
    assert bool(ls.filter_accepts(filt, 1e9, 1e9))
    filt = ls.filter_augment(filt, 0, 1.0, float("inf"))
    assert bool(ls.filter_accepts(filt, 1e9, 1e9))
    filt = ls.filter_augment(filt, 0, 1.0, 1.0)
    assert not bool(ls.filter_accepts(filt, 2.0, 2.0))


def test_filter_search_takes_full_step_on_empty_filter():
    def ev(alpha):
        return torch.ones_like(alpha), torch.ones_like(alpha)

    alpha, c, v = ls.filter_search(lambda a: a, ev,
                                   torch.tensor(1.0, dtype=torch.float64),
                                   ls.empty_filter())
    assert float(alpha) == 1.0


# -- eval_ocp ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _standing():
    """The JAX standing problem at N 4 and its port counterpart, built once
    per module."""
    jp = jax_problem(4)
    return jp, to_torch(jp)


def _jax_eval(jp, costs, sol, q0s, v0s):
    """JAX eval_ocp of each scenario (jitted, vmapped over the fleet)."""
    def one(s, q, v):
        return jls.eval_ocp(jp["model"], jp["contacts"], jp["limits"], 1e-3,
                            costs, s, jp["grid"], q, v)
    js = JOS.Solution(**{k: jnp.asarray(v) for k, v in sol.items()})
    return np_tree(jit_unoptimised(jax.vmap(one))(js, jnp.asarray(q0s),
                                          jnp.asarray(v0s)))


def _port_eval(tp, costs, sol, q0s, v0s):
    return ls.eval_ocp(tp["model"], tp["contacts"], tp["limits"], 1e-3,
                       costs, convert.solution(sol, device="cpu"),
                       tp["grid"], torch.as_tensor(q0s),
                       torch.as_tensor(v0s))


def test_eval_ocp_matches_jax_standing():
    jp, tp = _standing()
    warm = TOS.make_initial_solution(tp["model"], tp["contacts"],
                                     tp["limits"], 1e-3, tp["grid"],
                                     tp["q0"], tp["v0"])
    warm = JOS.Solution(**{k: jnp.asarray(v.numpy())
                           for k, v in vars(warm).items()})
    its = [perturbed_solution(warm, seed=s) for s in (0, 1)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    q0s = np.stack([np.asarray(jp["q0"])] * B)
    v0s = 0.1 * np.random.default_rng(2).standard_normal((B, 18))
    want = _jax_eval(jp, (jp["cost"],), sol, q0s, v0s)
    got = _port_eval(tp, (tp["cost"],), sol, q0s, v0s)
    for g, w, name in zip(got, want, ("cost", "violation")):
        assert g.shape == (B,)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, err_msg=name)


def test_eval_ocp_matches_jax_trot():
    jt = jax_trot(6)
    tp = trot_to_torch(jt)
    its = [trot_iterate(tp, seed=30 + b) for b in range(B)]
    sol = {k: np.stack([it[k] for it in its]) for k in its[0]}
    q0s = np.stack([np.asarray(jt["q0"])] * B)
    v0s = np.zeros((B, 18))
    want = _jax_eval(jt, jt["costs"], sol, q0s, v0s)
    got = _port_eval(tp, tp["costs"], sol, q0s, v0s)
    for g, w, name in zip(got, want, ("cost", "violation")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, err_msg=name)


# -- the merit search inside one update ------------------------------------

def test_merit_update_matches_jax():
    jp, tp = _standing()
    dq = np.zeros((B, 18))
    dq[0, 5], dq[1, 2] = 1e-3, 1e-3      # yaw, height of the initial state
    q0s = trm.integrate(tp["model"], tp["q0"].expand(B, 19),
                        torch.as_tensor(dq))
    v0s = torch.zeros(B, 18, dtype=torch.float64)
    sol = TOS.make_initial_solution(tp["model"], tp["contacts"],
                                    tp["limits"], 1e-3, tp["grid"], tp["q0"],
                                    tp["v0"]).map(
        lambda x: x.expand((B,) + x.shape).contiguous())

    def port(enable_ls):
        return TOS._update(tp["model"], tp["contacts"], tp["limits"], 1e-3,
                           0.995, (tp["cost"],), sol, tp["grid"], q0s, v0s,
                           enable_ls=enable_ls)

    new, kkt, a_p, _ = port("merit")
    a_max = port(False)[2]
    assert bool((a_p < a_max).any()), (a_p, a_max)     # one backtracks
    js = JOS.OCPSolver(jp["model"], jp["contacts"], (jp["cost"],),
                       jp["limits"], T=0.5, N=4,
                       options=JOS.SolverOptions(enable_line_search=True,
                                                 use_pallas=False))
    f = {k: v.numpy() for k, v in vars(sol).items()}
    for b in range(B):
        jsol = JOS.Solution(**{k: jnp.asarray(v[b]) for k, v in f.items()})
        ref_sol, ref_kkt, ref_ap, _ = np_tree(js.update(
            jp["grid"], jnp.asarray(q0s[b].numpy()),
            jnp.asarray(v0s[b].numpy()), jsol))
        # the same rung of the ladder (neighbouring rungs are 25 % apart;
        # the fraction-to-boundary step itself agrees to rounding)
        assert abs(float(a_p[b]) - float(ref_ap)) <= 1e-10 * float(ref_ap)
        _close_scaled(kkt[b].numpy(), ref_kkt, 1e-8, "kkt")
        for name, val in fields(ref_sol).items():
            _close_scaled(getattr(new, name)[b].numpy(), val, 1e-8, name)

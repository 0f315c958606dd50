"""Filter line search of the unconstrained (fixed-base) solvers
(counterpart of robotoc_tpu/line_search/unconstr_line_search.py;
reference src/line_search/unconstr_line_search.cpp:37-70): a
Fletcher-Leyffer filter over (cost + barrier, l1 primal feasibility).

The filter and its batched search are line_search.py's: the whole ladder
of trial steps is evaluated in one pass, and each scenario takes the
first rung the JAX loop would accept, with no host synchronisation per
trial. Everything is batched over a leading fleet dim, and during the
search over the ladder's dim before it.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from ..constraints import joint_limits as jl
from ..constraints import pdipm
from ..costs import base as cost_base
from ..models import robot as rm
from .line_search import empty_filter, filter_augment, filter_search


def n_rungs(reduction, min_step):
    """Rungs the JAX loop can visit from a step of at most one: it stops at
    the first step <= min_step, each step the last times `reduction`."""
    n, alpha = 1, 1.0
    while alpha > min_step:
        alpha *= reduction
        n += 1
    return n


def eval_unconstr(model, cost, limits, dt, barrier, t0, sol, q_init,
                  v_init):
    """(cost + log-barrier, l1 primal feasibility) of each iterate: the
    fields of an UnconstrSolution with any leading dims, (..., N+1, ...)
    (slack (..., N, dimc)); q_init and v_init broadcast against them. Only
    q, v, a, u and slack are read."""
    lead = tuple(sol.q.shape[:-2])
    N = sol.q.shape[-2] - 1
    ts = t0 + dt * torch.arange(N, dtype=sol.q.dtype, device=sol.q.device)

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[len(lead) + 1:]))

    def stage(t, q, v, a, u, q_n, v_n, s):
        e_id = rm.rnea(model, q, v, a) - u
        Fq = q + dt * v - q_n
        Fv = v + dt * a - v_n
        c = cost_base.eval_stage(cost, model, q, v, a, u, q.new_zeros(0), t,
                                 dt)
        e = jl.constraint_values(model, limits, q, v, u, a)
        bar = pdipm.log_barrier(s, barrier, limits.mask)
        viol = (torch.sum(torch.abs(Fq)) + torch.sum(torch.abs(Fv))
                + torch.sum(torch.abs(e_id))
                + torch.sum(torch.abs(pdipm.residual(e, s, limits.mask))))
        return c + bar, viol

    cs, viols = vmap(stage)(*[flat(x) for x in (
        ts.expand(lead + (N,)), sol.q[..., :-1, :], sol.v[..., :-1, :],
        sol.a[..., :-1, :], sol.u[..., :-1, :], sol.q[..., 1:, :],
        sol.v[..., 1:, :], sol.slack)])
    tN = torch.full(lead + (1,), t0 + dt * N, dtype=sol.q.dtype,
                    device=sol.q.device)
    cN = vmap(lambda q, v, t: cost_base.eval_terminal(cost, model, q, v, t))(
        flat(sol.q[..., -1:, :]), flat(sol.v[..., -1:, :]), flat(tN))
    viol0 = (torch.sum(torch.abs(q_init - sol.q[..., 0, :]), dim=-1)
             + torch.sum(torch.abs(v_init - sol.v[..., 0, :]), dim=-1))
    return (torch.sum(cs.reshape(lead + (N,)), dim=-1) + cN.reshape(lead),
            torch.sum(viols.reshape(lead + (N,)), dim=-1) + viol0)


def filter_step(eval_fn, sol, trial_fn, alpha_max, filt, it, reduction=0.75,
                min_step=0.05):
    """Each scenario's backtracked primal step through its filter (B,
    MAX_FILTER, 2): an empty filter is first seeded with the current
    iterate's pair at slot `it`, and the accepted trial's pair goes in at
    slot it + 1. eval_fn(iterates) -> (cost + barrier, l1 violation) over
    the iterates' leading dims; trial_fn(alpha (R, B)) -> the primal trial
    iterates. Returns (alpha (B,), the filters)."""
    c_cur, v_cur = eval_fn(sol)
    empty = ~torch.any(torch.isfinite(filt[..., 1]), dim=-1)
    filt = torch.where(empty[..., None, None],
                       filter_augment(filt, it, c_cur, v_cur), filt)
    alpha, c_t, v_t = filter_search(trial_fn, eval_fn, alpha_max, filt,
                                    reduction=reduction, alpha_min=min_step,
                                    n=n_rungs(reduction, min_step))
    return alpha, filter_augment(filt, it + 1, c_t, v_t)


def primal_step_size(model, cost, limits, dt, barrier, t0, sol, q_init,
                     v_init, trial_fn, alpha_max, filt, it, reduction=0.75,
                     min_step=0.05):
    """`filter_step` on `eval_unconstr` of the fleet (sol fields (B, N+1,
    ...), q_init (B, nq)). Returns (alpha (B,), the filters)."""
    def eval_fn(s):
        return eval_unconstr(model, cost, limits, dt, barrier, t0, s,
                             q_init, v_init)

    return filter_step(eval_fn, sol, trial_fn, alpha_max, filt, it,
                       reduction, min_step)


__all__ = ["eval_unconstr", "filter_step", "primal_step_size",
           "empty_filter", "n_rungs"]

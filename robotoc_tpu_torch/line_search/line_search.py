"""Merit and filter backtracking line searches for the contact OCP
(counterpart of robotoc_tpu/line_search/line_search.py; reference
src/line_search/line_search.cpp:29-120, reduction rate 0.75, minimum step
0.05).

`eval_ocp` is the cheap evaluation pass of a trial iterate (cost +
barrier and l1 primal feasibility, no derivatives). Everything here is
batched over leading dims: a fleet of scenarios (B, ...), and for the
searches a leading ladder dim of trial steps before it.

The JAX package runs each scenario's search as a `lax.while_loop` under
vmap: from alpha_max it multiplies alpha by the reduction while the trial
is refused and alpha > alpha_min. Here the whole ladder alpha_max,
alpha_max r, alpha_max r^2, ... (formed by the same repeated products)
is evaluated in one batched pass and each scenario takes the first rung
where the loop's condition is false: the same choice, with no host
synchronisation per trial. `N_RUNGS` = 12 rungs suffice for every
alpha_max <= 1 (the fraction-to-boundary step): 0.75^11 < 0.05, so the
loop has stopped by the last rung.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from ..constraints import friction_cone as fc
from ..constraints import joint_limits as jl
from ..constraints import pdipm
from ..costs import base as cost_base
from ..dynamics import state_equation as se
from ..models import contacts as ct
from ..models import robot as rm

MAX_FILTER = 32
REDUCTION, ALPHA_MIN, N_RUNGS = 0.75, 0.05, 12


def eval_ocp(model, contacts, limits, barrier, costs, sol, grid, q_init,
             v_init):
    """(cost + barrier, l1 primal feasibility) of each iterate: sol fields
    (..., S, ...) with any leading dims; the grid, q_init and v_init with
    the same leading dims or trailing ones of them (broadcast). Only q, v,
    a, u, f, s_lim and s_cone of `sol` are read. Intermediate-stage
    physics only: impact slots contribute their state-equation gap."""
    lead = tuple(sol.q.shape[:-2])
    S = sol.q.shape[-2]
    nv, dimu = model.nv, model.dimu

    def grid_at(x, own):
        return x.expand(lead + tuple(x.shape[x.dim() - own:]))

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[len(lead) + 1:]))

    def stage(t, dt, q, v, a, u, f, q_n, v_n, s_lim, s_cone, cmask, p_ref,
              fric, is_imp, R_ref):
        rowmask = contacts.force_mask(cmask)
        f_eff = f * rowmask
        fj = ct.contact_forces_to_joint(model, contacts, f_eff)
        Sact_u = torch.cat([u.new_zeros(nv - dimu), u])
        ID = rm.rnea(model, q, v, a, fj) - Sact_u
        C = ct.baumgarte_residual(model, contacts, q, v, a, p_ref,
                                  R_ref) * rowmask
        _, _, xres_q = se.linearize(model, q, v, dt, q_n)
        Fv = v + dt * a - v_n
        c = cost_base.eval_stage(costs, model, q, v, a, u, f, t, dt)
        e_lim = jl.constraint_values(model, limits, q, v, u, a)
        g_cone = fc.residual(model, contacts, q, f_eff, fric)
        cone_mask = contacts.cone_mask(cmask) > 0
        bar = (pdipm.log_barrier(s_lim, barrier, limits.mask)
               + pdipm.log_barrier(s_cone, barrier, cone_mask))
        viol = (torch.sum(torch.abs(xres_q)) + torch.sum(torch.abs(Fv))
                + (1.0 - is_imp) * (torch.sum(torch.abs(ID))
                                    + torch.sum(torch.abs(C)))
                + (1.0 - is_imp) * (
                    torch.sum(torch.abs(pdipm.residual(e_lim, s_lim,
                                                       limits.mask)))
                    + torch.sum(torch.abs(pdipm.residual(g_cone, s_cone,
                                                         cone_mask)))))
        return (1.0 - is_imp) * (c + bar), viol

    g = {name: grid_at(getattr(grid, name), own) for name, own in (
        ("t", 1), ("dt", 1), ("contact_mask", 2), ("p_ref", 3),
        ("friction", 2), ("is_impact", 1), ("R_ref", 4))}
    cs, viols = vmap(stage)(*[flat(x) for x in (
        g["t"][..., :-1], g["dt"], sol.q[..., :-1, :], sol.v[..., :-1, :],
        sol.a[..., :-1, :], sol.u[..., :-1, :], sol.f[..., :-1, :],
        sol.q[..., 1:, :], sol.v[..., 1:, :], sol.s_lim, sol.s_cone,
        g["contact_mask"][..., :-1, :], g["p_ref"][..., :-1, :, :],
        g["friction"][..., :-1, :], g["is_impact"][..., :-1],
        g["R_ref"][..., :-1, :, :, :])])
    per = lead + (S - 1,)
    q_last, v_last = flat(sol.q[..., -1:, :]), flat(sol.v[..., -1:, :])
    cN = vmap(lambda q, v, t: cost_base.eval_terminal(costs, model, q, v, t))(
        q_last, v_last, flat(g["t"][..., -1:]))
    q_init = q_init.expand(lead + (model.nq,))
    v_init = v_init.expand(lead + (nv,))
    dq0 = rm.difference(model, sol.q[..., 0, :], q_init)
    viol0 = (torch.sum(torch.abs(dq0), dim=-1)
             + torch.sum(torch.abs(v_init - sol.v[..., 0, :]), dim=-1))
    return (torch.sum(cs.reshape(per), dim=-1) + cN.reshape(lead),
            torch.sum(viols.reshape(per), dim=-1) + viol0)


def empty_filter(dtype=torch.float64, device=None, batch=()):
    """Fixed-size Fletcher-Leyffer filter of each scenario (batch dims
    first); +inf rows are empty slots (reference line_search_filter.hpp)."""
    return torch.full(tuple(batch) + (MAX_FILTER, 2), float("inf"),
                      dtype=dtype, device=device)


def filter_accepts(filt, cost, viol, cost_rate=0.005, viol_rate=0.005):
    """(cost, viol) is acceptable to filter `filt` (..., MAX_FILTER, 2) if
    ANY entry's condition holds, improve its cost by its margin OR improve
    its violation; an empty filter accepts. cost and viol broadcast
    against filt's leading dims; empty (+inf) slots are masked out."""
    cost = torch.as_tensor(cost, dtype=filt.dtype, device=filt.device)
    viol = torch.as_tensor(viol, dtype=filt.dtype, device=filt.device)
    finite = torch.isfinite(filt[..., 1])
    ok = ((cost.unsqueeze(-1) < filt[..., 0] - cost_rate * filt[..., 1])
          | (viol.unsqueeze(-1) < (1.0 - viol_rate) * filt[..., 1]))
    return torch.any(finite & ok, dim=-1) | ~torch.any(finite, dim=-1)


def filter_augment(filt, it, cost, viol):
    """Insert each scenario's accepted pair at slot it % MAX_FILTER (it an
    int or a tensor of filt's leading shape). Non-finite pairs are
    dropped: a NaN entry would reject every later trial."""
    cost = torch.as_tensor(cost, dtype=filt.dtype, device=filt.device)
    viol = torch.as_tensor(viol, dtype=filt.dtype, device=filt.device)
    lead = filt.shape[:-2]
    slot = torch.remainder(torch.as_tensor(it, device=filt.device),
                           MAX_FILTER).expand(lead)
    at = (torch.arange(MAX_FILTER, device=filt.device)
          == slot.unsqueeze(-1)).unsqueeze(-1)
    entry = torch.stack([cost.expand(lead), viol.expand(lead)], dim=-1)
    new = torch.where(at, entry.unsqueeze(-2), filt)
    ok = (torch.isfinite(cost) & torch.isfinite(viol)).expand(lead)
    return torch.where(ok[..., None, None], new, filt)


def ladder(alpha_max, n=N_RUNGS, reduction=REDUCTION):
    """(n,) + alpha_max.shape: alpha_max and its repeated reductions, each
    rung the previous one times `reduction`, as the JAX loop forms them."""
    rungs = [torch.as_tensor(alpha_max)]
    for _ in range(n - 1):
        rungs.append(rungs[-1] * reduction)
    return torch.stack(rungs)


def _first_stop(go):
    """Index along dim 0 of the first False of `go` (the last rung when
    there is none)."""
    stop = ~go
    stop[-1] = True
    return torch.argmax(stop.to(torch.int32), dim=0)


def _pick(x, k):
    """x (n, ...) at rung k (...) of each entry."""
    return torch.gather(x, 0, k.unsqueeze(0)).squeeze(0)


def filter_search(trial_fn, eval_fn, alpha_max, filt, reduction=REDUCTION,
                  alpha_min=ALPHA_MIN, n=N_RUNGS):
    """Backtrack each scenario to its largest step acceptable to its
    filter. trial_fn(alpha (n, ...)) -> the trial iterates with those
    leading dims; eval_fn(trials) -> (cost + barrier, l1 violation), each
    (n, ...). Returns (alpha, cost, viol) at the accepted trials."""
    alphas = ladder(alpha_max, n, reduction)
    c, v = eval_fn(trial_fn(alphas))
    k = _first_stop(~filter_accepts(filt, c, v) & (alphas > alpha_min))
    return _pick(alphas, k), _pick(c, k), _pick(v, k)


def search(trial_fn, merit_fn, alpha_max, reduction=REDUCTION,
           alpha_min=ALPHA_MIN, margin=0.0, n=N_RUNGS):
    """Merit backtracking: each scenario's largest alpha = alpha_max
    reduction^k whose merit improves on its merit at alpha = 0.
    trial_fn(alpha (n + 1, ...)) -> trial iterates; merit_fn(trials) ->
    (n + 1, ...). A NaN trial merit stops the loop there, as in JAX (its
    comparison is false)."""
    alphas = ladder(alpha_max, n, reduction)
    phi = merit_fn(trial_fn(torch.cat([torch.zeros_like(alphas[:1]),
                                       alphas])))
    phi0, phis = phi[0], phi[1:]
    k = _first_stop((phis > phi0 - margin) & (alphas > alpha_min))
    return _pick(alphas, k)

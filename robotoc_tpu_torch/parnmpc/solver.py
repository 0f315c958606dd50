"""UnconstrParNMPCSolver: the time-parallel backward-correction Newton
method (counterpart of robotoc_tpu/parnmpc/solver.py; reference
src/parnmpc/unconstr_backward_correction.cpp:57-290, algorithm of Deng
and Ohtsuka).

  1. Coarse: every stage inverts its own 5nv x 5nv KKT block, the next
     stage's auxiliary matrix standing in for the tail of the horizon: one
     batched Schur-complement inverse over all stages of the fleet.
  2. The backward and forward correction sweeps restore the coupling
     between neighbours: loops over the N stages on (B, ...) tensors, where
     the JAX package runs serial `lax.scan`s.
  3. The (u, beta) and PDIPM expansion, fraction-to-boundary steps, and
     with enable_line_search the filter line search.

Stage i owns grid i+1's variables (lmd, gmm, a, q, v) with the condensed
(u, beta) and its PDIPM pairs; the previous state of stage 0 is the
measured one. Backward Euler coupling: Fq_i = q_{i-1} + dt v_i - q_i,
Fv_i = v_{i-1} + dt a_i - v_i.

The fleet is a leading batch dimension (fields (B, N, ...), q_init (B,
nq)), or absent for one problem; each scenario of `solve` stops where the
JAX loop breaks (alpha == 0 or a non-finite KKT) and reports its own
numerical_failure.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from ..constraints import joint_limits as jl
from ..constraints import pdipm
from ..costs import base as cost_base
from ..line_search import unconstr_line_search as uls
from ..models import robot as rm
from ..ops.linalg import spd_inverse
from ..solver.ocp_solver import _where
from ..solver.unconstr_ocp_solver import _fleet


@dataclasses.dataclass
class ParNMPCSolution:
    q: torch.Tensor       # (N, nq)   stage-owned grids 1..N
    v: torch.Tensor
    a: torch.Tensor
    u: torch.Tensor
    lmd: torch.Tensor
    gmm: torch.Tensor
    beta: torch.Tensor
    slack: torch.Tensor   # (N, dimc)
    dual: torch.Tensor
    aux: torch.Tensor     # (N, 2nv, 2nv) auxiliary matrices

    def replace(self, **kw) -> "ParNMPCSolution":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "ParNMPCSolution":
        return type(self)(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    max_iter: int = 100
    kkt_tol: float = 1e-7
    barrier: float = 1e-3
    fraction_to_boundary_rule: float = 0.995
    enable_line_search: bool = False
    """Fletcher-Leyffer filter line search on the primal step (reference
    unconstr_line_search.hpp:29; off by default, as in the reference)."""
    ls_reduction: float = 0.75
    ls_min_step: float = 0.05


class UnconstrParNMPCSolver:
    def __init__(self, model: rm.RobotModel, cost, limits, T: float, N: int,
                 options: SolverOptions = SolverOptions(), t0: float = 0.0):
        if model.floating_base:
            raise ValueError("UnconstrParNMPCSolver needs a fixed-base "
                             "robot")
        self.model = model
        self.cost = tuple(cost) if isinstance(cost, (tuple, list)) \
            else (cost,)
        self.limits = limits if limits is not None \
            else jl.make_joint_limits(model)
        self.T, self.N, self.t0 = float(T), int(N), float(t0)
        self.dt = self.T / self.N
        self.options = options

    def _args(self):
        return (self.model, self.cost, self.limits, self.dt,
                self.options.barrier)

    def _initial(self, q_init, v_init):
        kw = dict(dtype=self.model.dtype, device=self.model.device)
        return torch.as_tensor(q_init, **kw), torch.as_tensor(v_init, **kw)

    def init_solution(self, q, v) -> ParNMPCSolution:
        """q, v of one problem (nq,) or a fleet (B, nq) held over the
        stages, the PDIPM pairs at the barrier, and the terminal cost's
        Hessian as every stage's auxiliary matrix (reference :57-71)."""
        m, N = self.model, self.N
        q, v = self._initial(q, v)
        lead = tuple(q.shape[:-1])
        q = q.unsqueeze(-2).expand(lead + (N, m.nq)).contiguous()
        v = v.unsqueeze(-2).expand(lead + (N, m.nv)).contiguous()
        z = torch.zeros(lead + (N, m.nv), dtype=m.dtype, device=m.device)
        e = jl.constraint_values(m, self.limits, q, v, z, z)
        s0, z0 = pdipm.init_slack_dual(e, self.options.barrier,
                                       self.limits.mask)
        qN, vN = q[..., -1, :].reshape(-1, m.nq), v[..., -1, :].reshape(
            -1, m.nv)
        tN = torch.full((qN.shape[0],), self.t0 + self.T, dtype=m.dtype,
                        device=m.device)
        tq = vmap(lambda q_, v_, t_: cost_base.quadratize_terminal(
            self.cost, m, q_, v_, t_))(qN, vN, tN)
        zb = torch.zeros_like(tq.Qqq)
        aux0 = torch.cat([torch.cat([tq.Qqq, zb], dim=-1),
                          torch.cat([zb, tq.Qvv], dim=-1)], dim=-2)
        aux = aux0.reshape(lead + (1, 2 * m.nv, 2 * m.nv)).expand(
            lead + (N, 2 * m.nv, 2 * m.nv)).contiguous()
        return ParNMPCSolution(q=q, v=v, a=z, u=z.clone(), lmd=z.clone(),
                               gmm=z.clone(), beta=z.clone(), slack=s0,
                               dual=z0, aux=aux)

    def update(self, q_init, v_init, sol: ParNMPCSolution, filt=None, it=0):
        """One Newton update: (sol, kkt of the iterate given, primal step,
        filters)."""
        sol_b, q_b, v_b, batched = _fleet(sol, *self._initial(q_init,
                                                              v_init))
        o = self.options
        new, kkt, a_p, filt = _update(
            *self._args(), o.fraction_to_boundary_rule, self.t0,
            o.enable_line_search, o.ls_reduction, o.ls_min_step, sol_b, q_b,
            v_b, filt, it)
        if not batched:
            return new.map(lambda x: x[0]), kkt[0], a_p[0], filt
        return new, kkt, a_p, filt

    def solve(self, q_init, v_init, sol=None, max_iter=None, tol=None):
        """The host loop of the JAX package's `solve`, per scenario: update
        while it < max_iter and kkt > tol; a zero step or a non-finite KKT
        stops the scenario with numerical_failure. Each iteration
        evaluates the stage terms once (the KKT of the new iterate, reused
        by the next update) and synchronises with the host once. Returns
        (sol, stats): iterations, kkt_error, numerical_failure, one each
        per scenario."""
        q_init, v_init = self._initial(q_init, v_init)
        if sol is None:
            sol = self.init_solution(q_init, v_init)
        sol_b, q_b, v_b, batched = _fleet(sol, q_init, v_init)
        o = self.options
        max_iter = max_iter or o.max_iter
        tol = tol or o.kkt_tol
        args = self._args()
        Bn, dev = sol_b.q.shape[0], sol_b.q.device
        terms = _stage_terms(*args, self.t0, sol_b, q_b, v_b)
        kkt = _kkt_of(terms)
        it = torch.zeros(Bn, dtype=torch.long, device=dev)
        failed = torch.zeros(Bn, dtype=torch.bool, device=dev)
        filt = uls.empty_filter(sol_b.q.dtype, dev, (Bn,))
        for _ in range(max_iter):
            run = (it < max_iter) & (kkt > tol) & ~failed
            if not bool(run.any()):
                break
            new, _, alpha, filt_new = _update(
                *args, o.fraction_to_boundary_rule, self.t0,
                o.enable_line_search, o.ls_reduction, o.ls_min_step, sol_b,
                q_b, v_b, filt, it, terms=terms)
            sol_b = _where(run, new, sol_b)
            if o.enable_line_search:
                filt = torch.where(run[:, None, None], filt_new, filt)
            terms = _stage_terms(*args, self.t0, sol_b, q_b, v_b)
            kkt_new = _kkt_of(terms)
            kkt = torch.where(run, kkt_new, kkt)
            failed = failed | (run & ((alpha == 0.0)
                                      | ~torch.isfinite(kkt_new)))
            it = it + run.to(it.dtype)
        st = dict(iterations=it, kkt_error=kkt, numerical_failure=failed)
        if not batched:
            sol_b = sol_b.map(lambda x: x[0])
            st = {k: v[0] for k, v in st.items()}
        return sol_b, st


# ---------------------------------------------------------------------------
# Functional core: fleet inputs (B, N, ...)
# ---------------------------------------------------------------------------

def _shift(x, first):
    """(B, N, ...) -> (B, N, ...): `first` (B, ...) then x's rows 0..N-2."""
    return torch.cat([first.unsqueeze(1), x[:, :-1]], dim=1)


def _stage_terms(model, cost, limits, dt, barrier, t0, sol, q_init, v_init):
    """The per-stage KKT pieces of a fleet (reference ParNMPC stage
    evalKKT): (Fq, Fv, la, lq, lv, Qaa, Qaq, Qav, Qqq, Qqv, Qvv, kkt_sq,
    aux pieces), each (B, N, ...)."""
    Bn, N = sol.q.shape[:2]
    nv = model.nv
    q_prev = _shift(sol.q, q_init)
    v_prev = _shift(sol.v, v_init)
    zrow = torch.zeros_like(sol.lmd[:, :1])
    lmd_next = torch.cat([sol.lmd[:, 1:], zrow], dim=1)
    gmm_next = torch.cat([sol.gmm[:, 1:], zrow], dim=1)
    is_term = (torch.arange(N, device=sol.q.device) == N - 1).to(
        sol.q.dtype).expand(Bn, N)
    ts = (t0 + dt * torch.arange(1, N + 1, dtype=sol.q.dtype,
                                 device=sol.q.device)).expand(Bn, N)

    def one(t, qp, vp, q, v, a, u, beta, lmd, gmm, lmd_n, gmm_n, s, z,
            term):
        ID = rm.rnea(model, q, v, a)
        e_id = ID - u
        dIDdq, dIDdv, M = rm.rnea_derivatives(model, q, v, a)
        quad = cost_base.quadratize_stage(cost, model, 0, q, v, a, u,
                                          q.new_zeros(0), t, dt)
        tq = cost_base.quadratize_terminal(cost, model, q, v, t)
        lq_c = quad.lq + term * tq.lq
        lv_c = quad.lv + term * tq.lv
        Wq = quad.Qqq + term * tq.Qqq
        Wv = quad.Qvv + term * tq.Qvv
        la_c, lu_c, Wa, Wu = quad.la, quad.lu, quad.Qaa, quad.Quu
        e = jl.constraint_values(model, limits, q, v, u, a)
        Hq_d, Hv_d, Hu_d, Ha_d, gq_cd, gv_cd, gu_cd, ga_cd = jl.condense(
            model, limits, e, s, z, barrier)
        zq, zv, zu, za = jl.dual_residual(model, limits, z)
        Huu = torch.diagonal(Wu) + Hu_d
        gu0 = lu_c + zu + gu_cd
        gID = gu0 + Huu * e_id
        # condensed gradients (backward Euler coupling)
        la = la_c + za + ga_cd + M.T @ gID + dt * gmm
        lq = lq_c + zq + gq_cd + dIDdq.T @ gID - lmd + lmd_n
        lv = lv_c + zv + gv_cd + dIDdv.T @ gID + dt * lmd - gmm + gmm_n
        Fq = qp + dt * v - q
        Fv = vp + dt * a - v
        HJ = Huu.unsqueeze(-1)
        Qaa = Wa + torch.diag(Ha_d) + M.T @ (HJ * M)
        Qaq = M.T @ (HJ * dIDdq)
        Qav = M.T @ (HJ * dIDdv)
        Qqq = Wq + torch.diag(Hq_d) + dIDdq.T @ (HJ * dIDdq)
        Qqv = dIDdq.T @ (HJ * dIDdv)
        Qvv = Wv + torch.diag(Hv_d) + dIDdv.T @ (HJ * dIDdv)
        # the full KKT residual pieces (for the error norm)
        lu_full = lu_c + zu - beta
        la_full = la_c + za + M.T @ beta + dt * gmm
        lq_full = lq_c + zq + dIDdq.T @ beta - lmd + lmd_n
        lv_full = lv_c + zv + dIDdv.T @ beta + dt * lmd - gmm + gmm_n
        r_lim = pdipm.residual(e, s, limits.mask)
        c_lim = pdipm.complementarity(s, z, barrier, limits.mask)
        kkt_sq = (torch.sum(Fq ** 2) + torch.sum(Fv ** 2)
                  + torch.sum(e_id ** 2) + torch.sum(lq_full ** 2)
                  + torch.sum(lv_full ** 2) + torch.sum(la_full ** 2)
                  + torch.sum(lu_full ** 2) + torch.sum(r_lim ** 2)
                  + torch.sum(c_lim ** 2))
        aux_pieces = dict(e_id=e_id, dIDdq=dIDdq, dIDdv=dIDdv, M=M, Huu=Huu,
                          gu0=gu0, e=e)
        return (Fq, Fv, la, lq, lv, Qaa, Qaq, Qav, Qqq, Qqv, Qvv, kkt_sq,
                aux_pieces)

    def flat(x):
        return x.reshape((Bn * N,) + tuple(x.shape[2:]))

    def unflat(x):
        return x.reshape((Bn, N) + tuple(x.shape[1:]))

    out = vmap(one)(*[flat(x) for x in (
        ts, q_prev, v_prev, sol.q, sol.v, sol.a, sol.u, sol.beta, sol.lmd,
        sol.gmm, lmd_next, gmm_next, sol.slack, sol.dual, is_term)])
    return tuple(unflat(x) for x in out[:-1]) + (
        {k: unflat(x) for k, x in out[-1].items()},)


def _kkt_of(terms):
    """The KKT error (B,) of the iterate whose stage terms these are."""
    return torch.sqrt(torch.sum(terms[11], dim=1))


def _kkt_error(model, cost, limits, dt, barrier, t0, sol, q_init, v_init):
    return _kkt_of(_stage_terms(model, cost, limits, dt, barrier, t0, sol,
                                q_init, v_init))


def _eval_parnmpc(model, cost, limits, dt, barrier, t0, sol, q_init,
                  v_init):
    """(cost + log-barrier, l1 primal feasibility) of ParNMPC iterates with
    any leading dims (..., N, ...) (backward-Euler gaps; the line search's
    evaluation, reference unconstr_line_search.cpp:55-58)."""
    lead = tuple(sol.q.shape[:-2])
    N = sol.q.shape[-2]
    dtype, dev = sol.q.dtype, sol.q.device
    q_prev = torch.cat([q_init.expand(lead + (q_init.shape[-1],))
                        .unsqueeze(-2), sol.q[..., :-1, :]], dim=-2)
    v_prev = torch.cat([v_init.expand(lead + (v_init.shape[-1],))
                        .unsqueeze(-2), sol.v[..., :-1, :]], dim=-2)
    is_term = (torch.arange(N, device=dev) == N - 1).to(dtype)
    ts = t0 + dt * torch.arange(1, N + 1, dtype=dtype, device=dev)

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[len(lead) + 1:]))

    def one(t, qp, vp, q, v, a, u, s, term):
        e_id = rm.rnea(model, q, v, a) - u
        Fq = qp + dt * v - q
        Fv = vp + dt * a - v
        c = cost_base.eval_stage(cost, model, q, v, a, u, q.new_zeros(0), t,
                                 dt)
        c = c + term * cost_base.eval_terminal(cost, model, q, v, t)
        e = jl.constraint_values(model, limits, q, v, u, a)
        bar = pdipm.log_barrier(s, barrier, limits.mask)
        viol = (torch.sum(torch.abs(Fq)) + torch.sum(torch.abs(Fv))
                + torch.sum(torch.abs(e_id))
                + torch.sum(torch.abs(pdipm.residual(e, s, limits.mask))))
        return c + bar, viol

    cs, viols = vmap(one)(*[flat(x) for x in (
        ts.expand(lead + (N,)), q_prev, v_prev, sol.q, sol.v, sol.a, sol.u,
        sol.slack, is_term.expand(lead + (N,)))])
    return (torch.sum(cs.reshape(lead + (N,)), dim=-1),
            torch.sum(viols.reshape(lead + (N,)), dim=-1))


def kkt_inverse(Qaa, Qaq, Qav, Qqq, Qqv, Qvv, dt):
    """The inverse of each stage's KKT block [[0, F], [F^T, H]] by the
    Schur complement on the positive definite Hessian H (reference
    parnmpc/unconstr_kkt_matrix_inverter.hxx), batched over leading dims:
    S = F H^-1 F^T and
        inv = [[-S^-1, S^-1 F H^-1],
               [(S^-1 F H^-1)^T, H^-1 - H^-1 F^T S^-1 F H^-1]]."""
    nv = Qaa.shape[-1]
    eye = torch.eye(nv, dtype=Qaa.dtype, device=Qaa.device)
    Z = torch.zeros_like(eye)
    F = torch.cat([torch.cat([Z, -eye, dt * eye], dim=1),
                   torch.cat([dt * eye, Z, -eye], dim=1)], dim=0)
    tr = lambda x: x.transpose(-1, -2)                       # noqa: E731
    H = torch.cat([torch.cat([Qaa, Qaq, Qav], dim=-1),
                   torch.cat([tr(Qaq), Qqq, Qqv], dim=-1),
                   torch.cat([tr(Qav), tr(Qqv), Qvv], dim=-1)], dim=-2)
    Hi = spd_inverse(H)
    FHi = F @ Hi                                             # (2nv, 3nv)
    Si = spd_inverse(FHi @ F.T)
    TR = Si @ FHi
    BR = Hi - tr(FHi) @ TR
    return torch.cat([torch.cat([-Si, TR], dim=-1),
                      torch.cat([tr(TR), BR], dim=-1)], dim=-2)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _update(model, cost, limits, dt, barrier, ftb, t0, enable_ls,
            ls_reduction, ls_min_step, sol: ParNMPCSolution, q_init, v_init,
            filt=None, it=0, terms=None):
    """One Newton update of a fleet. `terms`: the iterate's stage terms
    when already evaluated. Returns (sol, kkt (B,), a_p (B,), filters)."""
    nv = model.nv
    if terms is None:
        terms = _stage_terms(model, cost, limits, dt, barrier, t0, sol,
                             q_init, v_init)
    (Fq, Fv, la, lq, lv, Qaa, Qaq, Qav, Qqq, Qqv, Qvv, kkt_sq,
     aux_p) = terms
    # the NEXT stage's aux added to Qxx (the terminal stage: none)
    aux_next = torch.cat([sol.aux[:, 1:], torch.zeros_like(sol.aux[:, :1])],
                         dim=1)
    Qqq = Qqq + aux_next[..., :nv, :nv]
    Qqv = Qqv + aux_next[..., :nv, nv:]
    Qvv = Qvv + aux_next[..., nv:, nv:]
    KKT_inv = kkt_inverse(Qaa, Qaq, Qav, Qqq, Qqv, Qvv, dt)  # (B, N, 5nv, 5nv)
    res = torch.cat([Fq, Fv, la, lq, lv], dim=-1)             # (B, N, 5nv)
    dz = _mv(KKT_inv, res)
    # coarse new iterate z - dz, z = (lmd, gmm, a, q, v)
    lg_new = torch.cat([sol.lmd, sol.gmm], dim=-1) - dz[..., :2 * nv]
    a_new = sol.a - dz[..., 2 * nv:3 * nv]
    qv_new = torch.cat([sol.q, sol.v], dim=-1) - dz[..., 3 * nv:]

    # backward correction, serial over the stages (reference :191-199)
    N = sol.q.shape[1]
    inv_TR = KKT_inv[..., :2 * nv, 3 * nv:]     # lmdgmm <- x
    inv_BR = KKT_inv[..., 2 * nv:, 3 * nv:]     # (a, q, v) <- x
    lg_cur = torch.cat([sol.lmd, sol.gmm], dim=-1)
    lg_rows = [None] * N
    xres_b = [torch.zeros_like(lg_cur[:, 0])] * N
    lg_rows[N - 1] = lg_new[:, N - 1]
    for i in reversed(range(N - 1)):
        xres_b[i] = lg_rows[i + 1] - lg_cur[:, i + 1]
        lg_rows[i] = lg_new[:, i] - _mv(inv_TR[:, i], xres_b[i])
    lg_new = torch.stack(lg_rows, dim=1)
    corr_aqv = _mv(inv_BR, torch.stack(xres_b, dim=1))
    a_new = a_new - corr_aqv[..., :nv]
    qv_new = qv_new - corr_aqv[..., nv:]

    # forward correction, serial (reference :203-207)
    inv_BL = KKT_inv[..., 3 * nv:, :2 * nv]     # x <- lmdgmm
    inv_TL3 = KKT_inv[..., :3 * nv, :2 * nv]
    qv_cur = torch.cat([sol.q, sol.v], dim=-1)
    qv_rows = [qv_new[:, 0]] + [None] * (N - 1)
    xres_f = [torch.zeros_like(qv_cur[:, 0])] * N
    for i in range(1, N):
        xres_f[i] = qv_rows[i - 1] - qv_cur[:, i - 1]
        qv_rows[i] = qv_new[:, i] - _mv(inv_BL[:, i], xres_f[i])
    qv_new = torch.stack(qv_rows, dim=1)
    corr_lga = _mv(inv_TL3, torch.stack(xres_f, dim=1))
    lg_new = lg_new - corr_lga[..., :2 * nv]
    a_new = a_new - corr_lga[..., 2 * nv:]

    # the new aux matrices (reference :210: aux_mat_[i] = -auxMat())
    aux_new = torch.cat([sol.aux[:, :1], -KKT_inv[:, 1:, :2 * nv, :2 * nv]],
                        dim=1)

    # directions and expansion
    dlmd = lg_new[..., :nv] - sol.lmd
    dgmm = lg_new[..., nv:] - sol.gmm
    da = a_new - sol.a
    dq = qv_new[..., :nv] - sol.q
    dv = qv_new[..., nv:] - sol.v
    du = (_mv(aux_p["dIDdq"], dq) + _mv(aux_p["dIDdv"], dv)
          + _mv(aux_p["M"], da) + aux_p["e_id"])
    dbeta = aux_p["gu0"] + aux_p["Huu"] * du - sol.beta
    de = jl.constraint_direction(model, limits, dq, dv, du, da)
    ds, dz_ = pdipm.expand_slack_dual(aux_p["e"], sol.slack, sol.dual,
                                      barrier, de, limits.mask)
    a_p = pdipm.fraction_to_boundary(sol.slack, ds, ftb, limits.mask,
                                     batch_dims=1)
    a_d = pdipm.fraction_to_boundary(sol.dual, dz_, ftb, limits.mask,
                                     batch_dims=1)
    if enable_ls and filt is not None:
        def trial(alpha):
            ap = alpha[..., None, None]
            return sol.replace(q=sol.q + ap * dq, v=sol.v + ap * dv,
                               a=sol.a + ap * da, u=sol.u + ap * du,
                               slack=sol.slack + ap * ds)

        def eval_fn(s):
            return _eval_parnmpc(model, cost, limits, dt, barrier, t0, s,
                                 q_init, v_init)

        a_p, filt = uls.filter_step(eval_fn, sol, trial, a_p, filt, it,
                                    ls_reduction, ls_min_step)
    ap, ad = a_p[:, None, None], a_d[:, None, None]
    new = ParNMPCSolution(
        q=sol.q + ap * dq, v=sol.v + ap * dv, a=sol.a + ap * da,
        u=sol.u + ap * du, lmd=sol.lmd + ap * dlmd, gmm=sol.gmm + ap * dgmm,
        beta=sol.beta + ap * dbeta, slack=sol.slack + ap * ds,
        dual=sol.dual + ad * dz_, aux=aux_new)
    # numerical-failure guard, per scenario: a non-finite direction keeps
    # the previous iterate and reports a zero step
    dir_ok = torch.stack([torch.isfinite(getattr(new, f.name)).reshape(
        new.q.shape[0], -1).all(dim=-1) for f in dataclasses.fields(new)],
        dim=0).all(dim=0)
    new = _where(dir_ok, new, sol)
    a_p = torch.where(dir_ok, a_p, torch.zeros_like(a_p))
    return new, torch.sqrt(torch.sum(kkt_sq, dim=1)), a_p, filt

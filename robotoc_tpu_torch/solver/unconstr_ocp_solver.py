"""UnconstrOCPSolver: direct multiple shooting and Riccati for fixed-base
robots without contacts (counterpart of
robotoc_tpu/solver/unconstr_ocp_solver.py; reference
src/solver/unconstr_ocp_solver.cpp:102-118).

Per grid i the primal is (q, v, a, u), with costates (lmd, gmm), the
inverse-dynamics multiplier beta and the PDIPM pairs (slack, dual) of the
joint limits:
    state equation:  q_{i+1} = q_i + dt v_i,  v_{i+1} = v_i + dt a_i
    dynamics:        u_i = ID(q_i, v_i, a_i)   (lifted inverse dynamics)
(u, beta) are condensed out, so the LQR runs over x = (q, v) with the
control a; it is solved by the serial Riccati sweep of riccati/lqr.py (the
JAX package's family calls no Pallas kernel either).

The fleet is a leading batch dimension: every function takes one problem
(fields (N+1, ...), q_init (nq,)) or a fleet (fields (B, N+1, ...),
q_init (B, nq)). The stage evaluation runs under torch.func.vmap over the
flattened B * N stages. `solve` is the Newton loop of the JAX package's
`lax.while_loop` as a host loop: one build per iteration, reused for the
next direction, and one host synchronisation per iteration for the exit
test; each scenario is frozen once it converges, fails or runs out of
iterations, and a non-finite KKT keeps its last good iterate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import vmap

from ..constraints import joint_limits as jl
from ..constraints import pdipm
from ..core.structs import LQRData, PerformanceIndex
from ..costs import base as cost_base
from ..line_search import unconstr_line_search as uls
from ..models import robot as rm
from ..riccati import lqr
from .ocp_solver import _pad0, _where


@dataclasses.dataclass
class UnconstrSolution:
    """Horizon-stacked primal-dual iterate (N+1 grids, row N terminal);
    fields may carry a leading fleet dim."""
    q: torch.Tensor      # (N+1, nq)
    v: torch.Tensor      # (N+1, nv)
    a: torch.Tensor      # (N+1, nv)   row N unused
    u: torch.Tensor      # (N+1, nv)   row N unused
    lmd: torch.Tensor    # (N+1, nv)
    gmm: torch.Tensor    # (N+1, nv)
    beta: torch.Tensor   # (N+1, nv)   row N unused
    slack: torch.Tensor  # (N, dimc)
    dual: torch.Tensor   # (N, dimc)

    def replace(self, **kw) -> "UnconstrSolution":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "UnconstrSolution":
        return type(self)(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """The JAX package's defaults (reference solver/solver_options.hpp)."""
    max_iter: int = 100
    kkt_tol: float = 1e-7
    barrier: float = 1e-3
    fraction_to_boundary_rule: float = 0.995
    enable_line_search: bool = False
    """Fletcher-Leyffer filter line search on the primal step (reference
    unconstr_line_search.hpp:29; off by default, as in the reference)."""
    ls_reduction: float = 0.75
    ls_min_step: float = 0.05


class UnconstrOCPSolver:
    """Holds the problem; the iterates go in and out as UnconstrSolution."""

    def __init__(self, model: rm.RobotModel, cost, limits: Optional[
            jl.JointLimits], T: float, N: int,
            options: SolverOptions = SolverOptions(), t0: float = 0.0):
        if model.floating_base:
            raise ValueError("UnconstrOCPSolver needs a fixed-base robot")
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

    def init_solution(self, q, v) -> UnconstrSolution:
        """q, v of one problem (nq,) or of a fleet (B, nq) held over the
        horizon; zero a, u, costates and beta; the PDIPM pairs at the
        barrier."""
        m = self.model
        kw = dict(dtype=m.dtype, device=m.device)
        q = torch.as_tensor(q, **kw)
        v = torch.as_tensor(v, **kw)
        lead = tuple(q.shape[:-1])
        n1 = self.N + 1
        q = q.unsqueeze(-2).expand(lead + (n1, m.nq)).contiguous()
        v = v.unsqueeze(-2).expand(lead + (n1, m.nv)).contiguous()
        z = torch.zeros(lead + (n1, m.nv), **kw)
        e = jl.constraint_values(m, self.limits, q[..., :-1, :],
                                 v[..., :-1, :], z[..., :-1, :m.dimu],
                                 z[..., :-1, :])
        s0, z0 = pdipm.init_slack_dual(e, self.options.barrier,
                                       self.limits.mask)
        return UnconstrSolution(q=q, v=v, a=z, u=z.clone(), lmd=z.clone(),
                                gmm=z.clone(), beta=z.clone(), slack=s0,
                                dual=z0)

    def update(self, q_init, v_init, sol: UnconstrSolution):
        """One Newton update without a line search: returns (sol, kkt,
        primal step)."""
        return _update(*self._args(), self.options.fraction_to_boundary_rule,
                       self.t0, sol, *self._initial(q_init, v_init))

    def solve(self, q_init, v_init, sol: Optional[UnconstrSolution] = None):
        """The Newton loop of one problem or a fleet. Returns (sol, stats):
        iterations, kkt_error, last_step_size, convergence and
        numerical_failure, one each per scenario."""
        q_init, v_init = self._initial(q_init, v_init)
        if sol is None:
            sol = self.init_solution(q_init, v_init)
        o = self.options
        return _solve(*self._args(), o.fraction_to_boundary_rule, self.t0,
                      o.max_iter, o.kkt_tol, o.enable_line_search,
                      o.ls_reduction, o.ls_min_step, sol, q_init, v_init)

    def kkt_error(self, sol, q_init, v_init):
        return _kkt_error(*self._args(), self.t0, sol,
                          *self._initial(q_init, v_init))

    def _initial(self, q_init, v_init):
        kw = dict(dtype=self.model.dtype, device=self.model.device)
        return torch.as_tensor(q_init, **kw), torch.as_tensor(v_init, **kw)


# ---------------------------------------------------------------------------
# Functional core: fleet inputs (B, ...) unless said otherwise
# ---------------------------------------------------------------------------

def _fleet(sol, q_init, v_init):
    """Give the inputs a leading fleet dim: (sol, q_init, v_init,
    batched)."""
    batched = sol.q.dim() == 3
    if not batched:
        sol = sol.map(lambda x: x.unsqueeze(0))
        q_init, v_init = q_init.unsqueeze(0), v_init.unsqueeze(0)
    return sol, q_init.expand(sol.q.shape[0], -1), \
        v_init.expand(sol.q.shape[0], -1), batched


def _stage_eval(model, cost, limits, dt, barrier, t, q, v, a, u, beta,
                lmd, gmm, lmd_n, gmm_n, q_n, v_n, s, z):
    """Everything of one intermediate grid: the LQR blocks, the expansion
    data and the KKT residual pieces (vmapped over the stages)."""
    nv = model.nv
    ID = rm.rnea(model, q, v, a)
    e_id = ID - u
    dIDdq, dIDdv, M = rm.rnea_derivatives(model, q, v, a)
    quad = cost_base.quadratize_stage(cost, model, 0, q, v, a, u,
                                      q.new_zeros(0), t, dt)
    Wq, Wv, Wa, Wu = quad.Qqq, quad.Qvv, quad.Qaa, quad.Quu
    e = jl.constraint_values(model, limits, q, v, u, a)
    Hq_d, Hv_d, Hu_d, Ha_d, gq_cd, gv_cd, gu_cd, ga_cd = jl.condense(
        model, limits, e, s, z, barrier)
    zq, zv, zu, za = jl.dual_residual(model, limits, z)
    Fq = q + dt * v - q_n
    Fv = v + dt * a - v_n
    # the full KKT residuals (for the error norm; duals at the iterate)
    lq = quad.lq + zq + dIDdq.T @ beta + lmd_n - lmd
    lv = quad.lv + zv + dIDdv.T @ beta + dt * lmd_n + gmm_n - gmm
    la = quad.la + za + M.T @ beta + dt * gmm_n
    lu = quad.lu + zu - beta
    # condensing of (u, beta): Huu du + gu0 = beta_new; the condensed
    # gradients carry J^T z and the PDIPM condensing term
    Huu_diag = torch.diagonal(Wu) + Hu_d
    gu0 = quad.lu + zu + gu_cd
    gID = gu0 + Huu_diag * e_id
    lq_t = quad.lq + zq + gq_cd + dIDdq.T @ gID + lmd_n - lmd
    lv_t = quad.lv + zv + gv_cd + dIDdv.T @ gID + dt * lmd_n + gmm_n - gmm
    la_t = quad.la + za + ga_cd + M.T @ gID + dt * gmm_n
    HJ = Huu_diag.unsqueeze(-1)
    Qqq = Wq + torch.diag(Hq_d) + dIDdq.T @ (HJ * dIDdq)
    Qqv = dIDdq.T @ (HJ * dIDdv)
    Qqa = dIDdq.T @ (HJ * M)
    Qvv = Wv + torch.diag(Hv_d) + dIDdv.T @ (HJ * dIDdv)
    Qva = dIDdv.T @ (HJ * M)
    Qaa = Wa + torch.diag(Ha_d) + M.T @ (HJ * M)
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    zero = torch.zeros_like(eye)
    A = torch.cat([torch.cat([eye, dt * eye], dim=1),
                   torch.cat([zero, eye], dim=1)], dim=0)
    Bm = torch.cat([zero, dt * eye], dim=0)
    Qxx = torch.cat([torch.cat([Qqq, Qqv], dim=1),
                     torch.cat([Qqv.T, Qvv], dim=1)], dim=0)
    Qxu = torch.cat([Qqa, Qva], dim=0)
    r_lim = pdipm.residual(e, s, limits.mask)
    c_lim = pdipm.complementarity(s, z, barrier, limits.mask)
    prim = (torch.sum(torch.abs(Fq)) + torch.sum(torch.abs(Fv))
            + torch.sum(torch.abs(e_id)) + torch.sum(torch.abs(r_lim)))
    sq = (torch.sum(Fq ** 2) + torch.sum(Fv ** 2) + torch.sum(e_id ** 2)
          + torch.sum(lq ** 2) + torch.sum(lv ** 2) + torch.sum(la ** 2)
          + torch.sum(lu ** 2) + torch.sum(r_lim ** 2)
          + torch.sum(c_lim ** 2))
    blocks = (A, Bm, torch.cat([Fq, Fv]), Qxx, Qxu, Qaa,
              torch.cat([lq_t, lv_t]), la_t)
    aux = dict(e_id=e_id, dIDdq=dIDdq, dIDdv=dIDdv, M=M, Huu_diag=Huu_diag,
               gu0=gu0, e=e)
    perf = dict(cost=quad.cost,
                barrier=pdipm.log_barrier(s, barrier, limits.mask),
                prim=prim, dual=torch.sum(torch.abs(c_lim)), sq=sq)
    return blocks, aux, perf


def _build_kkt(model, cost, limits, dt, barrier, t0, sol, q_init, v_init):
    """The LQR data (B, N, ...), the expansion data (B, N, ...), the
    PerformanceIndex (B,) and dx0 (B, 2nv) of a fleet iterate."""
    Bn, N1 = sol.q.shape[:2]
    N = N1 - 1
    ts = t0 + dt * torch.arange(N, dtype=sol.q.dtype, device=sol.q.device)

    def flat(x):
        return x.reshape((Bn * N,) + tuple(x.shape[2:]))

    def stage(*a):
        return _stage_eval(model, cost, limits, dt, barrier, *a)

    blocks, aux, perf = vmap(stage)(*[flat(x) for x in (
        ts.expand(Bn, N), sol.q[:, :-1], sol.v[:, :-1], sol.a[:, :-1],
        sol.u[:, :-1], sol.beta[:, :-1], sol.lmd[:, :-1], sol.gmm[:, :-1],
        sol.lmd[:, 1:], sol.gmm[:, 1:], sol.q[:, 1:], sol.v[:, 1:],
        sol.slack, sol.dual)])

    def unflat(x):
        return x.reshape((Bn, N) + tuple(x.shape[1:]))

    A, Bm, xres, Qxx, Qxu, Quu, lx, lu = (unflat(x) for x in blocks)
    aux = {k: unflat(x) for k, x in aux.items()}
    perf = {k: unflat(x) for k, x in perf.items()}
    tN = torch.full((Bn,), t0 + dt * N, dtype=sol.q.dtype,
                    device=sol.q.device)
    tq = vmap(lambda q, v, t: cost_base.quadratize_terminal(
        cost, model, q, v, t))(sol.q[:, -1], sol.v[:, -1], tN)
    lxN = torch.cat([tq.lq - sol.lmd[:, -1], tq.lv - sol.gmm[:, -1]],
                    dim=-1)
    zb = torch.zeros_like(tq.Qqq)
    QxxN = torch.cat([torch.cat([tq.Qqq, zb], dim=-1),
                      torch.cat([zb, tq.Qvv], dim=-1)], dim=-2)
    data = LQRData(A=A, B=Bm, xres=xres, Qxx=Qxx, Qxu=Qxu, Quu=Quu, lx=lx,
                   lu=lu, Qxx_N=QxxN, lx_N=lxN)
    dx0 = torch.cat([q_init - sol.q[:, 0], v_init - sol.v[:, 0]], dim=-1)
    perf_idx = PerformanceIndex(
        cost=torch.sum(perf["cost"], dim=1) + tq.cost,
        cost_barrier=torch.sum(perf["barrier"], dim=1),
        primal_feasibility=(torch.sum(perf["prim"], dim=1)
                            + torch.sum(torch.abs(dx0), dim=-1)),
        dual_feasibility=torch.sum(perf["dual"], dim=1),
        kkt_error=(torch.sum(perf["sq"], dim=1)
                   + torch.sum(lxN ** 2, dim=-1)
                   + torch.sum(dx0 ** 2, dim=-1)))
    return data, aux, perf_idx, dx0


def _direction_step(model, limits, barrier, ftb, built, sol, ls_ctx=None):
    """Newton direction and step of a fleet from its build. ls_ctx
    (optional): (cost, dt, t0, q_init, v_init, filt, it, reduction,
    min_step), the filter line search on the primal step (reference
    unconstr_line_search.cpp:37-70); the updated filters are then
    returned as a fifth output. Returns (sol, kkt (B,), a_p (B,), perf)."""
    data, aux, perf, dx0 = built
    dx, da, dlmdgmm, _ = lqr.solve(data, dx0)
    nv = model.nv
    dq_all, dv_all = dx[..., :nv], dx[..., nv:]
    dq, dv = dq_all[:, :-1], dv_all[:, :-1]
    du = (torch.einsum("bnij,bnj->bni", aux["dIDdq"], dq)
          + torch.einsum("bnij,bnj->bni", aux["dIDdv"], dv)
          + torch.einsum("bnij,bnj->bni", aux["M"], da) + aux["e_id"])
    dbeta = aux["gu0"] + aux["Huu_diag"] * du - sol.beta[:, :-1]
    de = jl.constraint_direction(model, limits, dq, dv, du, da)
    ds, dz = pdipm.expand_slack_dual(aux["e"], sol.slack, sol.dual, barrier,
                                     de, limits.mask)
    a_p = pdipm.fraction_to_boundary(sol.slack, ds, ftb, limits.mask,
                                     batch_dims=1)
    a_d = pdipm.fraction_to_boundary(sol.dual, dz, ftb, limits.mask,
                                     batch_dims=1)
    filt = None
    if ls_ctx is not None:
        cost, dt, t0, q_init, v_init, filt, it, red, min_step = ls_ctx

        def trial(alpha):
            ap = alpha[..., None, None]
            return sol.replace(q=sol.q + ap * dq_all, v=sol.v + ap * dv_all,
                               a=sol.a + ap * _pad0(da),
                               u=sol.u + ap * _pad0(du),
                               slack=sol.slack + ap * ds)

        a_p, filt = uls.primal_step_size(
            model, cost, limits, dt, barrier, t0, sol, q_init, v_init, trial,
            a_p, filt, it, reduction=red, min_step=min_step)
    ap, ad = a_p[:, None, None], a_d[:, None, None]
    new = UnconstrSolution(
        q=sol.q + ap * dq_all, v=sol.v + ap * dv_all,
        a=sol.a + ap * _pad0(da), u=sol.u + ap * _pad0(du),
        lmd=sol.lmd + ap * dlmdgmm[..., :nv],
        gmm=sol.gmm + ap * dlmdgmm[..., nv:],
        beta=sol.beta + ap * _pad0(dbeta), slack=sol.slack + ap * ds,
        dual=sol.dual + ad * dz)
    out = (new, torch.sqrt(perf.kkt_error), a_p, perf)
    return out + (filt,) if ls_ctx is not None else out


def _update(model, cost, limits, dt, barrier, ftb, t0, sol, q_init, v_init):
    """One Newton update of one problem or a fleet: (sol, kkt, a_p), the
    kkt that of the iterate given."""
    sol_b, q_b, v_b, batched = _fleet(sol, q_init, v_init)
    built = _build_kkt(model, cost, limits, dt, barrier, t0, sol_b, q_b,
                       v_b)
    new, kkt, a_p, _ = _direction_step(model, limits, barrier, ftb, built,
                                       sol_b)
    if not batched:
        return new.map(lambda x: x[0]), kkt[0], a_p[0]
    return new, kkt, a_p


def _kkt_error(model, cost, limits, dt, barrier, t0, sol, q_init, v_init):
    sol_b, q_b, v_b, batched = _fleet(sol, q_init, v_init)
    kkt = torch.sqrt(_build_kkt(model, cost, limits, dt, barrier, t0, sol_b,
                                q_b, v_b)[2].kkt_error)
    return kkt if batched else kkt[0]


def _solve(model, cost, limits, dt, barrier, ftb, t0, max_iter, kkt_tol,
           enable_ls, ls_reduction, ls_min_step, sol, q_init, v_init):
    """The Newton loop with ONE build per iteration (the build of the
    convergence check is reused for the next direction). Each scenario
    runs while its (it < max_iter) & (kkt > kkt_tol) & ok holds; a
    non-finite KKT keeps its last good iterate and ends it with
    convergence False. With enable_ls each scenario carries its filter,
    its slot the scenario's iteration count. One host synchronisation per
    iteration (the exit test). The stats' kkt_history (B, max_iter) holds
    each scenario's KKT after each of its iterations (NaN after its
    last)."""
    sol_b, q_b, v_b, batched = _fleet(sol, q_init, v_init)
    Bn, dtype, dev = sol_b.q.shape[0], sol_b.q.dtype, sol_b.q.device

    def do_build(s):
        return _build_kkt(model, cost, limits, dt, barrier, t0, s, q_b, v_b)

    built = do_build(sol_b)
    kkt = torch.sqrt(built[2].kkt_error)
    ok = torch.isfinite(kkt)
    it = torch.zeros(Bn, dtype=torch.long, device=dev)
    alpha = torch.ones(Bn, dtype=dtype, device=dev)
    filt = uls.empty_filter(dtype, dev, (Bn,))
    kkt_h = torch.full((Bn, max_iter), float("nan"), dtype=dtype,
                       device=dev)
    rows = torch.arange(Bn, device=dev)
    for _ in range(max_iter):
        run = (it < max_iter) & (kkt > kkt_tol) & ok
        if not bool(run.any()):
            break
        ls_ctx = ((cost, dt, t0, q_b, v_b, filt, it, ls_reduction,
                   ls_min_step) if enable_ls else None)
        out = _direction_step(model, limits, barrier, ftb, built, sol_b,
                              ls_ctx)
        new, a_p = out[0], out[2]
        if enable_ls:
            filt = torch.where(run[:, None, None], out[4], filt)
        built = do_build(new)
        kkt_new = torch.sqrt(built[2].kkt_error)
        ok_new = torch.isfinite(kkt_new)
        sol_b = _where(run & ok_new, new, sol_b)
        kkt = torch.where(run & ok_new, kkt_new, kkt)
        ok = torch.where(run, ok_new, ok)
        alpha = torch.where(run, a_p, alpha)
        slot = torch.clamp(it, max=max_iter - 1)
        kkt_h[rows, slot] = torch.where(run, kkt, kkt_h[rows, slot])
        it = it + run.to(it.dtype)
    st = dict(iterations=it, kkt_error=kkt, last_step_size=alpha,
              convergence=(kkt <= kkt_tol) & ok, numerical_failure=~ok,
              kkt_history=kkt_h)
    if not batched:
        sol_b = sol_b.map(lambda x: x[0])
        st = {k: v[0] for k, v in st.items()}
    return sol_b, st

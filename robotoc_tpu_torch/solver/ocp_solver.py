"""OCPSolver: the contact-OCP Newton update over a fleet of scenarios.

Counterpart of robotoc_tpu/solver/ocp_solver.py (the `n_imp == 0` path).
One Newton update: the per-stage evaluation `stage_pre`, vmapped over the
flattened B * N stages of the fleet; the four condense kernels on that
flat stage batch (ops/condense.py); the Riccati backward sweep kernel over
the B scenarios (riccati/backward_sweep.py) and a forward rollout; the
vmapped stage expansion; fraction-to-boundary step sizes and the manifold
update.

The fleet is a leading batch dimension written out here. `update` takes
either one scenario (Solution fields (S, ...), q_init (nq,)) or a fleet
(fields (B, S, ...), q_init (B, nq)); the grid is shared by the fleet or
carries the same leading B.

Not ported yet, and refused with NotImplementedError rather than ignored:
impact slots (n_reserved_events > 0) and with them the switching
constraints, line search, the associative-scan Riccati, and the Newton
loop `solve`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from ..constraints import friction_cone as fc
from ..constraints import joint_limits as jl
from ..constraints import pdipm
from ..core.structs import LQRData
from ..costs import base as cost_base
from ..models import robot as rm
from ..ocp import contact_stage as stage
from ..ops import condense as cd
from ..planner.contact_sequence import GridData
from ..riccati import backward_sweep


@dataclasses.dataclass
class Solution:
    """Horizon-stacked primal-dual iterate; fields may carry a leading
    fleet dim before the slot dim."""
    q: torch.Tensor        # (S, nq)
    v: torch.Tensor        # (S, nv)
    a: torch.Tensor        # (S, nv)
    u: torch.Tensor        # (S, dimu)
    f: torch.Tensor        # (S, nf)
    lmd: torch.Tensor      # (S, nv)
    gmm: torch.Tensor      # (S, nv)
    beta: torch.Tensor     # (S, nv)
    mu: torch.Tensor       # (S, nf)
    s_lim: torch.Tensor    # (S-1, 8*dimu)
    z_lim: torch.Tensor
    s_cone: torch.Tensor   # (S-1, dimc_cone)
    z_cone: torch.Tensor
    xi: torch.Tensor       # (S, nf) switching-constraint multipliers

    def replace(self, **kw) -> "Solution":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "Solution":
        return Solution(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    barrier: float = 1e-3
    fraction_to_boundary_rule: float = 0.995
    parallel_riccati: bool = False
    enable_line_search: bool = False
    switching_constraints: bool = False
    use_kernels: bool = True
    """Condense and Riccati backward sweep through the hand-written CUDA
    kernels (on CUDA tensors; on CPU tensors the wrappers run the plain
    versions). False forces the plain PyTorch versions everywhere."""


class OCPSolver:
    def __init__(self, model: rm.RobotModel, contacts, costs, limits,
                 T: float, N: int,
                 options: SolverOptions = SolverOptions(),
                 n_reserved_events: int = 0):
        if n_reserved_events:
            raise NotImplementedError("impact slots (n_reserved_events > 0)"
                                      " are not ported yet")
        for flag in ("parallel_riccati", "enable_line_search",
                     "switching_constraints"):
            if getattr(options, flag):
                raise NotImplementedError(f"SolverOptions.{flag} is not "
                                          "ported yet")
        self.model = model
        self.contacts = contacts
        self.costs = tuple(costs) if isinstance(costs, (tuple, list)) \
            else (costs,)
        self.limits = limits if limits is not None \
            else jl.make_joint_limits(model)
        self.T, self.N = float(T), int(N)
        self.options = options
        self.device = model.device

    def init_solution(self, grid: GridData, q, v,
                      f_init: Optional[torch.Tensor] = None) -> Solution:
        return make_initial_solution(self.model, self.contacts, self.limits,
                                     self.options.barrier, grid, q, v,
                                     f_init)

    def update(self, grid: GridData, q_init, v_init, sol: Solution,
               costs=None):
        """One Newton update: returns (sol, kkt, primal step, policy)."""
        o = self.options
        return _update(self.model, self.contacts, self.limits, o.barrier,
                       o.fraction_to_boundary_rule, costs or self.costs, sol,
                       grid, q_init, v_init, use_kernels=o.use_kernels)

    def solve(self, *args, **kwargs):
        raise NotImplementedError("the Newton loop `solve` is not ported "
                                  "yet; call `update` repeatedly")


# ---------------------------------------------------------------------------

def make_initial_solution(model, contacts, limits, barrier, grid: GridData,
                          q, v, f_init=None) -> Solution:
    """Constant-(q, v) warm start for one scenario; stance forces share the
    robot's weight; PDIPM slacks/duals strictly feasible."""
    n1 = grid.n_slots
    nf = contacts.max_dimf
    kw = dict(dtype=model.dtype, device=model.device)
    q = torch.as_tensor(q, **kw).expand(n1, model.nq)
    v = torch.as_tensor(v, **kw).expand(n1, model.nv)
    znv = torch.zeros((n1, model.nv), **kw)
    if f_init is None:
        n_active = torch.clamp(torch.sum(grid.contact_mask, dim=1), min=1.0)
        fz = model.total_mass * 9.81 / n_active
        cols = []
        for c in range(contacts.n_contacts):
            z = torch.zeros((n1, contacts.types[c]), **kw)
            cols.append(torch.cat([z[:, :2], (fz * grid.contact_mask[:, c])
                                   .unsqueeze(-1), z[:, 3:]], dim=-1))
        f_init = torch.cat(cols, dim=-1)
    sol = Solution(
        q=q, v=v, a=znv, u=torch.zeros((n1, model.dimu), **kw),
        f=torch.as_tensor(f_init, **kw), lmd=znv, gmm=znv, beta=znv,
        mu=torch.zeros((n1, nf), **kw),
        s_lim=torch.zeros((n1 - 1, 0), **kw),
        z_lim=torch.zeros((n1 - 1, 0), **kw),
        s_cone=torch.zeros((n1 - 1, 0), **kw),
        z_cone=torch.zeros((n1 - 1, 0), **kw),
        xi=torch.zeros((n1, nf), **kw))
    return reinit_constraints(model, contacts, limits, barrier, grid, sol)


def reinit_constraints(model, contacts, limits, barrier, grid: GridData,
                       sol: Solution) -> Solution:
    """(Re-)initialise the PDIPM slack/dual pairs from the primal iterate
    of one scenario."""
    e_lim = jl.constraint_values(model, limits, sol.q[:-1], sol.v[:-1],
                                 sol.u[:-1], sol.a[:-1])
    s_lim, z_lim = pdipm.init_slack_dual(e_lim, barrier, limits.mask)
    cone_mask = contacts.cone_mask(grid.contact_mask[:-1]) > 0
    f_mask = contacts.force_mask(grid.contact_mask[:-1])
    g_cone = vmap(lambda qq, ff, fr: fc.residual_and_jac(
        model, contacts, qq, ff, fr)[0])(
        sol.q[:-1], sol.f[:-1] * f_mask, grid.friction[:-1])
    s_cone, z_cone = pdipm.init_slack_dual(g_cone, barrier, cone_mask)
    return sol.replace(s_lim=s_lim, z_lim=z_lim, s_cone=s_cone,
                       z_cone=z_cone)


def _fleet(sol: Solution, grid: GridData, q_init, v_init):
    """Give every input a leading fleet dim. Returns (sol, grid, q_init,
    v_init, batched) with the grid expanded to the fleet."""
    batched = sol.q.dim() == 3
    if not batched:
        sol = sol.map(lambda x: x.unsqueeze(0))
        q_init, v_init = q_init.unsqueeze(0), v_init.unsqueeze(0)
    B = sol.q.shape[0]
    if grid.t.dim() == 1:
        grid = GridData(**{f.name: getattr(grid, f.name).expand(
            (B,) + getattr(grid, f.name).shape)
            for f in dataclasses.fields(grid)})
    return sol, grid, q_init, v_init, batched


def _flat(x):
    """(B, N, ...) -> (B*N, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def stage_inputs(model, contacts, limits, barrier, costs, sol: Solution,
                 grid: GridData) -> dict:
    """`stage_pre` of every stage of a fleet (leading B), vmapped over the
    flattened B*N stages: the condense inputs (ops/condense.IN_NAMES) and
    the pass-through "aux_" fields, each (B*N, ...)."""
    def pre_fn(*args):
        return stage.stage_pre(model, contacts, costs, limits, *args)

    dt = grid.dt
    pre_args = (grid.t[:, :-1], dt, torch.full_like(dt, barrier),
                sol.q[:, :-1], sol.v[:, :-1], sol.a[:, :-1], sol.u[:, :-1],
                sol.f[:, :-1], sol.beta[:, :-1], sol.mu[:, :-1],
                sol.lmd[:, :-1], sol.gmm[:, :-1], sol.lmd[:, 1:],
                sol.gmm[:, 1:], sol.q[:, 1:], sol.v[:, 1:], sol.s_lim,
                sol.z_lim, sol.s_cone, sol.z_cone, grid.contact_mask[:, :-1],
                grid.p_ref[:, :-1], grid.friction[:, :-1],
                grid.R_ref[:, :-1])
    return vmap(pre_fn)(*[_flat(x) for x in pre_args])


def _build(model, contacts, limits, barrier, costs, sol: Solution,
           grid: GridData, q_init, v_init, use_kernels=True):
    """Fleet inputs (leading B). Per-stage evaluation vmapped over the
    flattened B*N stages, condensing on the flat stage batch, terminal
    quadratization per scenario. Returns (LQRData (B, N, ...), StageBlocks
    (B*N, ...), dx0 (B, nx), kkt_sq (B,), total_cost (B,))."""
    nv, nu_dim = model.nv, model.dimu
    nf = contacts.max_dimf
    B, S = sol.q.shape[0], sol.q.shape[1]
    N = S - 1
    pre = stage_inputs(model, contacts, limits, barrier, costs, sol, grid)
    kin = {k: v for k, v in pre.items() if not k.startswith("aux_")}
    ko = cd.condense(kin, use_kernels=use_kernels)
    blocks = stage.stage_finish(nv, nu_dim, nf, pre, ko)

    tq = vmap(lambda q, v, t: cost_base.quadratize_terminal(
        costs, model, q, v, t))(sol.q[:, -1], sol.v[:, -1], grid.t[:, -1])
    lxN = torch.cat([tq.lq - sol.lmd[:, -1], tq.lv - sol.gmm[:, -1]], dim=-1)
    zb = torch.zeros_like(tq.Qqq)
    QxxN = torch.cat([torch.cat([tq.Qqq, zb], dim=-1),
                      torch.cat([zb, tq.Qvv], dim=-1)], dim=-2)
    fleet = lambda x: x.reshape((B, N) + tuple(x.shape[1:]))   # noqa: E731
    data = LQRData(A=fleet(blocks.A), B=fleet(blocks.B),
                   xres=fleet(blocks.xres), Qxx=fleet(blocks.Qxx),
                   Qxu=fleet(blocks.Qxu), Quu=fleet(blocks.Quu),
                   lx=fleet(blocks.lx), lu=fleet(blocks.lu), Qxx_N=QxxN,
                   lx_N=lxN)
    dq0 = rm.difference(model, sol.q[:, 0], q_init)
    dx0 = torch.cat([dq0, v_init - sol.v[:, 0]], dim=-1)
    kkt_sq = (torch.sum(fleet(blocks.kkt_sq), dim=1)
              + torch.sum(lxN ** 2, dim=-1) + torch.sum(dx0 ** 2, dim=-1))
    total_cost = torch.sum(fleet(blocks.cost), dim=1) + tq.cost
    return data, blocks, dx0, kkt_sq, total_cost


class Directions(NamedTuple):
    """Full primal-dual Newton direction of a fleet (leading B)."""
    dq_all: torch.Tensor
    dv_all: torch.Tensor
    da: torch.Tensor
    du: torch.Tensor
    df: torch.Tensor
    dlmd: torch.Tensor
    dgmm: torch.Tensor
    dbeta: torch.Tensor
    dmu: torch.Tensor
    ds_lim: torch.Tensor
    dz_lim: torch.Tensor
    ds_cone: torch.Tensor
    dz_cone: torch.Tensor
    cone_mask: torch.Tensor
    dxi: torch.Tensor


def _expand_directions(model, contacts, limits, barrier, blocks,
                       sol: Solution, grid: GridData, dx, du,
                       dlmd_all) -> Directions:
    """Recover (da, df, dbeta, dmu, slack/dual directions) of every stage
    from the LQR directions, vmapped over the flat B*N stages."""
    nv = model.nv
    B, N = du.shape[0], du.shape[1]
    dq, dv = dx[:, :-1, :nv], dx[:, :-1, nv:]
    dlmd, dgmm = dlmd_all[..., :nv], dlmd_all[..., nv:]

    def exp_fn(blk, *args):
        return stage.expand(model, contacts, limits, barrier, blk, *args)

    args = (dq, dv, du, sol.gmm[:, 1:] + dgmm[:, 1:], grid.dt,
            sol.f[:, :-1], sol.beta[:, :-1], sol.mu[:, :-1], sol.s_lim,
            sol.z_lim, sol.s_cone, sol.z_cone, grid.contact_mask[:, :-1])
    out = vmap(exp_fn)(blocks, *[_flat(x) for x in args])
    (da, df, dbeta, dmu, ds_lim, dz_lim, ds_cone, dz_cone, cone_mask) = [
        x.reshape((B, N) + tuple(x.shape[1:])) for x in out]
    return Directions(dq_all=dx[..., :nv], dv_all=dx[..., nv:], da=da,
                      du=du, df=df, dlmd=dlmd, dgmm=dgmm, dbeta=dbeta,
                      dmu=dmu, ds_lim=ds_lim, dz_lim=dz_lim,
                      ds_cone=ds_cone, dz_cone=dz_cone, cone_mask=cone_mask,
                      dxi=torch.zeros_like(sol.xi[:, :-1]))


def _step_sizes(limits, ftb, sol: Solution, d: Directions):
    """Fraction-to-boundary primal/dual step sizes, one per scenario."""
    ftb_ = lambda x, dx, mask: pdipm.fraction_to_boundary(   # noqa: E731
        x, dx, ftb, mask, batch_dims=1)
    a_p = torch.minimum(ftb_(sol.s_lim, d.ds_lim, limits.mask),
                        ftb_(sol.s_cone, d.ds_cone, d.cone_mask))
    a_d = torch.minimum(ftb_(sol.z_lim, d.dz_lim, limits.mask),
                        ftb_(sol.z_cone, d.dz_cone, d.cone_mask))
    return a_p, a_d


def _pad0(x):
    return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)


def _integrate_solution(model, sol: Solution, d: Directions, a_p, a_d):
    """Manifold primal update + dual update with separate step sizes."""
    ap, ad = a_p[:, None, None], a_d[:, None, None]
    return Solution(
        q=rm.integrate(model, sol.q, ap * d.dq_all),
        v=sol.v + ap * d.dv_all,
        a=sol.a + ap * _pad0(d.da),
        u=sol.u + ap * _pad0(d.du),
        f=sol.f + ap * _pad0(d.df),
        lmd=sol.lmd + ap * d.dlmd,
        gmm=sol.gmm + ap * d.dgmm,
        beta=sol.beta + ap * _pad0(d.dbeta),
        mu=sol.mu + ap * _pad0(d.dmu),
        s_lim=sol.s_lim + ap * d.ds_lim,
        z_lim=sol.z_lim + ad * d.dz_lim,
        s_cone=sol.s_cone + ap * d.ds_cone,
        z_cone=sol.z_cone + ad * d.dz_cone,
        xi=sol.xi + ap * _pad0(d.dxi))


def _direction_and_step(model, contacts, limits, barrier, ftb,
                        sol: Solution, grid: GridData, built,
                        use_kernels=True):
    """Newton direction + fraction-to-boundary step from a build (fleet
    inputs). Returns (sol, kkt (B,), a_p (B,), policy)."""
    data, blocks, dx0, kkt_sq, _ = built
    dx, du, dlmd_all, policy = backward_sweep.solve(data, dx0,
                                                    use_kernels=use_kernels)
    d = _expand_directions(model, contacts, limits, barrier, blocks, sol,
                           grid, dx, du, dlmd_all)
    # numerical-failure guard, per scenario and without a host sync: a
    # non-finite direction zeroes that scenario's step
    floats = [x for x in d if x.dtype.is_floating_point]
    dir_ok = torch.stack([torch.isfinite(x.reshape(x.shape[0], -1)
                                         .sum(dim=-1)) for x in floats],
                         dim=0).all(dim=0)

    def guard(x):
        if not x.dtype.is_floating_point:
            return x
        ok = dir_ok.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(ok, x, torch.zeros_like(x))

    d = Directions(*[guard(x) for x in d])
    a_p, a_d = _step_sizes(limits, ftb, sol, d)
    a_p = torch.where(dir_ok, a_p, torch.zeros_like(a_p))
    a_d = torch.where(dir_ok, a_d, torch.zeros_like(a_d))
    new = _integrate_solution(model, sol, d, a_p, a_d)
    return new, torch.sqrt(kkt_sq), a_p, policy


def _update(model, contacts, limits, barrier, ftb, costs, sol: Solution,
            grid: GridData, q_init, v_init, use_kernels=True):
    """One Newton update of one scenario or a fleet (see module doc)."""
    sol_b, grid_b, q_b, v_b, batched = _fleet(sol, grid, q_init, v_init)
    built = _build(model, contacts, limits, barrier, costs, sol_b, grid_b,
                   q_b, v_b, use_kernels=use_kernels)
    new, kkt, a_p, policy = _direction_and_step(
        model, contacts, limits, barrier, ftb, sol_b, grid_b, built,
        use_kernels=use_kernels)
    if not batched:
        new = new.map(lambda x: x[0])
        kkt, a_p = kkt[0], a_p[0]
    return new, kkt, a_p, policy


def _kkt_error(model, contacts, limits, barrier, costs, sol, grid, q_init,
               v_init, use_kernels=True):
    sol_b, grid_b, q_b, v_b, batched = _fleet(sol, grid, q_init, v_init)
    kkt = torch.sqrt(_build(model, contacts, limits, barrier, costs, sol_b,
                            grid_b, q_b, v_b, use_kernels=use_kernels)[3])
    return kkt if batched else kkt[0]

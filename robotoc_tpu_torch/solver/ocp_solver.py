"""OCPSolver: the contact-OCP Newton update over a fleet of scenarios.

Counterpart of robotoc_tpu/solver/ocp_solver.py. One Newton update: the
chain kernel K6 over every stage slot of the fleet (ops/chain.py, with the
gait cost stack folded in when the stack allows it); the per-stage
evaluation `stage_pre`, vmapped over the flattened B * (S-1) stage slots;
the impact stages on the reserved impact slots (gather -> scatter); the
four condense kernels on the flat stage batch (ops/condense.py); the
switching-constraint rows two slots before each impact; the Riccati
backward sweep kernel over the B scenarios (riccati/backward_sweep.py) and
a forward rollout; the vmapped stage and impact expansions;
fraction-to-boundary step sizes and the manifold update.

The fleet is a leading batch dimension written out here. `update` takes
either one scenario (Solution fields (S, ...), q_init (nq,)) or a fleet
(fields (B, S, ...), q_init (B, nq)); the grid is shared by the fleet or
carries the same leading B.

Not ported yet, and refused with NotImplementedError rather than ignored:
line search, the associative-scan Riccati and the Newton loop `solve`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from ..constraints import friction_cone as fc
from ..constraints import joint_limits as jl
from ..constraints import pdipm
from ..core.structs import LQRData
from ..costs import base as cost_base
from ..dynamics import switching_constraint as swc
from ..dynamics.contact_dynamics import ty_solve
from ..models import robot as rm
from ..ocp import contact_stage as stage
from ..ocp import impact_stage as istage
from ..ops import chain as chn
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
    use_chain: Optional[bool] = None
    """Stage derivatives through the chain kernel K6 (ops/chain.py) instead
    of the per-stage jacfwd; None follows use_kernels, True needs it."""


class OCPSolver:
    def __init__(self, model: rm.RobotModel, contacts, costs, limits,
                 T: float, N: int,
                 options: SolverOptions = SolverOptions(),
                 n_reserved_events: int = 0):
        for flag in ("parallel_riccati", "enable_line_search"):
            if getattr(options, flag):
                raise NotImplementedError(f"SolverOptions.{flag} is not "
                                          "ported yet")
        self.n_reserved_events = int(n_reserved_events)
        self.enable_sw = (bool(options.switching_constraints)
                          and self.n_reserved_events > 0)
        self.use_chain = (options.use_kernels if options.use_chain is None
                          else bool(options.use_chain))
        if self.use_chain and not options.use_kernels:
            raise ValueError("use_chain runs the chain kernel K6; it needs "
                             "use_kernels=True")
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
                       grid, q_init, v_init, use_kernels=o.use_kernels,
                       n_imp=self.n_reserved_events, enable_sw=self.enable_sw,
                       use_chain=self.use_chain)

    def kkt_error(self, grid: GridData, q_init, v_init, sol: Solution,
                  costs=None):
        o = self.options
        return _kkt_error(self.model, self.contacts, self.limits, o.barrier,
                          costs or self.costs, sol, grid, q_init, v_init,
                          use_kernels=o.use_kernels,
                          n_imp=self.n_reserved_events,
                          enable_sw=self.enable_sw, use_chain=self.use_chain)

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


def _take(x, idx):
    """x (B, L, ...) at per-scenario slots idx (B, n) -> (B*n, ...)."""
    rows = torch.arange(x.shape[0], device=x.device).unsqueeze(-1)
    return _flat(x[rows, idx])


def _impact_slots(grid: GridData, n_imp: int):
    """(B, n_imp) indices of the impact/pass-through stage slots, in
    order. The grid builder guarantees exactly n_imp of them per scenario;
    a stable sort finds them without a host synchronisation."""
    flags = (grid.is_impact[:, :-1] <= 0).to(torch.int8)
    return torch.argsort(flags, dim=1, stable=True)[:, :n_imp]


def _flat_slots(idx, n_stage):
    """Per-scenario slot indices (B, n) -> indices into the flattened
    (B * n_stage) stage batch."""
    rows = torch.arange(idx.shape[0], device=idx.device).unsqueeze(-1)
    return (rows * n_stage + idx).reshape(-1)


def stage_inputs(model, contacts, limits, barrier, costs, sol: Solution,
                 grid: GridData, use_chain=False) -> dict:
    """`stage_pre` of every stage slot of a fleet (leading B), vmapped over
    the flattened B*(S-1) slots: the condense inputs (ops/condense.IN_NAMES)
    and the pass-through "aux_" fields, each (B*(S-1), ...). With use_chain
    the chain kernel K6 evaluates the stage derivatives of every slot in
    one launch first (its plain version on CPU tensors)."""
    def pre_fn(*args, chain_out=None):
        return stage.stage_pre(model, contacts, costs, limits, *args,
                               chain_out=chain_out)

    dt = grid.dt
    pre_args = [_flat(x) for x in (
        grid.t[:, :-1], dt, torch.full_like(dt, barrier),
        sol.q[:, :-1], sol.v[:, :-1], sol.a[:, :-1], sol.u[:, :-1],
        sol.f[:, :-1], sol.beta[:, :-1], sol.mu[:, :-1],
        sol.lmd[:, :-1], sol.gmm[:, :-1], sol.lmd[:, 1:],
        sol.gmm[:, 1:], sol.q[:, 1:], sol.v[:, 1:], sol.s_lim,
        sol.z_lim, sol.s_cone, sol.z_cone, grid.contact_mask[:, :-1],
        grid.p_ref[:, :-1], grid.friction[:, :-1], grid.R_ref[:, :-1])]
    if not use_chain:
        return vmap(pre_fn)(*pre_args)
    rowmask = contacts.force_mask(grid.contact_mask[:, :-1])
    cost_ins = (chn.cost_fold_inputs(model, contacts, costs, grid, sol)
                if chn.cost_fold_supported(model, costs, contacts) else ())
    co = chn.chain(model, contacts, *[_flat(x).contiguous() for x in (
        sol.q[:, :-1], sol.v[:, :-1], sol.a[:, :-1],
        sol.f[:, :-1] * rowmask, grid.friction[:, :-1],
        grid.p_ref[:, :-1], grid.R_ref[:, :-1])], *cost_ins)
    return vmap(lambda c, *a: pre_fn(*a, chain_out=c))(co, *pre_args)


def _impact_inputs(model, contacts, limits, barrier, costs, sol, grid, idx):
    """`impact_stage.stage_pre` of the impact slots idx (B, n_imp),
    vmapped over the B*n_imp slots."""
    def g(x):
        return _take(x, idx)

    dt = g(grid.dt)
    return vmap(lambda *a: istage.stage_pre(model, contacts, costs, limits,
                                            *a))(
        g(grid.t[:, :-1]), dt, torch.full_like(dt, barrier),
        g(sol.q[:, :-1]), g(sol.v[:, :-1]), g(sol.a[:, :-1]),
        g(sol.u[:, :-1]), g(sol.f[:, :-1]), g(sol.beta[:, :-1]),
        g(sol.mu[:, :-1]), g(sol.lmd[:, :-1]), g(sol.gmm[:, :-1]),
        g(sol.lmd[:, 1:]), g(sol.gmm[:, 1:]), g(sol.q[:, 1:]),
        g(sol.v[:, 1:]), g(sol.s_lim), g(sol.z_lim), g(sol.s_cone),
        g(sol.z_cone), g(grid.imp_mask[:, :-1]), g(grid.p_ref[:, :-1]),
        g(grid.friction[:, :-1]))


def _switching(model, contacts, sol, grid, blocks, idx):
    """Switching-constraint rows at the slots two before each impact slot
    idx (B, n_imp): corrected blocks (lx, lu, kkt_sq), the LQR rows
    (Phix, Phiu, Pc, sw), each (B, S-1, ...), and (flat constrained slot
    indices, Phia) for the dual correction of the direction."""
    nv, nu = model.nv, model.dimu
    B, S1 = idx.shape[0], grid.dt.shape[1]
    idx_sw = torch.clamp(idx - 2, min=0)
    idx_m1 = torch.clamp(idx - 1, min=0)
    imp = grid.is_impact[:, :-1]
    rows = torch.arange(B, device=idx.device).unsqueeze(-1)
    # the two slots before the impact slot must be intermediate stages
    valid = (idx >= 2) & (imp[rows, idx_m1] == 0) & (imp[rows, idx_sw] == 0)
    sw_cmask = _take(grid.imp_mask, idx) * _flat(valid).unsqueeze(-1).to(
        sol.q.dtype)
    P_res, Phiq, Phiv, Phia = vmap(
        lambda *a: swc.residual_and_jacs(model, contacts, *a))(
        _take(sol.q[:, :-1], idx_sw), _take(sol.v[:, :-1], idx_sw),
        _take(sol.a[:, :-1], idx_sw), _take(grid.dt, idx_sw),
        _take(grid.dt, idx_m1), _take(grid.p_ref, idx),
        _take(grid.R_ref, idx), sw_cmask)
    fsw = _flat_slots(idx_sw, S1)
    Phix, Phiu, Pc = swc.condense(P_res, Phiq, Phiv, Phia,
                                  blocks.G[fsw][:, :nv], blocks.c0[fsw][:, :nv],
                                  nv, nu)
    rowmask = contacts.force_mask(sw_cmask)
    xi_g = _take(sol.xi, idx_sw) * rowmask

    def rdot(Phi, x):
        return torch.einsum("kfx,kf->kx", Phi, x)

    # Lagrangian-gradient corrections on the condensed rows, and the exact
    # full-space KKT rows of the constrained slots rebuilt as a sum of
    # squares
    lq_g = blocks.lq_full[fsw] + rdot(Phiq, xi_g)
    lv_g = blocks.lv_full[fsw] + rdot(Phiv, xi_g)
    la_g = blocks.la_full[fsw] + rdot(Phia, xi_g)
    slot_sq = (blocks.kkt_rest[fsw] + torch.sum(lq_g ** 2, dim=1)
               + torch.sum(lv_g ** 2, dim=1) + torch.sum(la_g ** 2, dim=1)
               + torch.sum(P_res ** 2, dim=1))
    blocks = blocks._replace(
        lx=blocks.lx.index_add(0, fsw, rdot(Phix, xi_g)),
        lu=blocks.lu.index_add(0, fsw, rdot(Phiu, xi_g)),
        kkt_sq=blocks.kkt_sq.index_copy(0, fsw, slot_sq))

    def scatter(x):
        z = x.new_zeros((B * S1,) + tuple(x.shape[1:]))
        return z.index_add(0, fsw, x).reshape((B, S1) + tuple(x.shape[1:]))

    sw_fields = dict(Phix=scatter(Phix * rowmask.unsqueeze(-1)),
                     Phiu=scatter(Phiu * rowmask.unsqueeze(-1)),
                     Pc=scatter(Pc * rowmask), sw=scatter(rowmask))
    return blocks, sw_fields, (fsw, Phia)


def stage_pre_all(model, contacts, limits, barrier, costs, sol: Solution,
                  grid: GridData, n_imp=0, use_chain=False) -> dict:
    """The pre-condensing fields of every stage slot of a fleet
    (B*(S-1), ...): `stage_inputs`, with the impact slots re-evaluated by
    the impact stage and scattered in."""
    pre = stage_inputs(model, contacts, limits, barrier, costs, sol, grid,
                       use_chain=use_chain)
    if n_imp == 0:
        return pre
    idx = _impact_slots(grid, n_imp)
    fidx = _flat_slots(idx, grid.dt.shape[1])
    ipre = _impact_inputs(model, contacts, limits, barrier, costs, sol, grid,
                          idx)
    return {k: pre[k].index_copy(0, fidx, ipre[k])
            for k in pre}


def _build(model, contacts, limits, barrier, costs, sol: Solution,
           grid: GridData, q_init, v_init, use_kernels=True, n_imp=0,
           enable_sw=False, use_chain=False):
    """Fleet inputs (leading B). Per-stage evaluation over the flattened
    B*(S-1) slots (impact slots gathered, evaluated by the impact stage and
    scattered back), condensing on the flat stage batch, switching rows,
    terminal quadratization per scenario. Returns (LQRData (B, S-1, ...),
    StageBlocks (B*(S-1), ...), dx0 (B, nx), kkt_sq (B,), total_cost (B,),
    switching aux (None without switching rows))."""
    nv, nu_dim = model.nv, model.dimu
    nf = contacts.max_dimf
    B, S = sol.q.shape[0], sol.q.shape[1]
    N = S - 1
    pre = stage_pre_all(model, contacts, limits, barrier, costs, sol, grid,
                        n_imp=n_imp, use_chain=use_chain)
    idx = _impact_slots(grid, n_imp) if n_imp > 0 else None
    kin = {k: v for k, v in pre.items() if not k.startswith("aux_")}
    ko = cd.condense(kin, use_kernels=use_kernels)
    blocks = stage.stage_finish(nv, nu_dim, nf, pre, ko)
    sw_fields, sw_aux = {}, None
    if n_imp > 0 and enable_sw:
        blocks, sw_fields, sw_aux = _switching(model, contacts, sol, grid,
                                               blocks, idx)

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
                   lx_N=lxN, **sw_fields)
    dq0 = rm.difference(model, sol.q[:, 0], q_init)
    dx0 = torch.cat([dq0, v_init - sol.v[:, 0]], dim=-1)
    kkt_sq = (torch.sum(fleet(blocks.kkt_sq), dim=1)
              + torch.sum(lxN ** 2, dim=-1) + torch.sum(dx0 ** 2, dim=-1))
    total_cost = torch.sum(fleet(blocks.cost), dim=1) + tq.cost
    return data, blocks, dx0, kkt_sq, total_cost, sw_aux


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
                       dlmd_all, n_imp=0) -> Directions:
    """Recover (da, df, dbeta, dmu, slack/dual directions) of every stage
    slot from the LQR directions, vmapped over the flat B*(S-1) slots; the
    impact slots are expanded by the impact stage (gather -> scatter)."""
    nv = model.nv
    B, N = du.shape[0], du.shape[1]
    dq, dv = dx[:, :-1, :nv], dx[:, :-1, nv:]
    dlmd, dgmm = dlmd_all[..., :nv], dlmd_all[..., nv:]
    gmm_next = sol.gmm[:, 1:] + dgmm[:, 1:]

    def exp_fn(blk, *args):
        return stage.expand(model, contacts, limits, barrier, blk, *args)

    args = (dq, dv, du, gmm_next, grid.dt, sol.f[:, :-1], sol.beta[:, :-1],
            sol.mu[:, :-1], sol.s_lim, sol.z_lim, sol.s_cone, sol.z_cone,
            grid.contact_mask[:, :-1])
    out = list(vmap(exp_fn)(blocks, *[_flat(x) for x in args]))
    du = _flat(du)
    if n_imp > 0:
        idx = _impact_slots(grid, n_imp)
        fidx = _flat_slots(idx, N)
        iblk = type(blocks)(*[x[fidx] for x in blocks])
        g = lambda x: _take(x, idx)                # noqa: E731
        imask = g(grid.imp_mask[:, :-1])
        iout = vmap(lambda blk, *a: istage.expand(
            model, contacts, barrier, blk, *a))(
            iblk, g(dq), g(dv), g(gmm_next), g(sol.f[:, :-1]),
            g(sol.beta[:, :-1]), g(sol.mu[:, :-1]), g(sol.s_cone),
            g(sol.z_cone), imask)
        # (da, df, dbeta, dmu) and the cone pairs from the impact stage;
        # no control and no joint-limit pairs at impact slots
        for k, j in ((0, 0), (1, 1), (2, 2), (3, 3), (6, 4), (7, 5)):
            out[k] = out[k].index_copy(0, fidx, iout[j])
        for k in (4, 5):
            out[k] = out[k].index_fill(0, fidx, 0.0)
        du = du.index_fill(0, fidx, 0.0)
        icone = contacts.cone_mask(imask) > 0
        out[8] = out[8].index_copy(0, fidx, out[8][fidx] | icone)
    (da, df, dbeta, dmu, ds_lim, dz_lim, ds_cone, dz_cone, cone_mask) = [
        x.reshape((B, N) + tuple(x.shape[1:])) for x in out]
    return Directions(dq_all=dx[..., :nv], dv_all=dx[..., nv:], da=da,
                      du=du.reshape(B, N, -1), df=df, dlmd=dlmd, dgmm=dgmm,
                      dbeta=dbeta, dmu=dmu, ds_lim=ds_lim, dz_lim=dz_lim,
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


def _switching_duals(sol, data, blocks, dx, policy, sw_aux, d):
    """Switching multipliers' direction dxi = (Mx dx + mx) sw (the delta
    on xi: the condensed gradients already carry Phi^T xi_old), and the
    (beta, mu) correction at the constrained slots: the a-row stationarity
    there carries Phia^T xi_new, which the stage expansion does not see;
    by linearity it is one more contact-space solve."""
    B, N = d.dbeta.shape[0], d.dbeta.shape[1]
    dxi = (torch.einsum("bkfx,bkx->bkf", policy.Mx, dx[:, :-1])
           + policy.mx) * data.sw
    fsw, Phia = sw_aux
    xi_new = (_flat(sol.xi[:, :-1]) * _flat(data.sw) + _flat(dxi))[fsw]
    extra_ga = torch.einsum("kfv,kf->kv", Phia, xi_new)
    db_c, dm_c = ty_solve(blocks.inv11[fsw], blocks.inv12[fsw],
                          blocks.Sinv[fsw], -extra_ga,
                          torch.zeros_like(xi_new))
    dbeta = _flat(d.dbeta).index_add(0, fsw, db_c).reshape(B, N, -1)
    dmu = _flat(d.dmu).index_add(0, fsw, dm_c).reshape(B, N, -1)
    return d._replace(dxi=dxi, dbeta=dbeta, dmu=dmu)


def _direction_and_step(model, contacts, limits, barrier, ftb,
                        sol: Solution, grid: GridData, built,
                        use_kernels=True, n_imp=0):
    """Newton direction + fraction-to-boundary step from a build (fleet
    inputs). Returns (sol, kkt (B,), a_p (B,), policy)."""
    data, blocks, dx0, kkt_sq, _, sw_aux = built
    dx, du, dlmd_all, policy = backward_sweep.solve(data, dx0,
                                                    use_kernels=use_kernels)
    d = _expand_directions(model, contacts, limits, barrier, blocks, sol,
                           grid, dx, du, dlmd_all, n_imp=n_imp)
    # numerical-failure guard, per scenario and without a host sync: a
    # non-finite direction zeroes that scenario's step
    floats = [x for x in d if x.dtype.is_floating_point]
    dir_ok = torch.stack([torch.isfinite(x.reshape(x.shape[0], -1)
                                         .sum(dim=-1)) for x in floats],
                         dim=0).all(dim=0)
    if policy.Mx is not None:
        d = _switching_duals(sol, data, blocks, dx, policy, sw_aux, d)

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
            grid: GridData, q_init, v_init, use_kernels=True, n_imp=0,
            enable_sw=False, use_chain=None):
    """One Newton update of one scenario or a fleet (see module doc).
    use_chain None follows use_kernels."""
    if use_chain is None:
        use_chain = use_kernels
    sol_b, grid_b, q_b, v_b, batched = _fleet(sol, grid, q_init, v_init)
    built = _build(model, contacts, limits, barrier, costs, sol_b, grid_b,
                   q_b, v_b, use_kernels=use_kernels, n_imp=n_imp,
                   enable_sw=enable_sw, use_chain=use_chain)
    new, kkt, a_p, policy = _direction_and_step(
        model, contacts, limits, barrier, ftb, sol_b, grid_b, built,
        use_kernels=use_kernels, n_imp=n_imp)
    if not batched:
        new = new.map(lambda x: x[0])
        kkt, a_p = kkt[0], a_p[0]
    return new, kkt, a_p, policy


def _kkt_error(model, contacts, limits, barrier, costs, sol, grid, q_init,
               v_init, use_kernels=True, n_imp=0, enable_sw=False,
               use_chain=None):
    if use_chain is None:
        use_chain = use_kernels
    sol_b, grid_b, q_b, v_b, batched = _fleet(sol, grid, q_init, v_init)
    kkt = torch.sqrt(_build(model, contacts, limits, barrier, costs, sol_b,
                            grid_b, q_b, v_b, use_kernels=use_kernels,
                            n_imp=n_imp, enable_sw=enable_sw,
                            use_chain=use_chain)[3])
    return kkt if batched else kkt[0]


def align_solution(sol: Solution, old_grid: GridData, new_grid: GridData,
                   model=None, order: str = "linear") -> Solution:
    """Warm-start re-alignment of one scenario across re-discretisations:
    each new slot interpolates between its two bracketing old slots of the
    same kind in time (order "linear", manifold interpolation for q when
    `model` is given) or takes the nearest one ("zero"); impact slots map
    to the nearest old impact slot. Index computation on the host, gathers
    and one lerp on the device."""
    t_old = old_grid.t.detach().cpu().double().numpy()
    t_new = new_grid.t.detach().cpu().double().numpy()
    imp_old = old_grid.is_impact.detach().cpu().numpy() > 0
    imp_new = new_grid.is_impact.detach().cpu().numpy() > 0
    S, S_old = t_new.shape[0], t_old.shape[0]
    idx0 = np.zeros(S, dtype=np.int64)
    idx1 = np.zeros(S, dtype=np.int64)
    w = np.zeros(S)
    reg_old = np.where(~imp_old)[0]
    for i in range(S):
        if imp_new[i] or order == "zero" or len(reg_old) < 2:
            same = np.where(imp_old == imp_new[i])[0]
            if len(same) == 0:
                same = np.arange(S_old)
            j = same[np.argmin(np.abs(t_old[same] - t_new[i]))]
            idx0[i] = idx1[i] = j
        else:
            j = int(np.searchsorted(t_old[reg_old], t_new[i], side="right"))
            j = min(max(j, 1), len(reg_old) - 1)
            a, b = reg_old[j - 1], reg_old[j]
            idx0[i], idx1[i] = a, b
            dtab = t_old[b] - t_old[a]
            w[i] = 0.0 if dtab <= 1e-12 else np.clip(
                (t_new[i] - t_old[a]) / dtab, 0.0, 1.0)
    dev = sol.q.device
    i0, i1 = (torch.as_tensor(x, device=dev) for x in (idx0, idx1))
    i0s, i1s = (torch.as_tensor(np.minimum(x[:-1], S_old - 2), device=dev)
                for x in (idx0, idx1))
    wf = torch.as_tensor(w, dtype=sol.q.dtype, device=dev).unsqueeze(-1)
    ws = wf[:-1]

    def lin_full(x):
        return (1.0 - wf) * x[..., i0, :] + wf * x[..., i1, :]

    def lin_stage(x):
        return (1.0 - ws) * x[..., i0s, :] + ws * x[..., i1s, :]

    q_new = (rm.interpolate(model, sol.q[..., i0, :], sol.q[..., i1, :], wf)
             if model is not None else lin_full(sol.q))
    stage_fields = ("s_lim", "z_lim", "s_cone", "z_cone")
    return Solution(**{
        f.name: q_new if f.name == "q" else
        (lin_stage if f.name in stage_fields else lin_full)(
            getattr(sol, f.name))
        for f in dataclasses.fields(sol)})

"""Intermediate stage of the contact OCP: evaluate, condense and expand.

Counterpart of robotoc_tpu/ocp/contact_stage.py. `stage_pre` and `expand`
are per-sample functions that the solver vmaps over the flattened B*N
stage batch; the dense condensing between them runs batched in
ops/condense.py (hand-written CUDA kernels on the card, the plain PyTorch
versions on the CPU).

Stage NLP (grid i, step dt): primal (q, v, a, u, f); duals lmd/gmm
(costates), beta (inverse dynamics), mu (contact), PDIPM pairs for joint
limits and friction cones. Condensing eliminates (da, df, beta, mu)
through the symmetric contact-space KKT inverse, leaving an LQR block over
x = (dq, dv), u = du.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..constraints import joint_limits as jl
from ..constraints import pdipm
from ..costs import base as cost_base
from ..dynamics import state_equation as se
from ..dynamics.contact_dynamics import ty_solve
from ..models import contacts as ct


class StageBlocks(NamedTuple):
    # LQR blocks
    A: torch.Tensor
    B: torch.Tensor
    xres: torch.Tensor
    Qxx: torch.Tensor
    Qxu: torch.Tensor
    Quu: torch.Tensor
    lx: torch.Tensor
    lu: torch.Tensor
    # expansion data
    G: torch.Tensor        # (nv+nf, 2nv+nu)  y = G w + c0
    c0: torch.Tensor       # (nv+nf,)
    inv11: torch.Tensor
    inv12: torch.Tensor
    Sinv: torch.Tensor
    Hy: torch.Tensor       # (nv+nf, nv+nf)
    Cwy: torch.Tensor      # (2nv+nu, nv+nf)
    gy: torch.Tensor       # (nv+nf,)
    e_lim: torch.Tensor
    e_cone: torch.Tensor
    dgdq: torch.Tensor
    dgdf: torch.Tensor
    lq_full: torch.Tensor
    lv_full: torch.Tensor
    la_full: torch.Tensor
    # diagnostics
    kkt_sq: torch.Tensor
    kkt_rest: torch.Tensor
    cost: torch.Tensor
    barrier_cost: torch.Tensor
    prim_feas: torch.Tensor
    dual_feas: torch.Tensor


def stage_pre(model, contacts, costs, limits, t, dt, barrier,
              q, v, a, u, f, beta, mu, lmd, gmm, lmd_n, gmm_n,
              q_n, v_n, s_lim, z_lim, s_cone, z_cone,
              cmask, p_ref, fric, R_ref=None):
    """Everything BEFORE the dense condensing for one stage: fused chain
    derivatives, cost quadratization, PDIPM condensing vectors, state
    equation and full-KKT diagnostics. Returns the condense inputs
    (ops/condense.IN_NAMES) plus pass-through fields prefixed "aux_"."""
    nv, nu_dim = model.nv, model.dimu
    nf = contacts.max_dimf
    dtype, dev = q.dtype, q.device
    rowmask = contacts.force_mask(cmask)
    cone_mask = contacts.cone_mask(cmask) > 0
    if cost_base.kin_fold_frames(costs) == contacts.frame_ids:
        raise NotImplementedError("fused task-cost kinematics are not "
                                  "ported yet")

    f_eff = f * rowmask
    eye_u = torch.eye(nu_dim, dtype=dtype, device=dev)
    Sact = torch.cat([torch.zeros((nu_dim, nv - nu_dim), dtype=dtype,
                                  device=dev), eye_u], dim=-1)
    ((tau, C_raw, g_cone, dgdf), (dIDdq, dIDdv, M),
     (dCdq, dCdv, J), dgdq) = ct.fused_stage_derivatives(
        model, contacts, q, v, a, f_eff, fric, p_ref, R_ref)
    ID_res = tau - Sact.T @ u
    if model.generalized_momentum_bias is not None:
        ID_res = ID_res - model.generalized_momentum_bias
    C_res = C_raw * rowmask
    dCdq = dCdq * rowmask.unsqueeze(-1)
    dCdv = dCdv * rowmask.unsqueeze(-1)
    J = J * rowmask.unsqueeze(-1)

    quad = cost_base.quadratize_stage(costs, model, nf, q, v, a, u, f, t,
                                      dt)
    c, lq_c, lv_c, la_c, lu_c, lf_c = (quad.cost, quad.lq, quad.lv, quad.la,
                                       quad.lu, quad.lf)

    e_lim = jl.constraint_values(model, limits, q, v, u, a)
    Hq_d, Hv_d, Hu_d, Ha_d, gq_cd, gv_cd, gu_cd, ga_cd = jl.condense(
        model, limits, e_lim, s_lim, z_lim, barrier)
    zq, zv, zu, za = jl.dual_residual(model, limits, z_lim)
    d_cone = pdipm.condensing_diag(s_cone, z_cone, cone_mask)
    r_cone = pdipm.condensing_rhs(g_cone, s_cone, z_cone, barrier, cone_mask)
    z_cone_m = torch.where(cone_mask, z_cone, torch.zeros_like(z_cone))
    zr = z_cone_m + r_cone
    cone_gq = dgdq.T @ zr
    cone_gf = dgdf.T @ zr

    Aqq, Aqv, xres_q = se.linearize(model, q, v, dt, q_n)
    Fv_res = v + dt * a - v_n

    Tw1 = torch.cat([dIDdq, dIDdv, -Sact.T], dim=-1)
    Tw2 = torch.cat([dCdq, dCdv, torch.zeros((nf, nu_dim), dtype=dtype,
                                             device=dev)], dim=-1)
    e2 = torch.where(rowmask > 0, C_res, f)
    gw = torch.cat([lq_c + zq + gq_cd + cone_gq, lv_c + zv + gv_cd,
                    lu_c + zu + gu_cd])
    gy = torch.cat([la_c + za + ga_cd, lf_c + cone_gf])

    lq_full = (lq_c + zq + dgdq.T @ z_cone_m + dIDdq.T @ beta
               + dCdq.T @ mu + Aqq.T @ lmd_n - lmd)
    lv_full = (lv_c + zv + dIDdv.T @ beta + dCdv.T @ mu
               + Aqv.T @ lmd_n + gmm_n - gmm)
    la_full = la_c + za + M.T @ beta + J.T @ mu + dt * gmm_n
    lf_full = (lf_c + dgdf.T @ z_cone_m - J @ beta) * rowmask
    lu_full = lu_c + zu - Sact @ beta
    r_lim = pdipm.residual(e_lim, s_lim, limits.mask)
    c_lim = pdipm.complementarity(s_lim, z_lim, barrier, limits.mask)
    r_cone_p = pdipm.residual(g_cone, s_cone, cone_mask)
    c_cone = pdipm.complementarity(s_cone, z_cone, barrier, cone_mask)
    kkt_rest = (torch.sum(xres_q ** 2) + torch.sum(Fv_res ** 2)
                + torch.sum(ID_res ** 2) + torch.sum(C_res ** 2)
                + torch.sum(lf_full ** 2) + torch.sum(lu_full ** 2)
                + torch.sum(r_lim ** 2) + torch.sum(c_lim ** 2)
                + torch.sum(r_cone_p ** 2) + torch.sum(c_cone ** 2))
    kkt_sq = (kkt_rest + torch.sum(lq_full ** 2) + torch.sum(lv_full ** 2)
              + torch.sum(la_full ** 2))
    barrier_cost = (pdipm.log_barrier(s_lim, barrier, limits.mask)
                    + pdipm.log_barrier(s_cone, barrier, cone_mask))
    prim = (torch.sum(torch.abs(xres_q)) + torch.sum(torch.abs(Fv_res))
            + torch.sum(torch.abs(ID_res)) + torch.sum(torch.abs(C_res))
            + torch.sum(torch.abs(r_lim)) + torch.sum(torch.abs(r_cone_p)))
    dual = torch.sum(torch.abs(c_lim)) + torch.sum(torch.abs(c_cone))

    return dict(
        # condense inputs ("inactive" is the -D diagonal of
        # [[M, J^T], [J, -D]]: 1 on inactive rows, inv_damping on active)
        M=M, J=J, inactive=1.0 - (1.0 - contacts.inv_damping) * rowmask,
        Tw1=Tw1, Tw2=Tw2, r1=ID_res, e2=e2,
        Wq=quad.Qqq, Wv=quad.Qvv, Wu=quad.Quu, Wa=quad.Qaa, Wf=quad.Qff,
        Hq_d=Hq_d, Hv_d=Hv_d, Hu_d=Hu_d, Ha_d=Ha_d,
        dgdq=dgdq, dgdf=dgdf, d_cone=d_cone, gw=gw, gy=gy,
        Aqq=Aqq, Aqv=Aqv, xres_q=xres_q, Fv_res=Fv_res,
        sA=dt, lam2=torch.cat([lmd_n, gmm_n]),
        lmdgmm=torch.cat([lmd, gmm]),
        # pass-through to StageBlocks
        aux_e_lim=e_lim, aux_e_cone=g_cone,
        aux_lq_full=lq_full, aux_lv_full=lv_full, aux_la_full=la_full,
        aux_kkt_sq=kkt_sq, aux_kkt_rest=kkt_rest, aux_cost=c,
        aux_barrier_cost=barrier_cost, aux_prim=prim, aux_dual=dual)


def _diag(x):
    return torch.diag_embed(x)


def stage_finish(nv, nu_dim, nf, pre, ko) -> StageBlocks:
    """Assemble StageBlocks from the pre-stage aux fields and the condense
    outputs; works on batched (S, ...) tensors."""
    Ha = pre["Wa"] + _diag(pre["Ha_d"])
    Hf = ko["Hff_c"]
    zvf = Ha.new_zeros(Ha.shape[:-1] + (nf,))
    Hy = torch.cat([torch.cat([Ha, zvf], dim=-1),
                    torch.cat([zvf.transpose(-1, -2), Hf], dim=-1)], dim=-2)
    w_dim = 2 * nv + nu_dim
    Cwy = torch.cat([
        torch.cat([Ha.new_zeros(Ha.shape[:-2] + (nv, nv)), ko["coneHqf"]],
                  dim=-1),
        Ha.new_zeros(Ha.shape[:-2] + (w_dim - nv, nv + nf))], dim=-2)
    return StageBlocks(
        A=ko["A"], B=ko["Bm"], xres=ko["xres"], Qxx=ko["Qxx"],
        Qxu=ko["Qxu"], Quu=ko["Quu"], lx=ko["lx"], lu=ko["lu"],
        G=ko["G"], c0=ko["c0"], inv11=ko["inv11"], inv12=ko["inv12"],
        Sinv=ko["Sinv"], Hy=Hy, Cwy=Cwy, gy=pre["gy"],
        e_lim=pre["aux_e_lim"], e_cone=pre["aux_e_cone"],
        dgdq=pre["dgdq"], dgdf=pre["dgdf"],
        lq_full=pre["aux_lq_full"], lv_full=pre["aux_lv_full"],
        la_full=pre["aux_la_full"], kkt_sq=pre["aux_kkt_sq"],
        kkt_rest=pre["aux_kkt_rest"], cost=pre["aux_cost"],
        barrier_cost=pre["aux_barrier_cost"],
        prim_feas=pre["aux_prim"], dual_feas=pre["aux_dual"])


def expand(model, contacts, limits, barrier, blocks: StageBlocks,
           dq, dv, du, gmm_n_new, dt,
           f, beta, mu, s_lim, z_lim, s_cone, z_cone, cmask):
    """Recover (da, df, dbeta, dmu, slack/dual dirs) for one stage from the
    LQR directions. gmm_n_new: the UPDATED next-grid costate gmm' + dgmm'."""
    nv = model.nv
    rowmask = contacts.force_mask(cmask)
    cone_mask = contacts.cone_mask(cmask) > 0
    w = torch.cat([dq, dv, du])
    y = blocks.G @ w + blocks.c0
    da, df = y[:nv], y[nv:]
    gy_new = blocks.Hy @ y + blocks.Cwy.T @ w + blocks.gy
    ga = gy_new[:nv] + dt * gmm_n_new
    gf = gy_new[nv:]
    rhs2 = torch.where(rowmask > 0, gf, torch.zeros_like(gf))
    beta_new, mu_new = ty_solve(blocks.inv11, blocks.inv12, blocks.Sinv,
                                -ga, rhs2)
    de_lim = jl.constraint_direction(model, limits, dq, dv, du, da)
    ds_lim, dz_lim = pdipm.expand_slack_dual(
        blocks.e_lim, s_lim, z_lim, barrier, de_lim, limits.mask)
    de_cone = blocks.dgdq @ dq + blocks.dgdf @ (df * rowmask)
    ds_cone, dz_cone = pdipm.expand_slack_dual(
        blocks.e_cone, s_cone, z_cone, barrier, de_cone, cone_mask)
    return (da, df, beta_new - beta, mu_new - mu, ds_lim, dz_lim, ds_cone,
            dz_cone, cone_mask)


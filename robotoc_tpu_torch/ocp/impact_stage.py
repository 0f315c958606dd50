"""Impact stage: impulse dynamics and the impact-velocity constraint,
condensed (counterpart of robotoc_tpu/ocp/impact_stage.py).

At an impact slot (zero duration) the primal is (q, v) pre-impact, the
velocity jump dv and the impulse Lambda, stored in the a / f slots:
  impulse dynamics  RNEA_impact(q, dv) - J^T Lambda = 0        (dual beta)
  impact velocity   v_contact(q, v + dv) = 0 on impacting rows  (dual mu)
  state equation    q' = q (Lie residual), v' = v + dv
plus the impact cost and the cone on Lambda. A slot whose impact mask is
empty is an identity pass-through (dv, Lambda driven to zero, A = I): a
fixed number of reserved slots absorbs a varying number of events. The
LQR sees B = 0 and Quu = I (a dummy control), so the backward sweep treats
every slot alike. `stage_pre` emits the same condense inputs as the
intermediate stage and is vmapped by the solver over the impact slots.
"""
from __future__ import annotations

import torch

from ..constraints import pdipm
from ..costs import base as cost_base
from ..dynamics import state_equation as se
from ..dynamics.contact_dynamics import ty_solve
from ..models import contacts as ct


def stage_pre(model, contacts, costs, limits, t, dt, barrier,
              q, v, dv, u, lam, beta, mu, lmd, gmm, lmd_n, gmm_n,
              q_n, v_n, s_lim, z_lim, s_cone, z_cone,
              imp_mask, p_ref, fric):
    """Impact pre-stage for one slot: the condense inputs
    (ops/condense.IN_NAMES) and the "aux_" pass-through fields. The stage
    type changes only the T_w columns, the A-row scale (sA = 1) and which
    cost blocks are zero; Hu_d = 1 makes the condensed Quu the identity."""
    nv, nu_dim = model.nv, model.dimu
    nf = contacts.max_dimf
    kw = dict(dtype=q.dtype, device=q.device)
    rowmask = contacts.force_mask(imp_mask)
    cone_mask = contacts.cone_mask(imp_mask) > 0

    lam_eff = lam * rowmask
    fold = cost_base.kin_fold_frames(costs) == contacts.frame_ids
    out = ct.fused_impact_derivatives(model, contacts, q, dv, v, lam_eff,
                                      fric, with_task=fold)
    ((ID_res, C_raw, g_cone, dgdf), (dIDdq, M), (dCdq, J), dgdq) = out[:4]
    kin = (contacts.frame_ids,) + out[4] if fold else None
    C_res = C_raw * rowmask
    dCdq = dCdq * rowmask.unsqueeze(-1)
    J = J * rowmask.unsqueeze(-1)

    # impact cost only on slots carrying a real impact: unused reserved
    # slots stay pure identity pass-throughs
    has_imp = torch.max(imp_mask)
    quad = cost_base.quadratize_impact(costs, model, q, v, dv, t, kin=kin)
    c, lq_c, lv_c, ldv_c = (has_imp * quad.cost, has_imp * quad.lq,
                            has_imp * quad.lv, has_imp * quad.ldv)
    Wq, Wv, Wdv = has_imp * quad.Qqq, has_imp * quad.Qvv, has_imp * quad.Qdvdv

    d_cone = pdipm.condensing_diag(s_cone, z_cone, cone_mask)
    r_cone = pdipm.condensing_rhs(g_cone, s_cone, z_cone, barrier, cone_mask)
    z_cone_m = torch.where(cone_mask, z_cone, torch.zeros_like(z_cone))
    zr = z_cone_m + r_cone
    cone_gq = dgdq.T @ zr
    cone_gf = dgdf.T @ zr

    Aqq, _, xres_q = se.linearize(model, q, torch.zeros_like(v),
                                  torch.zeros((), **kw), q_n)
    Fv_res = v + dv - v_n

    znv = torch.zeros((nv, nv), **kw)
    zu = torch.zeros(nu_dim, **kw)
    Tw1 = torch.cat([dIDdq, znv, torch.zeros((nv, nu_dim), **kw)], dim=-1)
    Tw2 = torch.cat([dCdq, J, torch.zeros((nf, nu_dim), **kw)], dim=-1)
    e2 = torch.where(rowmask > 0, C_res, lam)
    gw = torch.cat([lq_c + cone_gq, lv_c, zu])
    gy = torch.cat([ldv_c, cone_gf])

    lq_full = (lq_c + dgdq.T @ z_cone_m + dIDdq.T @ beta + dCdq.T @ mu
               + Aqq.T @ lmd_n - lmd)
    lv_full = lv_c + J.T @ mu + gmm_n - gmm
    ldv_full = ldv_c + M.T @ beta + J.T @ mu + gmm_n
    lf_full = (dgdf.T @ z_cone_m - J @ beta) * rowmask
    r_cone_p = pdipm.residual(g_cone, s_cone, cone_mask)
    c_cone = pdipm.complementarity(s_cone, z_cone, barrier, cone_mask)
    kkt_rest = (torch.sum(xres_q ** 2) + torch.sum(Fv_res ** 2)
                + torch.sum(ID_res ** 2) + torch.sum(C_res ** 2)
                + torch.sum(lf_full ** 2)
                + torch.sum(r_cone_p ** 2) + torch.sum(c_cone ** 2))
    kkt_sq = (kkt_rest + torch.sum(lq_full ** 2) + torch.sum(lv_full ** 2)
              + torch.sum(ldv_full ** 2))
    prim = (torch.sum(torch.abs(xres_q)) + torch.sum(torch.abs(Fv_res))
            + torch.sum(torch.abs(ID_res)) + torch.sum(torch.abs(C_res))
            + torch.sum(torch.abs(r_cone_p)))

    return dict(
        M=M, J=J, inactive=1.0 - (1.0 - contacts.inv_damping) * rowmask,
        Tw1=Tw1, Tw2=Tw2, r1=ID_res, e2=e2,
        Wq=Wq, Wv=Wv, Wu=torch.zeros((nu_dim, nu_dim), **kw), Wa=Wdv,
        Wf=torch.zeros((nf, nf), **kw),
        Hq_d=torch.zeros(nv, **kw), Hv_d=torch.zeros(nv, **kw),
        Hu_d=torch.ones(nu_dim, **kw), Ha_d=torch.zeros(nv, **kw),
        dgdq=dgdq, dgdf=dgdf, d_cone=d_cone, gw=gw, gy=gy,
        Aqq=Aqq, Aqv=znv, xres_q=xres_q, Fv_res=Fv_res,
        sA=torch.ones((), **kw), lam2=torch.cat([lmd_n, gmm_n]),
        lmdgmm=torch.cat([lmd, gmm]),
        aux_e_lim=torch.zeros_like(s_lim),   # joint limits off at impacts
        aux_e_cone=g_cone,
        aux_lq_full=lq_full, aux_lv_full=lv_full, aux_la_full=ldv_full,
        aux_kkt_sq=kkt_sq, aux_kkt_rest=kkt_rest, aux_cost=c,
        aux_barrier_cost=pdipm.log_barrier(s_cone, barrier, cone_mask),
        aux_prim=prim, aux_dual=torch.sum(torch.abs(c_cone)))


def expand(model, contacts, barrier, blocks, dq, dv_dir, gmm_n_new,
           lam, beta, mu, s_cone, z_cone, imp_mask):
    """Recover (ddv, dLambda, dbeta, dmu, cone slack/dual directions) of
    one impact slot."""
    nv = model.nv
    rowmask = contacts.force_mask(imp_mask)
    cone_mask = contacts.cone_mask(imp_mask) > 0
    w = torch.cat([dq, dv_dir, torch.zeros(model.dimu, dtype=dq.dtype,
                                           device=dq.device)])
    y = blocks.G @ w + blocks.c0
    ddv, dlam = y[:nv], y[nv:]
    gy_new = blocks.Hy @ y + blocks.Cwy.T @ w + blocks.gy
    ga = gy_new[:nv] + gmm_n_new          # the dv row carries gmm' (no dt)
    gf = gy_new[nv:]
    rhs2 = torch.where(rowmask > 0, gf, torch.zeros_like(gf))
    beta_new, mu_new = ty_solve(blocks.inv11, blocks.inv12, blocks.Sinv,
                                -ga, rhs2)
    de_cone = blocks.dgdq @ dq + blocks.dgdf @ (dlam * rowmask)
    ds_cone, dz_cone = pdipm.expand_slack_dual(
        blocks.e_cone, s_cone, z_cone, barrier, de_cone, cone_mask)
    return ddv, dlam, beta_new - beta, mu_new - mu, ds_cone, dz_cone

"""Contact models: Baumgarte-stabilized acceleration contacts.

Counterpart of robotoc_tpu/models/contacts.py (the parts the contact-OCP
Newton update runs). The contact stack has a STATIC maximum dimension;
activity enters as masks. `fused_stage_derivatives` evaluates inverse
dynamics, Baumgarte residuals and friction-cone values from one shared
level-batched chain and differentiates them with ONE 3nv-tangent
torch.func.jacfwd.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd

from ..ops import lie
from ..ops.spatial import (force_cross, force_transform, inertia_apply,
                           motion_cross, motion_transform_inv)
from . import robot as rm

POINT = 3
SURFACE = 6


@dataclasses.dataclass
class ContactModel:
    """Static contact-frame configuration for one robot."""
    frame_ids: tuple
    types: tuple            # POINT or SURFACE per contact
    frame_names: tuple
    kp: torch.Tensor        # (nc,) Baumgarte position gain
    kv: torch.Tensor        # (nc,) Baumgarte velocity gain
    rect: torch.Tensor      # (nc, 2) foot rectangle for surface contacts
    inv_damping: float = 0.0
    """Damping on ACTIVE rows of the contact-space Schur complement's
    diagonal during the [[M, J^T], [J, -D]] inversion; 0 = exact."""

    @property
    def n_contacts(self) -> int:
        return len(self.frame_ids)

    @property
    def max_dimf(self) -> int:
        return sum(self.types)

    @property
    def f_offsets(self):
        off, out = 0, []
        for d in self.types:
            out.append(off)
            off += d
        return tuple(out)

    @property
    def cone_dims(self):
        return tuple(5 if t == POINT else 17 for t in self.types)

    @property
    def dimc_cone(self) -> int:
        return sum(self.cone_dims)

    def _repeat(self, cmask, reps):
        idx = torch.as_tensor(np.repeat(np.arange(self.n_contacts), reps),
                              device=cmask.device)
        return cmask[..., idx]

    def force_mask(self, cmask):
        """(..., nc) activity -> (..., max_dimf) per-force-row mask."""
        return self._repeat(cmask, self.types)

    def cone_mask(self, cmask):
        """(..., nc) activity -> (..., dimc_cone) per-cone-row mask."""
        return self._repeat(cmask, self.cone_dims)

    def block_diag_cone(self, blocks):
        """Per-contact (cone rows, force cols) blocks in contact order ->
        the block-diagonal (dimc_cone, max_dimf) cone force Jacobian."""
        nf = self.max_dimf
        rows = []
        for c, blk in enumerate(blocks):
            off, d = self.f_offsets[c], self.types[c]
            z = blk.new_zeros(blk.shape[:-1] + (nf,))
            rows.append(torch.cat([z[..., :off], blk, z[..., off + d:]],
                                  dim=-1))
        return torch.cat(rows, dim=-2)


def make_contacts(model: rm.RobotModel, frame_names, types=None,
                  baumgarte_time_step: float = 0.04, rect=(0.05, 0.025),
                  contact_inv_damping: float = 0.0) -> ContactModel:
    """Baumgarte gains Kv = 2/T, Kp = 1/T^2 from a characteristic time."""
    n = len(frame_names)
    if types is None:
        types = (POINT,) * n
    kw = dict(dtype=model.dtype, device=model.device)
    return ContactModel(
        frame_ids=tuple(model.frame_id(f) for f in frame_names),
        types=tuple(types), frame_names=tuple(frame_names),
        kp=torch.full((n,), 1.0 / baumgarte_time_step ** 2, **kw),
        kv=torch.full((n,), 2.0 / baumgarte_time_step, **kw),
        rect=torch.as_tensor(rect, **kw).expand(n, 2).clone(),
        inv_damping=float(contact_inv_damping))


# ---------------------------------------------------------------------------
# Frame motion state and the stand-alone Baumgarte residual
# ---------------------------------------------------------------------------

def joint_motion_state(model: rm.RobotModel, q, v, a):
    """Per-joint local spatial velocity and kinematic acceleration (no
    gravity), plus world placements."""
    vs, as_, Rs, ps = [], [], [], []
    for i in range(model.nj):
        Rl, pl = rm._joint_placement(model, i, q)
        par = model.parents[i]
        vJ = rm._joint_motion(model, i, v)
        aJ = rm._joint_motion(model, i, a)
        if par < 0:
            vi = vJ
            ai = aJ + motion_cross(vi, vJ)
            Rs.append(Rl)
            ps.append(pl)
        else:
            vi = motion_transform_inv(Rl, pl, vs[par]) + vJ
            ai = (motion_transform_inv(Rl, pl, as_[par]) + aJ
                  + motion_cross(vi, vJ))
            Rs.append(Rs[par] @ Rl)
            ps.append(rm._mv(Rs[par], pl) + ps[par])
        vs.append(vi)
        as_.append(ai)
    return vs, as_, Rs, ps


def baumgarte_residual(model: rm.RobotModel, contacts: ContactModel,
                       q, v, a, p_ref, R_ref=None):
    """Stacked Baumgarte residual over ALL contacts: (..., max_dimf).
    Point: classical frame acceleration + Kv * linear velocity
    + Kp * (world position - p_ref). Surface: spatial acceleration
    + Kv * spatial velocity + Kp * log6(M_ref^-1 M(q))."""
    vs, as_, Rs, ps = joint_motion_state(model, q, v, a)
    res = []
    for c in range(contacts.n_contacts):
        fid = contacts.frame_ids[c]
        par = model.frame_parents[fid]
        fR, fp = model.frame_R[fid], model.frame_p[fid]
        vf = motion_transform_inv(fR, fp, vs[par])
        af = motion_transform_inv(fR, fp, as_[par])
        Rw = Rs[par] @ fR
        pw = rm._mv(Rs[par], fp) + ps[par]
        if contacts.types[c] == POINT:
            a_cl = af[..., :3] + lie.cross3(vf[..., 3:], vf[..., :3])
            res.append(a_cl + contacts.kv[c] * vf[..., :3]
                       + contacts.kp[c] * (pw - p_ref[..., c, :]))
        else:
            Rr = (torch.eye(3, dtype=q.dtype, device=q.device)
                  if R_ref is None else R_ref[..., c, :, :])
            Rrt = Rr.transpose(-1, -2)
            err6 = lie.se3_log(Rrt @ Rw, rm._mv(Rrt, pw - p_ref[..., c, :]))
            res.append(af + contacts.kv[c] * vf + contacts.kp[c] * err6)
    return torch.cat(res, dim=-1)


def contact_forces_to_joint(model: rm.RobotModel, contacts: ContactModel,
                            f_stack):
    """Local contact forces (..., max_dimf) -> per-joint external forces
    (..., nj, 6) for RNEA."""
    batch = f_stack.shape[:-1]
    per_joint = {}
    off = 0
    for c in range(contacts.n_contacts):
        d = contacts.types[c]
        fid = contacts.frame_ids[c]
        par = model.frame_parents[fid]
        fc = f_stack[..., off:off + d]
        if d == POINT:
            fc = torch.cat([fc, fc.new_zeros(batch + (3,))], dim=-1)
        fj = force_transform(model.frame_R[fid], model.frame_p[fid], fc)
        per_joint[par] = per_joint[par] + fj if par in per_joint else fj
        off += d
    zero = f_stack.new_zeros(batch + (6,))
    return torch.stack([per_joint.get(i, zero) for i in range(model.nj)],
                       dim=-2)


# ---------------------------------------------------------------------------
# Fused stage chain
# ---------------------------------------------------------------------------

def _fused_forward(model, q, v, a, gravity_on):
    """Single level-batched forward sweep for one sample. Returns per-joint
    stacks (PL_R, PL_p, RS, PS, VS, AS_kin, GP): local and world
    placements, local velocities, KINEMATIC accelerations and the
    separately propagated gravity term."""
    nj = model.nj
    dt = q.dtype
    if gravity_on:
        a0 = torch.cat([-model.gravity, torch.zeros(3, dtype=dt,
                                                    device=q.device)])
    else:
        a0 = torch.zeros(6, dtype=dt, device=q.device)
    out = {k: [None] * nj for k in ("PL_R", "PL_p", "RS", "PS", "VS", "AS",
                                    "GP")}

    def gather(name, par):
        return torch.stack([out[name][j] for j in par], dim=0)

    for jt, idxs in rm.chain_levels(model):
        idx = list(idxs)
        par = [model.parents[i] for i in idxs]
        k = len(idx)
        Rl, pl = rm.level_local_placements(model, jt, idxs, q)
        if jt == rm.FREE:
            vo = model.v_offs[idx[0]]
            vJ = v[vo:vo + 6].unsqueeze(0)
            aJ = a[vo:vo + 6].unsqueeze(0)
        else:
            voffs = [model.v_offs[i] for i in idx]
            ax = model.axis[idx]
            zk = torch.zeros((k, 3), dtype=dt, device=q.device)
            vax = v[voffs].unsqueeze(-1) * ax
            aax = a[voffs].unsqueeze(-1) * ax
            if jt == rm.REVOLUTE:
                vJ = torch.cat([zk, vax], dim=-1)
                aJ = torch.cat([zk, aax], dim=-1)
            else:
                vJ = torch.cat([vax, zk], dim=-1)
                aJ = torch.cat([aax, zk], dim=-1)
        if par[0] < 0:
            vi = vJ
            ai = aJ + motion_cross(vi, vJ)
            gi = motion_transform_inv(Rl, pl, a0.expand(k, 6))
            Rw, pw = Rl, pl
        else:
            vi = motion_transform_inv(Rl, pl, gather("VS", par)) + vJ
            ai = (motion_transform_inv(Rl, pl, gather("AS", par)) + aJ
                  + motion_cross(vi, vJ))
            gi = motion_transform_inv(Rl, pl, gather("GP", par))
            Rp = gather("RS", par)
            Rw = Rp @ Rl
            pw = rm._mv(Rp, pl) + gather("PS", par)
        for n, i in enumerate(idx):
            for name, val in (("PL_R", Rl), ("PL_p", pl), ("RS", Rw),
                              ("PS", pw), ("VS", vi), ("AS", ai),
                              ("GP", gi)):
                out[name][i] = val[n]
    return tuple(torch.stack(out[name], dim=0)
                 for name in ("PL_R", "PL_p", "RS", "PS", "VS", "AS", "GP"))


def _rnea_backward(model, PL_R, PL_p, VS, A_tot, f_joint):
    """Level-batched RNEA backward pass: per-joint net forces from the
    TOTAL accelerations, child-to-parent accumulation, torque projection."""
    FS = (inertia_apply(model.mass, model.com, model.inertia, A_tot)
          + force_cross(VS, inertia_apply(model.mass, model.com,
                                          model.inertia, VS)))
    if f_joint is not None:
        FS = FS - f_joint
    FS = list(torch.unbind(FS, dim=0))
    tau = [None] * model.nv
    for jt, idxs in reversed(rm.chain_levels(model)):
        idx = list(idxs)
        par = [model.parents[i] for i in idxs]
        Fl = torch.stack([FS[i] for i in idx], dim=0)
        if jt == rm.FREE:
            vo = model.v_offs[idx[0]]
            for r in range(6):
                tau[vo + r] = Fl[0, r]
        else:
            ax = model.axis[idx]
            half = Fl[:, 3:] if jt == rm.REVOLUTE else Fl[:, :3]
            tq = torch.sum(half * ax, dim=-1)
            for n, i in enumerate(idx):
                tau[model.v_offs[i]] = tq[n]
        if par[0] >= 0:
            ft = force_transform(PL_R[idx], PL_p[idx], Fl)
            for n, j in enumerate(par):
                FS[j] = FS[j] + ft[n]
    return torch.stack(tau, dim=0)


def _task_outputs(model, contacts, RS, PS):
    """(3 nc + 3,) task vector from a computed forward sweep: the world
    positions of the contact frames (contact order), then the CoM. The
    gait cost stack's kinematics (costs/task_cost.MultiFrameTaskCost) as a
    by-product of the shared chain."""
    fids = list(contacts.frame_ids)
    pars = [model.frame_parents[f] for f in fids]
    feet = rm._mv(RS[pars], model.frame_p[fids]) + PS[pars]
    ci = rm._mv(RS, model.com) + PS
    com = (torch.sum(model.mass.unsqueeze(-1) * ci, dim=-2)
           / torch.sum(model.mass))
    return torch.cat([feet.reshape(-1), com])


def _cone_rows(contacts, cs, typ, Rw, fl, fric):
    """Cone values (k, rows) and force Jacobian blocks (k, rows, typ) of
    the contacts `cs` of one type."""
    from ..constraints import friction_cone as fcone
    if typ == POINT:
        Cm = fcone.cone_matrix(fric[cs])                     # (k, 5, 3)
        return rm._mv(Cm, rm._mv(Rw, fl)), Cm @ Rw
    W = fcone.wrench_cone_matrix(fric[cs], contacts.rect[cs, 0],
                                 contacts.rect[cs, 1])
    return rm._mv(W, fl), W


def _contact_groups(model, contacts, device):
    """Per contact type: (typ, contacts, parent joints, frame ids, force
    row indices)."""
    out = []
    for typ in (POINT, SURFACE):
        cs = [c for c in range(contacts.n_contacts)
              if contacts.types[c] == typ]
        if cs:
            fids = [contacts.frame_ids[c] for c in cs]
            out.append((typ, cs, [model.frame_parents[f] for f in fids],
                        fids, torch.as_tensor(
                            [[contacts.f_offsets[c] + j for j in range(typ)]
                             for c in cs], device=device)))
    return out


def fused_stage_outputs(model, contacts: ContactModel, q, v, a, f_eff,
                        fric, p_ref, R_ref=None, gravity_on=True,
                        with_task=False):
    """(tau, C, g_cone, dgdf[, task]) for one sample from one shared chain.

    tau: RNEA(q, v, a) - J^T f (nv,); C: stacked Baumgarte residuals
    (max_dimf,), unmasked; g: stacked cone residuals (dimc_cone,);
    dgdf: (dimc_cone, max_dimf) block-diagonal cone force Jacobian;
    task (with_task): contact-frame world positions + CoM (3 nc + 3,)."""
    f_joint = contact_forces_to_joint(model, contacts, f_eff)
    PL_R, PL_p, RS, PS, VS, AS, GP = _fused_forward(model, q, v, a,
                                                    gravity_on)
    tau = _rnea_backward(model, PL_R, PL_p, VS, AS + GP, f_joint)
    res_c, g_c, dg_c = {}, {}, {}
    for typ, cs, pars, fids, f_idx in _contact_groups(model, contacts,
                                                      q.device):
        fR, fp = model.frame_R[fids], model.frame_p[fids]
        vf = motion_transform_inv(fR, fp, VS[pars])
        af = motion_transform_inv(fR, fp, AS[pars])
        Rw = RS[pars] @ fR
        pw = rm._mv(RS[pars], fp) + PS[pars]
        kv = contacts.kv[cs].unsqueeze(-1)
        kp = contacts.kp[cs].unsqueeze(-1)
        if typ == POINT:
            a_cl = af[:, :3] + lie.cross3(vf[:, 3:], vf[:, :3])
            res = a_cl + kv * vf[:, :3] + kp * (pw - p_ref[cs])
        else:
            Rr = (torch.eye(3, dtype=q.dtype, device=q.device).expand(
                Rw.shape) if R_ref is None else R_ref[cs])
            Rrt = Rr.transpose(-1, -2)
            err6 = lie.se3_log(Rrt @ Rw, rm._mv(Rrt, pw - p_ref[cs]))
            res = af + kv * vf + kp * err6
        gv, dg = _cone_rows(contacts, cs, typ, Rw, f_eff[f_idx], fric)
        for n, c in enumerate(cs):
            res_c[c], g_c[c], dg_c[c] = res[n], gv[n], dg[n]
    order = range(contacts.n_contacts)
    C = torch.cat([res_c[c] for c in order])
    g = torch.cat([g_c[c] for c in order])
    dgdf = contacts.block_diag_cone([dg_c[c] for c in order])
    if with_task:
        return tau, C, g, dgdf, _task_outputs(model, contacts, RS, PS)
    return tau, C, g, dgdf


def _split_jacobian(J, nv, nf, ng, n_blocks, with_task):
    """Rows (tau | C | g | task) and tangent blocks of one fused jacfwd."""
    def cols(rows):
        return tuple(rows[:, k * nv:(k + 1) * nv] for k in range(n_blocks))
    Jt, Jc, Jg = J[:nv], J[nv:nv + nf], J[nv + nf:nv + nf + ng]
    out = (cols(Jt), cols(Jc), Jg[:, :nv])
    if with_task:
        out += (J[nv + nf + ng:, :nv],)
    return out


def fused_stage_derivatives(model, contacts, q, v, a, f_eff, fric,
                            p_ref, R_ref=None, gravity_on=True,
                            with_task=False):
    """Values + Jacobians of (tau, C, g) for one sample with ONE fused
    3nv-tangent jacfwd of the shared chain. Returns
      ((tau, C, g, dgdf), (dtau_dq, dtau_dv, M), (dCdq, dCdv, Jc), dgdq)
    plus, with_task, a trailing (task, dtask_dq) pair: the task-cost rows
    ride the same chain and the same q-tangents."""
    nv = model.nv
    out = fused_stage_outputs(model, contacts, q, v, a, f_eff, fric, p_ref,
                              R_ref, gravity_on, with_task=with_task)
    z = torch.zeros(3 * nv, dtype=q.dtype, device=q.device)

    def f_all(e):
        o2 = fused_stage_outputs(
            model, contacts, rm.integrate(model, q, e[:nv]),
            v + e[nv:2 * nv], a + e[2 * nv:], f_eff, fric, p_ref, R_ref,
            gravity_on, with_task=with_task)
        return torch.cat([o2[0], o2[1], o2[2]] + list(o2[4:]))

    jac = _split_jacobian(jacfwd(f_all)(z), nv, contacts.max_dimf,
                          contacts.dimc_cone, 3, with_task)
    base = (out[:4],) + jac[:3]
    return base + ((out[4], jac[3]),) if with_task else base


# ---------------------------------------------------------------------------
# Impacts
# ---------------------------------------------------------------------------

def _frame_state(model, contacts, c, q, v, a):
    """(R_w, p_w, v_local, a_local_spatial) of contact frame c."""
    vs, as_, Rs, ps = joint_motion_state(model, q, v, a)
    fid = contacts.frame_ids[c]
    par = model.frame_parents[fid]
    fR, fp = model.frame_R[fid], model.frame_p[fid]
    return (Rs[par] @ fR, rm._mv(Rs[par], fp) + ps[par],
            motion_transform_inv(fR, fp, vs[par]),
            motion_transform_inv(fR, fp, as_[par]))


def impact_velocity_residual(model, contacts: ContactModel, q, v):
    """Post-impact contact-frame velocity: linear (point) or spatial
    (surface), stacked (max_dimf,)."""
    res = []
    zeros = torch.zeros_like(v)
    for c in range(contacts.n_contacts):
        vf = _frame_state(model, contacts, c, q, v, zeros)[2]
        res.append(vf[..., :3] if contacts.types[c] == POINT else vf)
    return torch.cat(res, dim=-1)


def contact_position_residual(model, contacts: ContactModel, q, p_ref):
    """World contact-position error (max_dimf of point contacts)."""
    R_w, p_w = rm.forward_kinematics(model, q)
    return torch.cat([rm.frame_placement(model, contacts.frame_ids[c], R_w,
                                         p_w)[1] - p_ref[..., c, :]
                      for c in range(contacts.n_contacts)], dim=-1)


def impact_velocity_derivatives(model, contacts, q, v):
    """(d/dq, d/dv) of impact_velocity_residual for one sample."""
    nv = model.nv
    z = torch.zeros(2 * nv, dtype=q.dtype, device=q.device)
    J = jacfwd(lambda e: impact_velocity_residual(
        model, contacts, rm.integrate(model, q, e[:nv]), v + e[nv:]))(z)
    return J[..., :nv], J[..., nv:]


def contact_position_derivative(model, contacts, q, p_ref):
    z = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
    return jacfwd(lambda e: contact_position_residual(
        model, contacts, rm.integrate(model, q, e), p_ref))(z)


def _velocity_forward(model, PL_R, PL_p, vpost):
    """Velocity-only propagation through fixed placements: (nj, 6)."""
    VP = [None] * model.nj
    for i in range(model.nj):
        vJ = rm._joint_motion(model, i, vpost)
        par = model.parents[i]
        VP[i] = vJ if par < 0 else (
            motion_transform_inv(PL_R[i], PL_p[i], VP[par]) + vJ)
    return torch.stack(VP, dim=0)


def fused_impact_outputs(model, contacts: ContactModel, q, dv, vpost,
                         lam_eff, fric, with_task=False):
    """(tau_imp, Cvel, g_cone, dgdf[, task]) of an impact stage from one
    shared chain: impulse dynamics RNEA_impact(q, dv) - J^T Lambda, the
    post-impact contact velocity at (q, vpost), the cone on Lambda."""
    f_joint = contact_forces_to_joint(model, contacts, lam_eff)
    PL_R, PL_p, RS, PS, VS0, AS, _ = _fused_forward(
        model, q, torch.zeros_like(dv), dv, gravity_on=False)
    tau = _rnea_backward(model, PL_R, PL_p, VS0, AS, f_joint)
    VP = _velocity_forward(model, PL_R, PL_p, vpost)
    res_c, g_c, dg_c = {}, {}, {}
    for typ, cs, pars, fids, f_idx in _contact_groups(model, contacts,
                                                      q.device):
        fR, fp = model.frame_R[fids], model.frame_p[fids]
        vf = motion_transform_inv(fR, fp, VP[pars])
        res = vf[:, :3] if typ == POINT else vf
        gv, dg = _cone_rows(contacts, cs, typ, RS[pars] @ fR,
                            lam_eff[f_idx], fric)
        for n, c in enumerate(cs):
            res_c[c], g_c[c], dg_c[c] = res[n], gv[n], dg[n]
    order = range(contacts.n_contacts)
    C = torch.cat([res_c[c] for c in order])
    g = torch.cat([g_c[c] for c in order])
    dgdf = contacts.block_diag_cone([dg_c[c] for c in order])
    if with_task:
        return tau, C, g, dgdf, _task_outputs(model, contacts, RS, PS)
    return tau, C, g, dgdf


def fused_impact_derivatives(model, contacts, q, dv, v, lam_eff, fric,
                             with_task=False):
    """Values + Jacobians of an impact stage with one fused jacfwd over
    (dq, ddv): the post-impact velocity residual depends on v and dv only
    through vpost = v + dv, so dC/dv rides the ddv tangents. Returns
    ((tau, C, g, dgdf), (dtau_dq, Mi), (dCdq, Jc), dgdq) plus, with_task,
    a trailing (task, dtask_dq) pair."""
    nv = model.nv
    out = fused_impact_outputs(model, contacts, q, dv, v + dv, lam_eff,
                               fric, with_task=with_task)
    z = torch.zeros(2 * nv, dtype=q.dtype, device=q.device)

    def f_all(e):
        o2 = fused_impact_outputs(
            model, contacts, rm.integrate(model, q, e[:nv]), dv + e[nv:],
            v + dv + e[nv:], lam_eff, fric, with_task=with_task)
        return torch.cat([o2[0], o2[1], o2[2]] + list(o2[4:]))

    jac = _split_jacobian(jacfwd(f_all)(z), nv, contacts.max_dimf,
                          contacts.dimc_cone, 2, with_task)
    base = (out[:4],) + jac[:3]
    return base + ((out[4], jac[3]),) if with_task else base

"""Rigid-body model as a dataclass of tensors + kinematics/dynamics.

Counterpart of robotoc_tpu/models/robot.py. The static skeleton (parents,
joint types, offsets) is plain Python; the numeric leaves are tensors on
the model's device. Every function is pure (no in-place writes on captured
tensors), so per-stage code runs under torch.func.vmap, and derivatives
come from torch.func.jacfwd over the configuration tangent.

Conventions: q = [p(3), quat(x,y,z,w), q_joints] for a floating base;
v = [v_lin_local(3), omega_local(3), v_joints].
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd

from ..ops import lie
from ..ops.spatial import (force_cross, force_transform, inertia_apply,
                           inertia_matrix, motion_cross, motion_transform_inv)
from . import urdf as _urdf
from .urdf import FREE, PRISMATIC, REVOLUTE


@dataclasses.dataclass
class RobotModel:
    # --- static skeleton ---
    name: str
    nq: int
    nv: int
    nj: int
    floating_base: bool
    parents: tuple
    jtypes: tuple
    q_offs: tuple
    v_offs: tuple
    frame_parents: tuple
    frame_names: tuple
    joint_names: tuple
    # --- tensors ---
    Xtree_R: torch.Tensor    # (nj, 3, 3) joint placement in parent frame
    Xtree_p: torch.Tensor    # (nj, 3)
    axis: torch.Tensor       # (nj, 3)
    mass: torch.Tensor       # (nj,)
    com: torch.Tensor        # (nj, 3) body com in joint frame
    inertia: torch.Tensor    # (nj, 3, 3) rotational inertia about origin
    frame_R: torch.Tensor    # (nframes, 3, 3)
    frame_p: torch.Tensor    # (nframes, 3)
    q_lower: torch.Tensor    # (dimu,)
    q_upper: torch.Tensor
    v_limit: torch.Tensor
    u_limit: torch.Tensor
    gravity: torch.Tensor    # (3,)
    generalized_momentum_bias: Optional[torch.Tensor] = None

    @property
    def dim_passive(self) -> int:
        return 6 if self.floating_base else 0

    @property
    def dimu(self) -> int:
        return self.nv - self.dim_passive

    @property
    def nframes(self) -> int:
        return len(self.frame_names)

    def frame_id(self, name: str) -> int:
        return self.frame_names.index(name)

    @property
    def dtype(self):
        return self.Xtree_R.dtype

    @property
    def device(self):
        return self.Xtree_R.device

    @property
    def total_mass(self):
        return torch.sum(self.mass)


def from_spec(spec: _urdf.ModelSpec, dtype=torch.float64,
              device=None) -> RobotModel:
    from ..device import resolve
    dev = resolve(device)
    q_offs, v_offs = [], []
    q_off, v_off = 0, 0
    for j in spec.joints:
        q_offs.append(q_off)
        v_offs.append(v_off)
        q_off += 7 if j.jtype == FREE else 1
        v_off += 6 if j.jtype == FREE else 1
    if q_off != spec.nq or v_off != spec.nv:
        raise ValueError(f"spec {spec.name}: joint dims ({q_off}, {v_off}) "
                         f"disagree with nq={spec.nq}, nv={spec.nv}")
    act = [j for j in spec.joints if j.jtype != FREE]

    def arr(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=dev)

    I_o = []
    for b in spec.bodies:
        h = _urdf._hat(b.com)
        I_o.append(b.I_c - b.mass * (h @ h))

    return RobotModel(
        name=spec.name, nq=spec.nq, nv=spec.nv, nj=len(spec.joints),
        floating_base=spec.floating_base,
        parents=tuple(j.parent for j in spec.joints),
        jtypes=tuple(j.jtype for j in spec.joints),
        q_offs=tuple(q_offs), v_offs=tuple(v_offs),
        frame_parents=tuple(f.parent_joint for f in spec.frames),
        frame_names=tuple(f.name for f in spec.frames),
        joint_names=tuple(j.name for j in spec.joints),
        Xtree_R=arr(np.stack([j.R for j in spec.joints])),
        Xtree_p=arr(np.stack([j.p for j in spec.joints])),
        axis=arr(np.stack([j.axis for j in spec.joints])),
        mass=arr([b.mass for b in spec.bodies]),
        com=arr(np.stack([b.com for b in spec.bodies])),
        inertia=arr(np.stack(I_o)),
        frame_R=arr(np.stack([f.R for f in spec.frames])),
        frame_p=arr(np.stack([f.p for f in spec.frames])),
        q_lower=arr([j.lower for j in act]),
        q_upper=arr([j.upper for j in act]),
        v_limit=arr([j.velocity for j in act]),
        u_limit=arr([j.effort for j in act]),
        gravity=arr([0.0, 0.0, -9.81]),
    )


def _mv(R, x):
    return (R @ x.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Configuration-space (Lie group) operations
# ---------------------------------------------------------------------------

def integrate(model: RobotModel, q, dq):
    """q (+) dq: right-integrate a tangent step (free flyer via SE(3) exp)."""
    if not model.floating_base:
        return q + dq
    p, quat, qj = q[..., :3], q[..., 3:7], q[..., 7:]
    R = lie.quat_to_rot(quat)
    dquat, dp = lie.se3_exp_quat(dq[..., :6])
    p_new = p + _mv(R, dp)
    quat_new = lie.quat_mul(quat, dquat)
    return torch.cat([p_new, quat_new, qj + dq[..., 6:]], dim=-1)


def difference(model: RobotModel, q0, q1):
    """q1 (-) q0 (tangent at q0): log6(M0^-1 M1) for the base."""
    if not model.floating_base:
        return q1 - q0
    p0, quat0, qj0 = q0[..., :3], q0[..., 3:7], q0[..., 7:]
    p1, quat1, qj1 = q1[..., :3], q1[..., 3:7], q1[..., 7:]
    R0 = lie.quat_to_rot(quat0)
    quat_rel = lie.quat_mul(lie.quat_conj(quat0), quat1)
    R_rel = lie.quat_to_rot(quat_rel)
    p_rel = _mv(R0.transpose(-1, -2), p1 - p0)
    nu = lie.se3_log(R_rel, p_rel)
    return torch.cat([nu, qj1 - qj0], dim=-1)


def interpolate(model: RobotModel, q0, q1, t):
    """q0 (+) t (q1 (-) q0); t broadcasts against the tangent."""
    return integrate(model, q0, t * difference(model, q0, q1))


def neutral(model: RobotModel):
    q = torch.zeros(model.nq, dtype=model.dtype, device=model.device)
    if model.floating_base:
        q = torch.cat([q[:6], torch.ones_like(q[6:7]), q[7:]])
    return q


def tangent_jacobian(model: RobotModel, q, f):
    """d f(q (+) e)/de at e=0 for a single configuration q (vmap for a
    batch)."""
    z = torch.zeros(model.nv, dtype=model.dtype, device=model.device)
    return jacfwd(lambda e: f(integrate(model, q, e)))(z)


def d_difference_dq0(model: RobotModel, q0, q1):
    return tangent_jacobian(model, q0, lambda q: difference(model, q, q1))


def d_difference_dq1(model: RobotModel, q0, q1):
    return tangent_jacobian(model, q1, lambda q: difference(model, q0, q))


# ---------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------

def _joint_placement(model: RobotModel, i: int, q):
    """Placement (R, p) of joint i's child frame in its parent joint frame."""
    jt = model.jtypes[i]
    XR, Xp = model.Xtree_R[i], model.Xtree_p[i]
    if jt == FREE:
        qo = model.q_offs[i]
        Rq = lie.quat_to_rot(q[..., qo + 3:qo + 7])
        return XR @ Rq, _mv(XR, q[..., qo:qo + 3]) + Xp
    qi = q[..., model.q_offs[i]]
    ax = model.axis[i]
    if jt == REVOLUTE:
        Rj = lie.so3_exp(qi.unsqueeze(-1) * ax)
        return XR @ Rj, Xp.expand(qi.shape + (3,))
    if jt == PRISMATIC:
        return XR.expand(qi.shape + (3, 3)), Xp + qi.unsqueeze(-1) * ax
    raise ValueError(jt)


def chain_levels(model: RobotModel):
    """Static level decomposition of the joint tree: joints of the same
    type at the same depth evaluate as one batched op. Returns a tuple of
    (jtype, joint_indices) in depth order."""
    depth = []
    for i in range(model.nj):
        p = model.parents[i]
        depth.append(0 if p < 0 else depth[p] + 1)
    buckets = {}
    for i in range(model.nj):
        buckets.setdefault((depth[i], model.jtypes[i]), []).append(i)
    return tuple((jt, tuple(idxs))
                 for (d, jt), idxs in sorted(buckets.items()))


def level_local_placements(model: RobotModel, jt, idxs, q):
    """Batched local placements (..., k, 3, 3), (..., k, 3) of one level."""
    idx = list(idxs)
    k = len(idx)
    batch = q.shape[:-1]
    if jt == FREE:
        qo = model.q_offs[idx[0]]
        Rq = lie.quat_to_rot(q[..., qo + 3:qo + 7])
        Rl = (model.Xtree_R[idx[0]] @ Rq).unsqueeze(-3)
        pl = (_mv(model.Xtree_R[idx[0]], q[..., qo:qo + 3])
              + model.Xtree_p[idx[0]]).unsqueeze(-2)
        return Rl, pl
    qi = q[..., [model.q_offs[i] for i in idx]]
    ax = model.axis[idx]
    if jt == REVOLUTE:
        Rj = lie.so3_exp(qi.unsqueeze(-1) * ax)
        return model.Xtree_R[idx] @ Rj, model.Xtree_p[idx].expand(
            batch + (k, 3))
    return (model.Xtree_R[idx].expand(batch + (k, 3, 3)),
            model.Xtree_p[idx] + qi.unsqueeze(-1) * ax)


def forward_kinematics(model: RobotModel, q):
    """World placements of all joint frames: (R_w (..., nj, 3, 3), p_w),
    level-batched."""
    RS = [None] * model.nj
    PS = [None] * model.nj
    for jt, idxs in chain_levels(model):
        Rl, pl = level_local_placements(model, jt, idxs, q)
        par = [model.parents[i] for i in idxs]
        if par[0] < 0:
            Rw, pw = Rl, pl
        else:
            Rp = torch.stack([RS[j] for j in par], dim=-3)
            Pp = torch.stack([PS[j] for j in par], dim=-2)
            Rw = Rp @ Rl
            pw = _mv(Rp, pl) + Pp
        for n, i in enumerate(idxs):
            RS[i] = Rw[..., n, :, :]
            PS[i] = pw[..., n, :]
    return torch.stack(RS, dim=-3), torch.stack(PS, dim=-2)


def frame_placement(model: RobotModel, fid: int, R_w, p_w):
    """World placement of operational frame `fid` given joint FK results."""
    par = model.frame_parents[fid]
    fR, fp = model.frame_R[fid], model.frame_p[fid]
    if par < 0:
        shape = p_w.shape[:-2]
        return fR.expand(shape + (3, 3)), fp.expand(shape + (3,))
    Rp = R_w[..., par, :, :]
    return Rp @ fR, _mv(Rp, fp) + p_w[..., par, :]


def frame_position(model: RobotModel, fid: int, q):
    R_w, p_w = forward_kinematics(model, q)
    return frame_placement(model, fid, R_w, p_w)[1]


def com(model: RobotModel, q):
    """World centre of mass (..., 3)."""
    R_w, p_w = forward_kinematics(model, q)
    ci = _mv(R_w, model.com) + p_w
    return (torch.sum(model.mass.unsqueeze(-1) * ci, dim=-2)
            / torch.sum(model.mass))


def _joint_motion(model: RobotModel, i: int, vec):
    """S_i @ vec_i, the joint-space motion contribution of joint i."""
    jt = model.jtypes[i]
    vo = model.v_offs[i]
    if jt == FREE:
        return vec[..., vo:vo + 6]
    vi = vec[..., vo].unsqueeze(-1) * model.axis[i]
    zeros = torch.zeros_like(vi)
    if jt == REVOLUTE:
        return torch.cat([zeros, vi], dim=-1)
    return torch.cat([vi, zeros], dim=-1)


# ---------------------------------------------------------------------------
# Dynamics: RNEA, CRBA, derivatives
# ---------------------------------------------------------------------------

def rnea(model: RobotModel, q, v, a, f_joint=None, gravity_on: bool = True):
    """Inverse dynamics tau(q, v, a) minus external forces, local frames.
    f_joint: optional (..., nj, 6) external forces in each joint frame."""
    nj = model.nj
    dt = model.dtype
    if gravity_on:
        a0 = torch.cat([-model.gravity, torch.zeros(3, dtype=dt,
                                                    device=model.device)])
    else:
        a0 = torch.zeros(6, dtype=dt, device=model.device)
    vs, as_, placements, fs = [], [], [], []
    for i in range(nj):
        Rl, pl = _joint_placement(model, i, q)
        placements.append((Rl, pl))
        par = model.parents[i]
        vJ = _joint_motion(model, i, v)
        aJ = _joint_motion(model, i, a)
        if par < 0:
            vi = vJ
            ai = (motion_transform_inv(Rl, pl, a0.expand(vJ.shape)) + aJ
                  + motion_cross(vi, vJ))
        else:
            vi = motion_transform_inv(Rl, pl, vs[par]) + vJ
            ai = (motion_transform_inv(Rl, pl, as_[par]) + aJ
                  + motion_cross(vi, vJ))
        vs.append(vi)
        as_.append(ai)
        m, c, I = model.mass[i], model.com[i], model.inertia[i]
        fi = inertia_apply(m, c, I, ai) + force_cross(
            vi, inertia_apply(m, c, I, vi))
        if f_joint is not None:
            fi = fi - f_joint[..., i, :]
        fs.append(fi)

    tau_parts = [None] * nj
    for i in reversed(range(nj)):
        jt = model.jtypes[i]
        if jt == FREE:
            tau_parts[i] = fs[i]
        elif jt == REVOLUTE:
            tau_parts[i] = torch.sum(fs[i][..., 3:] * model.axis[i], dim=-1,
                                     keepdim=True)
        else:
            tau_parts[i] = torch.sum(fs[i][..., :3] * model.axis[i], dim=-1,
                                     keepdim=True)
        par = model.parents[i]
        if par >= 0:
            Rl, pl = placements[i]
            fs[par] = fs[par] + force_transform(Rl, pl, fs[i])
    tau = torch.cat(tau_parts, dim=-1)
    if gravity_on and model.generalized_momentum_bias is not None:
        tau = tau - model.generalized_momentum_bias
    return tau


def _force_xform_matrix(R, p):
    """Dense 6x6 force transform child->parent: [[R, 0], [p^ R, R]]."""
    Z = torch.zeros_like(R)
    top = torch.cat([R, Z], dim=-1)
    bot = torch.cat([lie.hat(p) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _joint_subspace(model: RobotModel, i: int):
    """S_i as a (6, ndof_i) matrix."""
    jt = model.jtypes[i]
    if jt == FREE:
        return torch.eye(6, dtype=model.dtype, device=model.device)
    ax = model.axis[i]
    z = torch.zeros_like(ax)
    if jt == REVOLUTE:
        return torch.cat([z, ax]).unsqueeze(-1)
    return torch.cat([ax, z]).unsqueeze(-1)


def crba(model: RobotModel, q):
    """Joint-space mass matrix M(q) by composite rigid bodies."""
    nj = model.nj
    placements = [_joint_placement(model, i, q) for i in range(nj)]
    Ic = [inertia_matrix(model.mass[i], model.com[i], model.inertia[i])
          for i in range(nj)]
    batch = placements[0][1].shape[:-1]

    def vdim(i):
        return 6 if model.jtypes[i] == FREE else 1

    blocks = {}
    for i in reversed(range(nj)):
        par = model.parents[i]
        if par >= 0:
            Xf = _force_xform_matrix(*placements[i])
            Ic[par] = Ic[par] + Xf @ Ic[i] @ Xf.transpose(-1, -2)
        F = Ic[i] @ _joint_subspace(model, i)                 # (..., 6, di)
        blocks[(i, i)] = _joint_subspace(model, i).transpose(-1, -2) @ F
        j = i
        while model.parents[j] >= 0:
            F = _force_xform_matrix(*placements[j]) @ F
            j = model.parents[j]
            Mij = F.transpose(-1, -2) @ _joint_subspace(model, j)
            blocks[(i, j)] = Mij
            blocks[(j, i)] = Mij.transpose(-1, -2)
    rows = []
    for i in range(nj):
        row = []
        for j in range(nj):
            blk = blocks.get((i, j))
            if blk is None:
                blk = torch.zeros(batch + (vdim(i), vdim(j)),
                                  dtype=model.dtype, device=model.device)
            row.append(blk.expand(batch + blk.shape[-2:]))
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


def rnea_derivatives(model: RobotModel, q, v, a, f_joint=None,
                     gravity_on: bool = True):
    """(dtau/dq (tangent), dtau/dv, dtau/da = M) for one sample, by ONE
    forward-mode jacfwd over the fused 3nv tangent space."""
    nv = model.nv
    z = torch.zeros(3 * nv, dtype=model.dtype, device=model.device)

    def f_all(e):
        return rnea(model, integrate(model, q, e[:nv]), v + e[nv:2 * nv],
                    a + e[2 * nv:], f_joint, gravity_on)

    J = jacfwd(f_all)(z)                       # (nv, 3nv)
    return J[:, :nv], J[:, nv:2 * nv], J[:, 2 * nv:]

"""Linearized contact cones: friction pyramid (point) + wrench cone
(surface). Counterpart of robotoc_tpu/constraints/friction_cone.py.

Per point contact, with the WORLD-frame force f_W = R_frame(q) f_local:
    g = [ -fz ; fx - c fz ; -fx - c fz ; fy - c fz ; -fy - c fz ] <= 0,
    c = mu / sqrt(2).
Surface contacts use the 17-row rectangular-foot wrench cone on the LOCAL
wrench.
"""
from __future__ import annotations

import math

import torch
from torch.func import jacfwd

from ..models import robot as rm

POINT = 3


def cone_matrix(friction_coef):
    """(..., 5, 3) facet matrix C with g = C f_world, for friction
    coefficients of any batch shape."""
    c = friction_coef / math.sqrt(2.0)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rows = [[z, z, -o], [o, z, -c], [-o, z, -c], [z, o, -c], [z, z - 1.0, -c]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def wrench_cone_matrix(mu, X, Y):
    """(..., 17, 6) rectangular-foot contact wrench cone W with
    g = W wrench (friction pyramid, CoP box, yaw-torque limits)."""
    z = torch.zeros_like(mu)
    o = torch.ones_like(mu)
    X = X + z
    Y = Y + z
    XYmu = (X + Y) * mu
    rows = [
        [z, z, -o, z, z, z],
        [-o, z, -mu, z, z, z],
        [o, z, -mu, z, z, z],
        [z, -o, -mu, z, z, z],
        [z, o, -mu, z, z, z],
        [z, z, -Y, -o, z, z],
        [z, z, -Y, o, z, z],
        [z, z, -X, z, -o, z],
        [z, z, -X, z, o, z],
        [-Y, -X, -XYmu, mu, mu, -o],
        [-Y, X, -XYmu, mu, -mu, -o],
        [Y, -X, -XYmu, -mu, mu, -o],
        [Y, X, -XYmu, -mu, -mu, -o],
        [Y, X, -XYmu, mu, mu, o],
        [Y, -X, -XYmu, mu, -mu, o],
        [-Y, X, -XYmu, -mu, mu, o],
        [-Y, -X, -XYmu, -mu, -mu, o],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def residual(model, contacts, q, f_stack, friction_coefs):
    """g (dimc_cone,) alone for one sample (no derivatives): the first
    output of residual_and_jac."""
    R_w, p_w = rm.forward_kinematics(model, q)
    offs = contacts.f_offsets
    gs = []
    for c in range(contacts.n_contacts):
        if contacts.types[c] == POINT:
            Rf, _ = rm.frame_placement(model, contacts.frame_ids[c], R_w,
                                       p_w)
            gs.append(cone_matrix(friction_coefs[c])
                      @ (Rf @ f_stack[offs[c]:offs[c] + 3]))
        else:
            W = wrench_cone_matrix(friction_coefs[c], contacts.rect[c, 0],
                                   contacts.rect[c, 1])
            gs.append(W @ f_stack[offs[c]:offs[c] + 6])
    return torch.cat(gs)


def residual_and_jac(model, contacts, q, f_stack, friction_coefs):
    """g (dimc_cone,), dg/df (dimc_cone, nf), dg/dq (dimc_cone, nv) for one
    sample. f_stack: (nf,) local forces; friction_coefs: (nc,)."""
    R_w, p_w = rm.forward_kinematics(model, q)
    offs = contacts.f_offsets
    gs, blocks, frames = [], [], []
    for c in range(contacts.n_contacts):
        fid = contacts.frame_ids[c]
        if contacts.types[c] == POINT:
            Rf, _ = rm.frame_placement(model, fid, R_w, p_w)
            fl = f_stack[offs[c]:offs[c] + 3]
            C = cone_matrix(friction_coefs[c])
            gs.append(C @ (Rf @ fl))
            blocks.append(C @ Rf)
            frames.append((fid, C, fl))
        else:
            wl = f_stack[offs[c]:offs[c] + 6]
            W = wrench_cone_matrix(friction_coefs[c], contacts.rect[c, 0],
                                   contacts.rect[c, 1])
            gs.append(W @ wl)
            blocks.append(W)
            frames.append(None)
    g = torch.cat(gs)
    dgdf = contacts.block_diag_cone(blocks)

    def g_of_q(e):
        qe = rm.integrate(model, q, e)
        Rw2, pw2 = rm.forward_kinematics(model, qe)
        out = []
        for fr in frames:
            if fr is None:
                out.append(torch.zeros(17, dtype=q.dtype, device=q.device))
            else:
                fid, C, fl = fr
                Rf2, _ = rm.frame_placement(model, fid, Rw2, pw2)
                out.append(C @ (Rf2 @ fl))
        return torch.cat(out)

    dgdq = jacfwd(g_of_q)(torch.zeros(model.nv, dtype=q.dtype,
                                      device=q.device))
    return g, dgdf, dgdq

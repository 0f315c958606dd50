"""Batched 6D spatial algebra (Featherstone), linear-first ordering.

Counterpart of robotoc_tpu/ops/spatial.py: motion vectors (v_lin, omega)
and force vectors (f, tau) in a LOCAL frame, placements as (R, p) pairs.
Every function broadcasts over leading batch dims.
"""
from __future__ import annotations

import torch

from .lie import cross3, hat


def _mv(R, x):
    return (R @ x.unsqueeze(-1)).squeeze(-1)


def motion_cross(v, m):
    """crm(v) @ m for motion vectors v, m."""
    lv, wv = v[..., :3], v[..., 3:]
    lm, wm = m[..., :3], m[..., 3:]
    return torch.cat([cross3(wv, lm) + cross3(lv, wm), cross3(wv, wm)],
                     dim=-1)


def force_cross(v, f):
    """crf(v) @ f = -crm(v)^T f."""
    lv, wv = v[..., :3], v[..., 3:]
    lf, wf = f[..., :3], f[..., 3:]
    return torch.cat([cross3(wv, lf), cross3(wv, wf) + cross3(lv, lf)],
                     dim=-1)


def motion_transform(R, p, m):
    """Motion in the child frame -> parent frame (child placed at (R, p))."""
    l = _mv(R, m[..., :3])
    w = _mv(R, m[..., 3:])
    return torch.cat([l + cross3(p, w), w], dim=-1)


def motion_transform_inv(R, p, m):
    """Motion in the parent frame -> child frame."""
    w = m[..., 3:]
    l = m[..., :3] - cross3(p, w)
    Rt = R.transpose(-1, -2)
    return torch.cat([_mv(Rt, l), _mv(Rt, w)], dim=-1)


def force_transform(R, p, f):
    """Force in the child frame -> parent frame."""
    lf = _mv(R, f[..., :3])
    wf = _mv(R, f[..., 3:])
    return torch.cat([lf, wf + cross3(p, lf)], dim=-1)


def force_transform_inv(R, p, f):
    """Force in the parent frame -> child frame."""
    Rt = R.transpose(-1, -2)
    lf = f[..., :3]
    wf = f[..., 3:] - cross3(p, lf)
    return torch.cat([_mv(Rt, lf), _mv(Rt, wf)], dim=-1)


def inertia_apply(m, c, I_o, v):
    """Spatial inertia (mass m, com c, rotational inertia I_o about the
    frame origin) applied to motion v:
    f = m l - m c x w ;  n = I_o w + m c x l."""
    l, w = v[..., :3], v[..., 3:]
    mc = m.unsqueeze(-1) * c
    f = m.unsqueeze(-1) * l - cross3(mc, w)
    n = _mv(I_o, w) + cross3(mc, l)
    return torch.cat([f, n], dim=-1)


def inertia_matrix(m, c, I_o):
    """Dense 6x6 spatial inertia [[m E, -m c^], [m c^, I_o]]."""
    mc_hat = m[..., None, None] * hat(c)
    eye = torch.eye(3, dtype=I_o.dtype, device=I_o.device) \
        * m[..., None, None]
    top = torch.cat([eye, -mc_hat], dim=-1)
    bot = torch.cat([mc_hat, I_o], dim=-1)
    return torch.cat([top, bot], dim=-2)

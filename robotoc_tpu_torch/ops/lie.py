"""Batched Lie-group operations on SO(3)/SE(3) for floating-base configs.

Counterpart of robotoc_tpu/ops/lie.py, with the same conventions:
quaternions (x, y, z, w); placements (R, p) with x_world = R x_local + p;
tangents (linear, angular) in the LOCAL frame; right integration. Small
angles go through Taylor `where` switches, so every function is free of
data-dependent branches and runs under torch.func.vmap/jacfwd.
"""
from __future__ import annotations

import torch

_EPS2 = 1e-14  # squared-angle switch point for Taylor fallbacks

# Scalar-per-sample quantities (squared angles, quaternion parts) keep a
# trailing singleton dim throughout: under torch.func.jacfwd a 0-dim tensor
# combined with a Python float gets a float64 tangent (seen with torch
# 2.13), which would turn a float32 Jacobian into float64.


def _safe_sqrt(x):
    return torch.sqrt(torch.where(x > _EPS2, x, torch.ones_like(x)))


def _sin_t_over_t(t2, t):
    """sin(t)/t with a Taylor fallback; t2 = t**2, shapes (..., 1)."""
    big = t2 > _EPS2
    return torch.where(big, torch.sin(t) / torch.where(big, t, 1.0),
                       1.0 - t2 / 6.0 + t2 * t2 / 120.0)


def _one_minus_cos_over_t2(t2, t):
    big = t2 > _EPS2
    return torch.where(big, (1.0 - torch.cos(t)) / torch.where(big, t2, 1.0),
                       0.5 - t2 / 24.0 + t2 * t2 / 720.0)


def _t_minus_sin_over_t3(t2, t):
    t3 = t2 * t
    big = t2 > _EPS2
    return torch.where(big, (t - torch.sin(t)) / torch.where(big, t3, 1.0),
                       1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0)


def _angle2(w):
    """(|w|^2, |w|) with a trailing singleton dim."""
    t2 = torch.sum(w * w, dim=-1, keepdim=True)
    return t2, _safe_sqrt(t2)


def cross3(a, b):
    """a x b over the last dim (written out: no batching-rule surprises)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _eye3(w):
    return torch.eye(3, dtype=w.dtype, device=w.device)


def hat(w):
    """Skew-symmetric matrix of omega: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conj(q):
    # no host-made constant: its copy to the card would synchronise
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q):
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat_to_rot(q):
    """(..., 4) unit quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def rot_to_quat(R):
    """(..., 3, 3) -> (..., 4) via the branchless 4-candidate method."""
    def m(i, j):
        return R[..., i, j:j + 1]
    m00, m01, m02 = m(0, 0), m(0, 1), m(0, 2)
    m10, m11, m12 = m(1, 0), m(1, 1), m(1, 2)
    m20, m21, m22 = m(2, 0), m(2, 1), m(2, 2)
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    sw = _safe_sqrt(qw2) * 2.0
    sx = _safe_sqrt(qx2) * 2.0
    sy = _safe_sqrt(qy2) * 2.0
    sz = _safe_sqrt(qz2) * 2.0
    cands = torch.stack([
        torch.cat([(m21 - m12) / sw, (m02 - m20) / sw,
                   (m10 - m01) / sw, 0.25 * sw], dim=-1),
        torch.cat([0.25 * sx, (m01 + m10) / sx,
                   (m02 + m20) / sx, (m21 - m12) / sx], dim=-1),
        torch.cat([(m01 + m10) / sy, 0.25 * sy,
                   (m12 + m21) / sy, (m02 - m20) / sy], dim=-1),
        torch.cat([(m02 + m20) / sz, (m12 + m21) / sz,
                   0.25 * sz, (m10 - m01) / sz], dim=-1),
    ], dim=-2)                                       # (..., 4 cand, 4)
    mags = torch.cat([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(mags, dim=-1)
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)
    return quat_normalize(q[..., 0, :])


def so3_exp_quat(w):
    """Rotation vector (..., 3) -> unit quaternion."""
    t2, t = _angle2(w)
    half = 0.5 * t
    s = 0.5 * _sin_t_over_t(0.25 * t2, half)
    c = torch.where(t2 > _EPS2, torch.cos(half),
                    1.0 - t2 / 8.0 + t2 * t2 / 384.0)
    return torch.cat([w * s, c], dim=-1)


def quat_log(q):
    """Unit quaternion -> rotation vector (..., 3), short arc."""
    sign = torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)
    q = q * sign
    vn2 = torch.sum(q[..., :3] ** 2, dim=-1, keepdim=True)
    vn = _safe_sqrt(vn2)
    w = torch.clamp(q[..., 3:4], -1.0, 1.0)
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn2 > _EPS2, angle / vn,
                        2.0 / torch.clamp(w, min=1e-12))
    return q[..., :3] * scale


# ---------------------------------------------------------------------------
# SO(3) matrix exp/log
# ---------------------------------------------------------------------------

def so3_exp(w):
    """Rotation vector -> rotation matrix (Rodrigues, Taylor-safe)."""
    t2, t = _angle2(w)
    A = _sin_t_over_t(t2, t).unsqueeze(-1)
    B = _one_minus_cos_over_t2(t2, t).unsqueeze(-1)
    W = hat(w)
    return _eye3(w) + A * W + B * (W @ W)


def so3_log(R):
    return quat_log(rot_to_quat(R))


def so3_left_jacobian(w):
    t2, t = _angle2(w)
    B = _one_minus_cos_over_t2(t2, t).unsqueeze(-1)
    C = _t_minus_sin_over_t3(t2, t).unsqueeze(-1)
    W = hat(w)
    return _eye3(w) + B * W + C * (W @ W)


# ---------------------------------------------------------------------------
# SE(3): placements (R, p); tangents nu = (v, w) in the LOCAL frame
# ---------------------------------------------------------------------------

def se3_mul(R1, p1, R2, p2):
    return R1 @ R2, (R1 @ p2.unsqueeze(-1)).squeeze(-1) + p1


def se3_inv(R, p):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ p.unsqueeze(-1)).squeeze(-1)


def se3_exp(nu):
    v, w = nu[..., :3], nu[..., 3:]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    return R, (V @ v.unsqueeze(-1)).squeeze(-1)


def se3_exp_quat(nu):
    """Tangent -> (quat, p) for configuration integration."""
    v, w = nu[..., :3], nu[..., 3:]
    q = so3_exp_quat(w)
    V = so3_left_jacobian(w)
    return q, (V @ v.unsqueeze(-1)).squeeze(-1)


def _so3_left_jacobian_inv(w):
    t2, t = _angle2(w)
    s = torch.sin(t)
    exact_den = 2.0 * t * s
    big = t2 > 1e-8
    coef = torch.where(
        big,
        1.0 / torch.where(big, t2, 1.0)
        - (1.0 + torch.cos(t)) / torch.where(big, exact_den, 1.0),
        1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0)
    W = hat(w)
    return _eye3(w) - 0.5 * W + coef.unsqueeze(-1) * (W @ W)


def se3_log(R, p):
    """(R, p) -> tangent (v, w)."""
    w = so3_log(R)
    Vinv = _so3_left_jacobian_inv(w)
    return torch.cat([(Vinv @ p.unsqueeze(-1)).squeeze(-1), w], dim=-1)

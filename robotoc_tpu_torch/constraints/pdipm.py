"""Primal-dual interior-point primitives, elementwise over constraint
stacks (counterpart of robotoc_tpu/constraints/pdipm.py). Convention:
e(x) <= 0, slack s = -e > 0, dual z > 0; masked rows keep s=1, z=barrier
and contribute nothing."""
from __future__ import annotations

import math

import torch


def _masked(x, mask):
    return x if mask is None else torch.where(mask, x, torch.zeros_like(x))


def init_slack_dual(e, barrier, mask=None):
    s = torch.clamp(-e, min=math.sqrt(barrier))
    z = barrier / s
    if mask is not None:
        s = torch.where(mask, s, torch.ones_like(s))
        z = torch.where(mask, z, torch.full_like(z, barrier))
    return s, z


def residual(e, s, mask=None):
    return _masked(e + s, mask)


def complementarity(s, z, barrier, mask=None):
    return _masked(s * z - barrier, mask)


def condensing_diag(s, z, mask=None):
    return _masked(z / s, mask)


def condensing_rhs(e, s, z, barrier, mask=None):
    """(z (e + s) - (s z - barrier)) / s."""
    return _masked((z * (e + s) - (s * z - barrier)) / s, mask)


def expand_slack_dual(e, s, z, barrier, de, mask=None):
    ds = -(e + s) - de
    dz = -(s * z - barrier + z * ds) / s
    return _masked(ds, mask), _masked(dz, mask)


def fraction_to_boundary(x, dx, tau, mask=None, batch_dims: int = 0):
    """Largest alpha in (0, 1] with x + alpha dx >= (1 - tau) x, reduced
    over every dim after the first `batch_dims` (one step per scenario)."""
    ratio = -tau * x / torch.clamp(dx, max=-1e-30)
    ok = dx < 0
    if mask is not None:
        ok = ok & mask
    alphas = torch.where(ok, ratio, torch.ones_like(ratio))
    flat = alphas.reshape(alphas.shape[:batch_dims] + (-1,))
    if flat.shape[-1] == 0:
        return torch.ones(flat.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.clamp(torch.amin(flat, dim=-1), max=1.0)


def log_barrier(s, barrier, mask=None):
    lb = -barrier * torch.log(torch.clamp(s, min=1e-30))
    return torch.sum(_masked(lb, mask))

"""Cost container and the per-stage quadratization interface
(counterpart of robotoc_tpu/costs/base.py). Components have
quadratize_stage / quadratize_terminal methods returning Gauss-Newton
blocks; missing blocks are zeros so a tuple of components just sums."""
from __future__ import annotations

from typing import NamedTuple

import torch


class StageQuad(NamedTuple):
    cost: torch.Tensor
    lq: torch.Tensor     # (nv,)
    lv: torch.Tensor
    la: torch.Tensor
    lu: torch.Tensor     # (dimu,)
    lf: torch.Tensor     # (nf,)
    Qqq: torch.Tensor    # (nv, nv)
    Qvv: torch.Tensor
    Qaa: torch.Tensor
    Quu: torch.Tensor    # (dimu, dimu)
    Qff: torch.Tensor    # (nf, nf)

    @staticmethod
    def zeros(nv, dimu, nf, dtype, device):
        def z(*s):
            return torch.zeros(s, dtype=dtype, device=device)
        return StageQuad(cost=z(), lq=z(nv), lv=z(nv), la=z(nv), lu=z(dimu),
                         lf=z(nf), Qqq=z(nv, nv), Qvv=z(nv, nv),
                         Qaa=z(nv, nv), Quu=z(dimu, dimu), Qff=z(nf, nf))

    def __add__(self, o):
        return StageQuad(*(a + b for a, b in zip(self, o)))


class TerminalQuad(NamedTuple):
    cost: torch.Tensor
    lq: torch.Tensor
    lv: torch.Tensor
    Qqq: torch.Tensor
    Qvv: torch.Tensor

    @staticmethod
    def zeros(nv, dtype, device):
        def z(*s):
            return torch.zeros(s, dtype=dtype, device=device)
        return TerminalQuad(z(), z(nv), z(nv), z(nv, nv), z(nv, nv))

    def __add__(self, o):
        return TerminalQuad(*(a + b for a, b in zip(self, o)))


class ImpactQuad(NamedTuple):
    cost: torch.Tensor
    lq: torch.Tensor
    lv: torch.Tensor
    ldv: torch.Tensor
    Qqq: torch.Tensor
    Qvv: torch.Tensor
    Qdvdv: torch.Tensor

    @staticmethod
    def zeros(nv, dtype, device):
        def z(*s):
            return torch.zeros(s, dtype=dtype, device=device)
        return ImpactQuad(z(), z(nv), z(nv), z(nv), z(nv, nv), z(nv, nv),
                          z(nv, nv))

    def __add__(self, o):
        return ImpactQuad(*(a + b for a, b in zip(self, o)))


def _takes_kin(comp, kin):
    return kin is not None and getattr(comp, "kin_frame_ids", None) == kin[0]


def quadratize_stage(components, model, nf, q, v, a, u, f, t, dt, kin=None):
    """Sum of the components' stage quadratizations. kin (optional):
    (frame_ids, task, Jq), task kinematics from the stage's shared chain;
    components whose `kin_frame_ids` match take it instead of running
    their own kinematics."""
    out = StageQuad.zeros(model.nv, model.dimu, nf, q.dtype, q.device)
    for comp in components:
        if _takes_kin(comp, kin):
            out = out + comp.quadratize_stage_kin(model, nf, q, v, a, u, f,
                                                  t, dt, kin[1], kin[2])
        else:
            out = out + comp.quadratize_stage(model, nf, q, v, a, u, f, t,
                                              dt)
    return out


def quadratize_impact(components, model, q, v, dv, t, kin=None):
    out = ImpactQuad.zeros(model.nv, q.dtype, q.device)
    for comp in components:
        if _takes_kin(comp, kin):
            out = out + comp.quadratize_impact_kin(model, q, v, dv, t,
                                                   kin[1], kin[2])
        else:
            out = out + comp.quadratize_impact(model, q, v, dv, t)
    return out


def quadratize_terminal(components, model, q, v, t):
    out = TerminalQuad.zeros(model.nv, q.dtype, q.device)
    for comp in components:
        out = out + comp.quadratize_terminal(model, q, v, t)
    return out


def kin_fold_frames(components):
    """Frames a stage chain should bake task kinematics for, or None."""
    for comp in components:
        fids = getattr(comp, "kin_frame_ids", None)
        if fids is not None:
            return tuple(fids)
    return None

"""Cost container and the per-stage quadratization interface
(counterpart of robotoc_tpu/costs/base.py). Components have
quadratize_stage / quadratize_terminal methods returning Gauss-Newton
blocks; missing blocks are zeros so a tuple of components just sums.
Their eval_* methods give the cost alone (the line search's evaluation
pass). `DiscountedCost` wraps any component in an exponential time
discount."""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class DiscountedCost:
    """A cost component scaled by gamma^((t - t0) / dt_d) at its grid time
    t, in every quadratization and cost (the discount factor gamma per
    discount time step dt_d)."""
    base: object
    gamma: float
    dt_d: float
    t0: float = 0.0

    def _scale(self, t):
        return self.gamma ** ((t - self.t0) / self.dt_d)

    def replace(self, **kw):
        """The discount around the base component with fields replaced."""
        return dataclasses.replace(
            self, base=dataclasses.replace(self.base, **kw))

    def quadratize_stage(self, model, nf, q, v, a, u, f, t, dt):
        quad = self.base.quadratize_stage(model, nf, q, v, a, u, f, t, dt)
        return type(quad)(*(self._scale(t) * x for x in quad))

    def quadratize_terminal(self, model, q, v, t):
        quad = self.base.quadratize_terminal(model, q, v, t)
        return type(quad)(*(self._scale(t) * x for x in quad))

    def quadratize_impact(self, model, q, v, dv, t):
        quad = self.base.quadratize_impact(model, q, v, dv, t)
        return type(quad)(*(self._scale(t) * x for x in quad))

    def eval_stage(self, model, q, v, a, u, f, t, dt):
        return self._scale(t) * self.base.eval_stage(model, q, v, a, u, f,
                                                     t, dt)

    def eval_terminal(self, model, q, v, t):
        return self._scale(t) * self.base.eval_terminal(model, q, v, t)

    def eval_impact(self, model, q, v, dv, t):
        return self._scale(t) * self.base.eval_impact(model, q, v, dv, t)


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


def eval_stage(components, model, q, v, a, u, f, t, dt):
    return sum(comp.eval_stage(model, q, v, a, u, f, t, dt)
               for comp in components)


def eval_terminal(components, model, q, v, t):
    return sum(comp.eval_terminal(model, q, v, t) for comp in components)


def eval_impact(components, model, q, v, dv, t):
    return sum(comp.eval_impact(model, q, v, dv, t) for comp in components)

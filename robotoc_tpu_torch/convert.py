"""Build the port's objects from plain field dictionaries.

Each function takes the fields of one object as a dict: arrays as numpy
arrays (or anything `torch.as_tensor` takes), static fields (tuples, ints,
floats, strings) as they are. A caller holding another implementation's
objects (the JAX package, a checkpoint) hands over their fields this way,
so this package never needs that implementation to compute the same thing
from the same inputs.

Floating arrays take `dtype` (default float64); boolean arrays stay
boolean. Every tensor goes to `device` (default: the CUDA card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constraints.joint_limits import JointLimits
from .core.structs import LQRData, LQRPolicy
from .costs import task_cost as tc
from .costs.base import DiscountedCost
from .costs.config_cost import ConfigurationSpaceCost
from .costs.task_cost import BaseRotationCost, MultiFrameTaskCost
from .device import resolve
from .mpc.control_policy import ControlPolicy
from .mpc.refs import (StepBaseRotRef, StepCoMRef, StepConfigurationRef,
                       StepSwingFootRef)
from .models.contacts import ContactModel
from .models.robot import RobotModel
from .parnmpc.solver import ParNMPCSolution
from .planner.contact_sequence import GridData
from .solver.ocp_solver import Solution
from .solver.unconstr_ocp_solver import UnconstrSolution


def _tensor(x, dtype, device):
    a = np.array(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.float64, copy=False), dtype=dtype,
                           device=device)


def _build(cls, fields: dict, dtype, device, nested=None):
    """cls(**fields) with array fields converted; `nested` maps a field to
    the converter of its own field dict."""
    dev = resolve(device)
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for name, val in fields.items():
        if name not in names:
            raise ValueError(f"{cls.__name__} has no field {name!r}")
        if nested and name in nested:
            kw[name] = nested[name](val, dtype=dtype, device=device)
        elif val is None or isinstance(val, (str, bool, int, float, tuple)):
            kw[name] = val
        else:
            kw[name] = _tensor(val, dtype, dev)
    return cls(**kw)


def astype(obj, dtype):
    """`obj` with every floating tensor cast to dtype: a tensor, a tuple or
    list of objects, or a dataclass (a model, contact model, grid, cost,
    reference or solution), its dataclass fields cast in turn. Anything
    else comes back as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.dtype.is_floating_point else obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(astype(x, dtype) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: astype(getattr(obj, f.name), dtype)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def robot_model(fields: dict, dtype=torch.float64, device=None) -> RobotModel:
    return _build(RobotModel, fields, dtype, device)


def contact_model(fields: dict, dtype=torch.float64,
                  device=None) -> ContactModel:
    return _build(ContactModel, fields, dtype, device)


def joint_limits(fields: dict, dtype=torch.float64,
                 device=None) -> JointLimits:
    return _build(JointLimits, fields, dtype, device)


def config_cost(fields: dict, dtype=torch.float64,
                device=None) -> ConfigurationSpaceCost:
    """fields["q_ref_fn"] (optional): None, or the field dict of a
    StepConfigurationRef."""
    return _build(ConfigurationSpaceCost, fields, dtype, device,
                  nested={"q_ref_fn": _optional(step_configuration_ref)})


def _optional(convert_fn):
    """convert_fn for a field that may be None."""
    def fn(val, dtype, device):
        return None if val is None else convert_fn(val, dtype=dtype,
                                                   device=device)
    return fn


def grid_data(fields: dict, dtype=torch.float64, device=None) -> GridData:
    return _build(GridData, fields, dtype, device)


def solution(fields: dict, dtype=torch.float64, device=None) -> Solution:
    return _build(Solution, fields, dtype, device)


def unconstr_solution(fields: dict, dtype=torch.float64,
                      device=None) -> UnconstrSolution:
    return _build(UnconstrSolution, fields, dtype, device)


def parnmpc_solution(fields: dict, dtype=torch.float64,
                     device=None) -> ParNMPCSolution:
    return _build(ParNMPCSolution, fields, dtype, device)


def lqr_data(fields: dict, dtype=torch.float64, device=None) -> LQRData:
    return _build(LQRData, fields, dtype, device)


def lqr_policy(fields: dict, dtype=torch.float64,
               device=None) -> LQRPolicy:
    """The JAX package's policy also holds the pieces of its multi-RHS
    sweeps (GiPhiuT, S_chol), which this package does not keep: they are
    left out."""
    return _build(LQRPolicy, {k: v for k, v in fields.items()
                              if k not in ("GiPhiuT", "S_chol")},
                  dtype, device)


def control_policy(fields: dict, dtype=torch.float64,
                   device=None) -> ControlPolicy:
    """fields: t (a float) and the five arrays of a ControlPolicy."""
    dev = resolve(device)
    return ControlPolicy(**{
        k: float(v) if k == "t" else _tensor(v, dtype, dev)
        for k, v in fields.items()})


def step_swing_foot_ref(fields: dict, dtype=torch.float64,
                        device=None) -> StepSwingFootRef:
    return _build(StepSwingFootRef, fields, dtype, device)


def step_com_ref(fields: dict, dtype=torch.float64,
                 device=None) -> StepCoMRef:
    return _build(StepCoMRef, fields, dtype, device)


def step_base_rot_ref(fields: dict, dtype=torch.float64,
                      device=None) -> StepBaseRotRef:
    return _build(StepBaseRotRef, fields, dtype, device)


def step_configuration_ref(fields: dict, dtype=torch.float64,
                           device=None) -> StepConfigurationRef:
    return _build(StepConfigurationRef, fields, dtype, device)


def base_rotation_cost(fields: dict, dtype=torch.float64,
                       device=None) -> BaseRotationCost:
    """fields["ref"]: the field dict of a StepBaseRotRef."""
    return _build(BaseRotationCost, fields, dtype, device,
                  nested={"ref": step_base_rot_ref})


def multi_frame_task_cost(fields: dict, dtype=torch.float64,
                          device=None) -> MultiFrameTaskCost:
    """fields["foot_refs"] / ["com_ref"]: the field dicts of a
    StepSwingFootRef stacked over the feet and of a StepCoMRef, or of any
    task-space references of `reference` (the feet's stacked)."""
    def pick(step):
        def convert_ref(f, dtype, device):
            if "valid" in f:
                return step(f, dtype=dtype, device=device)
            return reference(f, dtype=dtype, device=device)
        return convert_ref

    return _build(MultiFrameTaskCost, fields, dtype, device,
                  nested={"foot_refs": pick(step_swing_foot_ref),
                          "com_ref": pick(step_com_ref)})


def constant_ref(fields: dict, dtype=torch.float64,
                 device=None) -> tc.ConstantRef:
    return _build(tc.ConstantRef, fields, dtype, device)


def periodic_swing_foot_ref(fields: dict, dtype=torch.float64,
                            device=None) -> tc.PeriodicSwingFootRef:
    return _build(tc.PeriodicSwingFootRef, fields, dtype, device)


def periodic_com_ref(fields: dict, dtype=torch.float64,
                     device=None) -> tc.PeriodicCoMRef:
    return _build(tc.PeriodicCoMRef, fields, dtype, device)


def se3_ref(fields: dict, dtype=torch.float64, device=None) -> tc.SE3Ref:
    return _build(tc.SE3Ref, fields, dtype, device)


def discrete_time_swing_foot_ref(fields: dict, dtype=torch.float64,
                                 device=None) -> tc.DiscreteTimeSwingFootRef:
    return _build(tc.DiscreteTimeSwingFootRef, fields, dtype, device)


def discrete_time_com_ref(fields: dict, dtype=torch.float64,
                          device=None) -> tc.DiscreteTimeCoMRef:
    return _build(tc.DiscreteTimeCoMRef, fields, dtype, device)


# the task-space references, told apart by their field names
_REFS = ((("R", "p"), se3_ref), (("p",), constant_ref),
         (("p0",), periodic_swing_foot_ref), (("com0",), periodic_com_ref),
         (("bounds", "pos"), discrete_time_swing_foot_ref),
         (("bounds", "com"), discrete_time_com_ref))


def reference(fields: dict, dtype=torch.float64, device=None):
    """The task-space reference whose fields these are: a ConstantRef,
    SE3Ref, PeriodicSwingFootRef, PeriodicCoMRef, DiscreteTimeSwingFootRef
    or DiscreteTimeCoMRef, picked by its field names."""
    for names, fn in _REFS:
        if all(n in fields for n in names):
            return fn(fields, dtype=dtype, device=device)
    raise ValueError(f"no reference has the fields {sorted(fields)}")


def task_space_3d_cost(fields: dict, dtype=torch.float64,
                       device=None) -> tc.TaskSpace3DCost:
    """fields["ref"]: the field dict of a reference (`reference`)."""
    return _build(tc.TaskSpace3DCost, fields, dtype, device,
                  nested={"ref": reference})


def com_cost(fields: dict, dtype=torch.float64, device=None) -> tc.CoMCost:
    """fields["ref"]: the field dict of a reference (`reference`)."""
    return _build(tc.CoMCost, fields, dtype, device,
                  nested={"ref": reference})


def task_space_6d_cost(fields: dict, dtype=torch.float64,
                       device=None) -> tc.TaskSpace6DCost:
    """fields["ref"]: the field dict of an SE3Ref."""
    return _build(tc.TaskSpace6DCost, fields, dtype, device,
                  nested={"ref": se3_ref})


def local_contact_force_cost(fields: dict, dtype=torch.float64,
                             device=None) -> tc.LocalContactForceCost:
    return _build(tc.LocalContactForceCost, fields, dtype, device)


def discounted_cost(fields: dict, dtype=torch.float64,
                    device=None) -> DiscountedCost:
    """fields: base (the port's component, already built), gamma, dt_d and
    t0 (floats)."""
    return DiscountedCost(fields["base"], float(fields["gamma"]),
                          float(fields["dt_d"]), float(fields.get("t0", 0.0)))

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
from .core.structs import LQRData
from .costs.config_cost import ConfigurationSpaceCost
from .costs.task_cost import BaseRotationCost, MultiFrameTaskCost
from .device import resolve
from .mpc.refs import StepBaseRotRef, StepCoMRef, StepSwingFootRef
from .models.contacts import ContactModel
from .models.robot import RobotModel
from .planner.contact_sequence import GridData
from .solver.ocp_solver import Solution


def _tensor(x, dtype, device):
    a = np.array(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.float64, copy=False), dtype=dtype,
                           device=device)


def _build(cls, fields: dict, dtype, device, drop_none=(), nested=None):
    """cls(**fields) with array fields converted. Fields named in
    `drop_none` are accepted only when None (not ported yet); `nested`
    maps a field to the converter of its own field dict."""
    dev = resolve(device)
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for name, val in fields.items():
        if name in drop_none:
            if val is not None:
                raise NotImplementedError(f"{cls.__name__}.{name} is not "
                                          "ported yet")
            continue
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
    return _build(ConfigurationSpaceCost, fields, dtype, device,
                  drop_none=("q_ref_fn",))


def grid_data(fields: dict, dtype=torch.float64, device=None) -> GridData:
    return _build(GridData, fields, dtype, device)


def solution(fields: dict, dtype=torch.float64, device=None) -> Solution:
    return _build(Solution, fields, dtype, device)


def lqr_data(fields: dict, dtype=torch.float64, device=None) -> LQRData:
    return _build(LQRData, fields, dtype, device)


def step_swing_foot_ref(fields: dict, dtype=torch.float64,
                        device=None) -> StepSwingFootRef:
    return _build(StepSwingFootRef, fields, dtype, device)


def step_com_ref(fields: dict, dtype=torch.float64,
                 device=None) -> StepCoMRef:
    return _build(StepCoMRef, fields, dtype, device)


def step_base_rot_ref(fields: dict, dtype=torch.float64,
                      device=None) -> StepBaseRotRef:
    return _build(StepBaseRotRef, fields, dtype, device)


def base_rotation_cost(fields: dict, dtype=torch.float64,
                       device=None) -> BaseRotationCost:
    """fields["ref"]: the field dict of a StepBaseRotRef."""
    return _build(BaseRotationCost, fields, dtype, device,
                  nested={"ref": step_base_rot_ref})


def multi_frame_task_cost(fields: dict, dtype=torch.float64,
                          device=None) -> MultiFrameTaskCost:
    """fields["foot_refs"] / ["com_ref"]: the field dicts of a
    StepSwingFootRef stacked over the feet and of a StepCoMRef."""
    return _build(MultiFrameTaskCost, fields, dtype, device,
                  nested={"foot_refs": step_swing_foot_ref,
                          "com_ref": step_com_ref})

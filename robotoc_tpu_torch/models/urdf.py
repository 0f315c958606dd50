"""Reduced rigid-body model spec (host-side numpy structure).

The port's own copy of the `ModelSpec` part of robotoc_tpu/models/urdf.py:
the static skeleton (joint types, parents, frames) and the numeric inertial
and placement data that `models/robot.from_spec` turns into tensors. The
URDF parser itself is not ported yet; bundled robots load from JSON
(models/serialize.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Joint type codes (static Python ints, used for branching at call time).
FREE = 0
REVOLUTE = 1
PRISMATIC = 2


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


@dataclasses.dataclass
class Body:
    """Inertial data in a link frame: mass, com, rotational inertia at com."""
    mass: float
    com: np.ndarray          # (3,)
    I_c: np.ndarray          # (3, 3) about com, link-frame axes


@dataclasses.dataclass
class JointSpec:
    name: str
    jtype: int               # FREE / REVOLUTE / PRISMATIC
    parent: int              # index into joints list, -1 = world
    R: np.ndarray            # placement in parent joint frame
    p: np.ndarray
    axis: np.ndarray         # (3,) for revolute/prismatic
    lower: float
    upper: float
    velocity: float
    effort: float


@dataclasses.dataclass
class FrameSpec:
    name: str
    parent_joint: int        # supporting movable joint index, -1 = root
    R: np.ndarray
    p: np.ndarray


@dataclasses.dataclass
class ModelSpec:
    name: str
    floating_base: bool
    joints: list             # list[JointSpec], topological order
    bodies: list             # list[Body], inertia at each joint's frame
    frames: list             # list[FrameSpec]
    nq: int = 0
    nv: int = 0

    def frame_id(self, name: str) -> int:
        for i, f in enumerate(self.frames):
            if f.name == name:
                return i
        raise KeyError(f"unknown frame: {name}")

"""JSON robot descriptions -> ModelSpec (the port's copy of
robotoc_tpu/models/serialize.py, load direction only)."""
from __future__ import annotations

import json

import numpy as np

from .urdf import Body, FrameSpec, JointSpec, ModelSpec


def dict_to_spec(d: dict) -> ModelSpec:
    joints = [JointSpec(
        j["name"], j["type"], j["parent"],
        np.array(j["R"]), np.array(j["p"]), np.array(j["axis"]),
        float(j["lower"]), float(j["upper"]),
        float(j["velocity"]), float(j["effort"]),
    ) for j in d["joints"]]
    bodies = [Body(b["mass"], np.array(b["com"]), np.array(b["I_c"]))
              for b in d["bodies"]]
    frames = [FrameSpec(f["name"], f["parent_joint"],
                        np.array(f["R"]), np.array(f["p"]))
              for f in d["frames"]]
    return ModelSpec(d["name"], d["floating_base"], joints, bodies, frames,
                     nq=d["nq"], nv=d["nv"])


def load_json(path: str) -> ModelSpec:
    with open(path) as f:
        return dict_to_spec(json.load(f))

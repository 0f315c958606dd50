"""Robot model layer: bundled JSON descriptions, kinematics and dynamics."""
import os

import torch

from .robot import RobotModel, from_spec
from .serialize import load_json

_DESC_DIR = os.path.join(os.path.dirname(__file__), "..", "descriptions")


def load_robot(name: str, dtype=torch.float64, device=None) -> RobotModel:
    """Load a bundled robot description onto `device` (default: cuda)."""
    path = os.path.join(_DESC_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no bundled description '{name}' (have: "
            f"{sorted(f[:-5] for f in os.listdir(_DESC_DIR))})")
    return from_spec(load_json(path), dtype=dtype, device=device)

"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    Asking for CUDA where no card is visible raises: the port never falls
    back to the CPU on its own. Tests pass device="cpu" explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev

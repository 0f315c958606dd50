"""Ready-made problems of the port.

`anymal_standing` builds the ANYmal contact OCP that
tests/golden/anymal_standing_ocp.npz pins: four point contacts with
5-facet friction cones, joint limits and a configuration cost, all feet
in stance, T = 0.5, no impact slots.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constraints.joint_limits import JointLimits, make_joint_limits
from .costs.config_cost import ConfigurationSpaceCost, make_config_cost
from .models import load_robot
from .models import robot as rm
from .models.contacts import ContactModel, make_contacts
from .planner.contact_sequence import (ContactSchedule, GridData,
                                       discretize)

FEET = ("LF_FOOT", "LH_FOOT", "RF_FOOT", "RH_FOOT")
Q_STAND = (0, 0, 0.4792, 0, 0, 0, 1, -0.1, 0.7, -1.0, -0.1, -0.7, 1.0, 0.1,
           0.7, -1.0, 0.1, -0.7, 1.0)


@dataclasses.dataclass
class Problem:
    model: rm.RobotModel
    contacts: ContactModel
    cost: ConfigurationSpaceCost
    limits: JointLimits
    grid: GridData
    q0: torch.Tensor
    v0: torch.Tensor
    T: float
    N: int


def anymal_standing(N: int = 20, T: float = 0.5, dtype=torch.float64,
                    device=None) -> Problem:
    m = load_robot("anymal", dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=m.device)
    contacts = make_contacts(m, list(FEET), baumgarte_time_step=0.04)
    q0 = torch.tensor(Q_STAND, **kw)
    qw = torch.tensor([0, 0, 0, 250000, 250000, 250000] + [0.0001] * 12,
                      **kw)
    vw = torch.tensor([100.0] * 6 + [1.0] * 12, **kw)
    cost = make_config_cost(m, q_ref=q0, q_weight=qw, v_weight=vw,
                            a_weight=1e-6, u_weight=1e-1,
                            q_weight_terminal=qw, v_weight_terminal=vw)
    lim = make_joint_limits(m, u_limit=torch.full((12,), 80.0, **kw),
                            v_limit=torch.full((12,), 15.0, **kw))
    Rw, pw = rm.forward_kinematics(m, q0)
    plc = np.stack([rm.frame_placement(m, m.frame_id(f), Rw, pw)[1]
                    .double().cpu().numpy() for f in FEET])
    sched = ContactSchedule(nc=len(FEET)).init([True] * len(FEET), plc)
    grid = discretize(sched, 0.0, T, N, dtype=dtype, device=m.device)
    return Problem(model=m, contacts=contacts, cost=cost, limits=lim,
                   grid=grid, q0=q0, v0=torch.zeros(m.nv, **kw), T=T, N=N)

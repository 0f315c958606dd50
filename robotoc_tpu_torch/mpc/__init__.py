"""MPC host layer: gait planning, step-indexed references, the periodic-gait
whole-body MPCs, the jump MPC and the control policy between updates
(counterparts of robotoc_tpu/mpc)."""
from .control_policy import ControlPolicy
from .foot_step_planner import (GaitFootStepPlanner, MovingWindowFilter,
                                RaibertHeuristic, TrotFootStepPlanner)
from .gait_mpc import (FEET_DEFAULT, MPCBipedWalk, MPCCrawl, MPCFlyingTrot,
                       MPCPace, PeriodicGaitMPC, crawl_foot_step_planner,
                       flying_trot_foot_step_planner,
                       pace_foot_step_planner)
from .mpc_jump import JumpFootStepPlanner, MPCJump
from .mpc_trot import MPCTrot
from .refs import (StepBaseRotRef, StepCoMRef, StepConfigurationRef,
                   StepSwingFootRef)

__all__ = [
    "ControlPolicy", "GaitFootStepPlanner", "MovingWindowFilter",
    "RaibertHeuristic", "TrotFootStepPlanner", "FEET_DEFAULT",
    "JumpFootStepPlanner", "MPCCrawl", "MPCBipedWalk", "MPCFlyingTrot",
    "MPCJump", "MPCPace", "MPCTrot", "PeriodicGaitMPC",
    "crawl_foot_step_planner", "flying_trot_foot_step_planner",
    "pace_foot_step_planner", "StepBaseRotRef", "StepCoMRef",
    "StepConfigurationRef", "StepSwingFootRef",
]

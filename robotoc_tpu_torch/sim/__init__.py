"""Closed-loop simulation of the port (counterpart of robotoc_tpu/sim): the
penalty-ground plant `LeggedSimulator` and the MPC-in-the-loop driver
`MPCSimulation`."""
from .mpc_simulation import MPCSimulation, MPCSimulationLog
from .simulator import LeggedSimulator, SimState

__all__ = ["LeggedSimulator", "MPCSimulation", "MPCSimulationLog",
           "SimState"]

"""MPC host layer: gait planning, step-indexed references and the periodic-gait
whole-body MPC (counterparts of robotoc_tpu/mpc)."""

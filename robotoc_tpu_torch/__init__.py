"""robotoc_tpu_torch: the PyTorch/CUDA port of robotoc_tpu.

The contact-OCP Newton update (`solver.ocp_solver.OCPSolver.update`) runs
on an NVIDIA Hopper card: plain PyTorch for the per-stage evaluation, and
hand-written CUDA kernels (`csrc/`) for the per-stage condensing and the
Riccati backward sweep. Every entry point places its tensors on `cuda`
unless the caller passes `device="cpu"`; on the CPU each kernel wrapper
runs its plain PyTorch version instead.

This package imports neither JAX nor anything of `robotoc_tpu`.
"""

"""Smoke run of the PyTorch/CUDA port (robotoc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  0. require a CUDA device; print the card's name and power limit and the
     TF32 switches (both off: reduced-precision products stall Newton);
  1. build the hand-written CUDA kernels from csrc/ with nvcc, one process
     per source, all at once;
  2. hold every kernel against its plain PyTorch version on the card, in
     float64 and float32: condense K1, Kc, K2, K3 on the stage slots of the
     trot fleet (K1, K2 and K3 also on the walk fleet's); the Riccati backward
     sweep K5 without switching rows
     (standing shapes) and with them (trot shapes); the chain kernel K6
     without the cost fold at the standing shapes and with it at the trot
     shapes; on the stage slots of the iCub walk fleet, K6's surface-contact
     instance without and with the cost fold and the 34-row Kc (also on
     seeded dense cone rows of the same shapes); K6 on the full iCub's
     nv 35 tree on seeded stages, without and with the fold; K6 on the A1
     crawl fleet's stage slots (no fold) and on seeded A1 stages (without
     and with it), K1 and Kc on the flying trot fleet's (flight slots
     included). Time kernel
     and library call by device time (the profiler), the plain version and
     one wrapper call by CUDA events (float32); count K6's operations on
     the host (csrc/chain_flops.cpp, g++) for its bound;
  3. "slice": the ANYmal standing contact OCP (T 0.5, N 20), B = 128
     scenarios with perturbed initial configurations, float32, two updates
     per MPC step through OCPSolver.update with the kernels (K6 without the
     cost fold); launch counts, finite KKT, agreement with the plain
     versions, time per MPC step;
  4. "trot": the main path, the mid-gait ANYmal trot MPC update (T 0.5,
     N 20, 4 impact slots, switching constraints, the gait cost stack
     folded into K6), B = 128, float32, two updates per MPC step; launch
     counts of all six kernels, finite KKT, the KKT within 1e-3 of the
     plain step's; the same MPC step of a B = 128 float64 fleet built the
     same way through the kernels against the plain versions (1e-8 of each
     field's max-abs), and the next one from its iterate rounded to float32
     (`on_sphere`); each field's float32 drift from that float64 step
     within TROT_K times the largest drift of the plain float32 steps (from
     the iterate and from two jittered copies); twelve float32 faults
     planted one at a time in one kernel's outputs, each of which the drift
     gate must refuse where the old agreement with the plain step (1e-2 of
     the step, printed, not gated) refuses it (the noise plants at 1e-5
     and 1e-6, printed only, are the "readings" phase's); time per MPC
     step, host time by part and the device idle share; then float64, one
     unperturbed
     scenario, 15 updates through the kernels, ending at KKT < 1e-3;
  5. "golden": float64, one standing scenario, 16 updates through the
     kernels: reproduce tests/golden/anymal_standing_ocp.npz to 1e-6 with
     KKT below 1e-6;
  6. "walk": the iCub lower half on two surface contacts. The standing OCP
     (N 4) in float64, 12 updates through the kernels to KKT < 1e-6; the
     biped-walk MPC (T 0.7, N 25, 3 impact slots, switching constraints,
     the gait cost stack folded into K6's surface instance, 34 cone rows
     through Kc) warmed in float64 at B = 1 the way the MPC runs (standing
     init, closed-loop updates every WALK_DT s to mid-gait t = 0.62),
     then B = 128 float32 scenarios with perturbed initial states, two
     updates per MPC step: launch counts, finite KKT, agreement with the
     plain versions (in float64 gated; in float32 reported, and the kernel
     step's drift from the float64 step gated against the plain float32
     steps'), time per MPC step;
  7. "solve": OCPSolver.solve and the line searches through the kernels:
     the golden problem in float64 through solve (16 iterations, against
     the 16 updates to 1e-10 and the golden trace to 1e-6); the barrier
     path of tests/test_barrier_schedule.py (N 6, mu 1e-2 to 1e-5) to KKT
     < 1e-7; the B = 128 float32 trot fleet with the merit search (launch
     counts, finite KKT, each accepted step at most its scenario's
     fraction-to-boundary step, the float64 fleet's merit step through the
     kernels against the plain versions to 1e-8, no synchronising call
     added by the search; printed: scenarios that backtracked, ms per MPC
     step with and without the search); the filter search through solve
     on the B = 128 standing fleet in float32 (4 iterations: finite KKT,
     launches per build); with the "readings" phase, printed, the walk
     fleet's KKT after one MPC step with the merit search;
  8. "unconstr": the unconstrained family on the iiwa14 (fixed base, no
     contacts, no kernel on its path: the six kernels' counts stay 0):
     UnconstrOCPSolver.solve reproduces tests/golden/iiwa14_config_ocp.npz
     (N 60, float64: KKT < 1e-7 in < 30 iterations, 1e-6); a B = 128
     float64 fleet with perturbed initial configurations, every scenario
     below 1e-7, two sampled scenarios equal to their own solves (1e-10),
     ms per iteration printed; the fleet in
     float32 (finite KKT gated, the rest printed); the filter search to
     KKT < 1e-7; UnconstrParNMPCSolver on tests/test_parnmpc.py's problem
     (KKT < 1e-7 in < 60 iterations, agreement with the Riccati solver at
     that test's tolerances, the filter search to 1e-6 without a
     numerical failure) and a B = 128 fleet, printed; the iiwa14
     task-space OCP (TaskSpace3DCost on a constant reference, N 30)
     through solve: KKT < 1e-7 in the JAX package's 12 iterations;
  9. "gaits": the remaining periodic gaits. The Unitree A1 crawl on a
     height map (four point feet on K6's four-feet instance, its stack not
     folded: a second configuration cost on a time-varying reference; T
     0.5, N 20) warmed in float64 at B = 1 as the MPC runs (init, then
     closed-loop updates to mid-gait, one foot in swing and its touchdown
     in the horizon), its control policy on the card against a host copy
     (1e-12); then B = 128 fleets of the crawl, the ANYmal pace (no fold)
     and the ANYmal flying trot (the fold; a flight with no contact active
     and its touchdown in the horizon), each with the trot's gates:
     launches of all six kernels, finite KKT, the float64 step through the
     kernels against the plain versions (1e-8), the float32 drift at
     TROT_K; ms per MPC step and the device idle share; the flying trot's
     kernels against their plain versions at its flight slots (float64 and
     float32, TOL);
 10. "jump": the ANYmal jump MPC (MPCJump, T 0.85, N 10: stance, a full
     flight and the landing impact with its switching constraint; one
     reserved impact slot; the KKT-residual search, whose 9 trial steps
     are one more build of 9 B scenarios). Float64 at B = 1
     (tests/test_mpc_jump.py): `init` with 30 updates to KKT < 1e-2, the
     landing targets 0.1 m ahead, `update_solution` at six times with
     finite KKT, the control input and policy finite, two builds and one
     sweep of launches per update. A B = 128 fleet of its plan at t = 0.35
     from the solver's warm start: the gait fleets' gates (launches: 4 of
     K6, K1, Kc, K2, K3 and 2 of K5 per MPC step), no synchronising call
     in an update with the search; printed: the scenarios that
     backtracked, ms per MPC step with the search. Every kernel against
     its plain version on the
     arguments of each call of one fleet update, the trial build's
     included (float64; float32, K5 there printed, gated on seeded inputs
     of the same shapes); K6 and K5 timed for the kernels line;
 11. "sim": the closed loop (float64, one scenario): the ANYmal trot MPC
     (N 20, the gait stack folded into K6) in sim.MPCSimulation against the
     penalty-ground plant (sim.LeggedSimulator, its 10 substeps a tick
     replayed as one CUDA graph): `init` with 10 updates, then 0.30 s of
     2.5 ms ticks with the feedback policy, the one-tick delay and an MPC
     update every two ticks (tests/test_mpc_simulation.py). Gates: that
     test's bounds (base height, attitude, KKT, finite controls), 2
     launches of each kernel in every MPC update, each kernel against its
     plain version on every call of one more update, the first 8 ticks
     replayed with the MPC on the plain route (1e-8 of max(1, |x|));
     printed: ms per MPC update, plant ms per tick, ms per control tick;
 12. "bounce": the offline ANYmal bounce (examples/anymal_bounce.py, one
     cycle, N 35, two touchdown impacts, a task cost on stacked periodic
     references that K6 does not fold, the KKT-residual search), float64:
     12 iterations of `solve` through the kernels and through the plain
     route (iterates and KKT histories to 5e-6 of max(1, |x|), ten times
     their rounding floor), the KKT
     below the warm start's, launches per iteration, each kernel against
     its plain version on one iteration's calls (K5 there within 1e-8 of
     both its plain version on the card and the one on the host's CPU,
     where its outputs rounded to float32 must read past 1e-8, and at TOL
     on seeded inputs);
 13. print the seconds of each phase, the kernels' JSON line, the card
     line and the final status line.
The phase "bounce_full" (not a default phase) solves the bounce through the
kernels to KKT < 1e-6 within 150 iterations (tests/test_offline_gaits.py);
"floors" (not a default phase) prints the readings behind the sim and
bounce gates: how far the sim's first ticks and the bounce's iterations
move when the initial configuration moves by 1e-15, K5 on the LQR inputs of
each of the bounce's iterations, and the plant's tick op by op and as a
CUDA graph.
The phase "readings" (not a default phase) prints the trot gate's readings
on three fleet seeds and two iterates with the planted faults' on each,
and at the later iterate where the float64 difference off the unit
quaternion sphere comes from (`phase_readings`); K5's switching branch
in float32 against its plain version and both against the plain version
in float64 on the LQR inputs of one trot and one walk fleet update
(`c2_reading`); and the walk fleet's merit-search KKT (phase solve).

    python3 chip_smoke.py --pair <tree> <phase,...> <out_dir> [runs]

runs the phases named on the package of another tree (a checkout of
another commit) and on this one in turns, on one card, each run's output
in <out_dir> (see `pair`); the phases "all" run each tree's own script
with its default phases, and runs 2 runs each tree once.
"""
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from robotoc_tpu_torch import convert, kernels, problems
from robotoc_tpu_torch.models import contacts as ct
from robotoc_tpu_torch.models import robot as rm
from robotoc_tpu_torch.mpc import ControlPolicy
from robotoc_tpu_torch.ops import chain as chn
from robotoc_tpu_torch.ops import condense as cd
from robotoc_tpu_torch.parnmpc import solver as PN
from robotoc_tpu_torch.riccati import backward_sweep as bs
from robotoc_tpu_torch.sim import MPCSimulation
from robotoc_tpu_torch.solver import ocp_solver as OS
from robotoc_tpu_torch.solver import unconstr_ocp_solver as US

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "anymal_standing_ocp.npz")
B, N = 128, 20
# H100 SXM: HBM3 rate and the non-tensor-core peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# timed repetitions of a host-clock time (host_ms: the median of REPS
# calls after one untimed; an MPC step of a path is timed on its own run)
REPS = 1
# kernel vs plain version, relative to each output's largest magnitude
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
ALL_PHASES = ("build", "kernels", "slice", "trot", "golden", "walk",
              "solve", "unconstr", "gaits", "jump", "sim", "bounce")
# the trot's float32 gate: each field's drift from the float64 step at most
# TROT_K times the largest drift among the plain float32 step and the plain
# steps from iterates jittered with these seeds: the largest round factor
# at which the gate, with the KKT's, refuses every planted fault that the
# old agreement refuses on the readings (PERF.md, section 6)
TROT_K = 7.0
JITTER_SEEDS = (7, 11)
# the faults planted in one kernel at a time to show the gate's power: the
# relative noise whose refusal is gated, and the sizes only printed
PLANT_EPS, PLANT_EPS_SHOWN = 1e-4, (1e-5, 1e-6)
# the walk's closed-loop warm start: control step (the JAX package's bench
# takes 0.005 s; 0.04 s reaches mid-gait in an eighth of the updates) and
# `init` updates (its KKT reads 1.8e-11 after 32 on the CPU and its
# rounding floor, 4e-13, from 35 on)
WALK_N, WALK_T, WALK_DT, WALK_INIT = 25, 0.62, 0.04, 32
# the gait paths: the A1 crawl warmed in float64 at B = 1 (`init` with
# CRAWL_INIT updates, closed-loop updates every CRAWL_DT s) to CRAWL_T, when
# the rear-right foot swings (its touchdown at 0.75 s, the front-right
# foot's lift at 0.8 s in the horizon); its fleet's initial states moved by
# GAIT_SCALE N(0, 1); the pace and the flying trot planned at 0.35 s from
# standing (problems.anymal_gait), their fleets as the trot's
CRAWL_T, CRAWL_DT, CRAWL_INIT, GAIT_SCALE = 0.6, 0.1, 10, 0.01
FIELDS = ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu", "s_lim",
          "z_lim", "s_cone", "z_cone")
# the jump (tests/test_mpc_jump.py): `init` updates (that test takes 60;
# the port's f64 init reads KKT 2.4e-2 after 24, 4.2e-3 after 28, 2.1e-3
# after 30 and 2.6e-5 after 40 on the CPU, its gate 1e-2) and the MPC's
# update times; the fleet's time (its horizon holds
# the flight, the landing at 0.55 with its switching rows, and stance)
# and initial-state noise. At
# the MPC's own iterates near the lift-off the switching-constrained
# Riccati is ill-conditioned (inputs moved by 1e-15 move a step by up to
# 1e-3: PERF.md), past any float64 gate between two correct kernels; at
# this warm start the same reading is 1e-10
JUMP_INIT, JUMP_T, JUMP_SCALE = 30, 0.35, 0.01
JUMP_TIMES = (0.0, 0.1, 0.25, 0.35, 0.5, 0.6)
# the closed loop (tests/test_mpc_simulation.py: the second case's driver
# options over the first case's 0.30 s): the trot MPC (N 20, float64, one
# scenario) `init` with SIM_INIT updates at t = 0, then SIM_TIME s of
# control ticks of SIM_DT with the feedback policy and the one-tick delay,
# one MPC update (two Newton updates) every SIM_STEPS ticks, against the
# penalty-ground plant; the first SIM_REPLAY ticks replayed through the
# plain route and held to SIM_TOL of max(1, |x|)
SIM_TIME, SIM_DT, SIM_STEPS, SIM_INIT = 0.30, 0.0025, 2, 10
SIM_REPLAY, SIM_TOL = 8, 1e-8
# the bounce (examples/anymal_bounce.py, one cycle, float64): the first
# BOUNCE_ITERS iterations of its solve on each route, held to BOUNCE_TOL of
# max(1, |x|): ten times their rounding floor (the initial configuration
# moved by 1e-15 moves the iterates by up to 4.7e-7 of max(1, |x|) on an
# H100: phase "floors", PERF.md), above the 1e-9 under which the 1e-8 gate
# would have held; "bounce_full" solves it to KKT 1e-6 in at most
# BOUNCE_FULL_ITERS iterations (tests/test_offline_gaits.py)
BOUNCE_ITERS, BOUNCE_TOL, BOUNCE_FULL_ITERS = 12, 5e-6, 150
# K5 (float64) on the LQR inputs of the bounce's iteration after its 12,
# against its plain version on the card and on the host's CPU, relative to
# each output's max-abs: above the sweep's own rounding floor there (its
# plain version moves by 1.3e-9 to 2.4e-9 when the inputs move by 1e-15;
# the kernel reads 9.0e-10) and below a kernel whose outputs are rounded to
# float32 (4.2e-8 to 5.5e-8 on the bounce's well-conditioned iterations;
# phase "floors", PERF.md)
K5_BOUNCE_TOL = 1e-8
# K6's records: (key in the kernels line, name) of each case; the full
# iCub's nv 35 instance runs on this many seeded stages (no path runs it)
K6_RECORDS = {"point fold": ("K6", "K6 chain"),
              "point": ("K6 nofold", "K6 chain no fold"),
              "surface fold": ("K6s", "K6 chain surface"),
              "surface": ("K6s nofold", "K6 chain surface no fold"),
              "nv35 fold": ("K6 nv35", "K6 chain surface nv35"),
              "nv35": ("K6 nv35 nofold", "K6 chain surface nv35 no fold"),
              "a1": ("K6 a1 nofold", "K6 chain A1 no fold")}
K6_NV35_STAGES = 1024
# and the A1's four-feet tree on this many seeded stages (compared only)
K6_A1_STAGES = 1024
# what each time of a kernel's record measures
CLOCK = {"ms": "device", "library_ms": "device", "call_ms": "events",
         "plain_ms": "events"}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of one call of `fn`, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_events(fn, calls, tries=3):
    """Durations (ms) of the device activity the profiler records while
    `fn` runs `calls` times, in order. A session can record none (seen on
    an H100 in the first session of a run): up to `tries` sessions are
    made, and [] is returned if none records any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [(e.name, e.time_range.elapsed_us() / 1e3)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if times:
            return times
    return []


def kernel_ms(fn, reps=20, warmup=3):
    """Device time of the kernels one call of `fn` launches and the clock
    it was read on. By the profiler's CUDA activity ("device"): median over
    `reps` calls of their sum. CUDA events around one call (cuda_ms) also
    hold the wrapper's host time when the card waits for it; this does
    not. Where the profiler records no device activity, or not the same
    number of events for each call in three sessions, CUDA events around
    `reps` calls in a row, over `reps` ("events")."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a session whose count of device events is not a whole number of
    # calls lost some (read as an average, it would undercount): up to
    # three sessions, then CUDA events
    for _ in range(3):
        times = [t for _, t in _device_events(fn, reps)]
        if len(times) % reps == 0:
            break
    if not times or len(times) % reps:
        print("  kernel_ms: the profiler recorded no device activity or "
              "lost some; timed by CUDA events instead", flush=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, "events"
    per = len(times) // reps     # the same kernels each call, in order
    return float(np.median([sum(times[i:i + per])
                            for i in range(0, len(times), per)])), "device"


def host_ms(fn, reps=None, warmup=True):
    """Median wall time of `fn` ending in a device synchronise, over `reps`
    timed calls (REPS when None) after one untimed (none without `warmup`:
    for work whose glue has just run)."""
    reps = REPS if reps is None else reps
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_time(fn):
    """Total device time of the kernels one call of `fn` launches, by the
    profiler's CUDA activity, in ms, and the five largest kernels by name.
    (None, {}) when the profiler records no device activity."""
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for name, t in _device_events(fn, 1):
        by_name[name] = by_name.get(name, 0.0) + t
    if not by_name:
        return None, {}
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    return sum(by_name.values()), {k[:60]: v for k, v in top.items()}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# operation counts per stage (K1-K3) or per step (K5), from the dims; K6's
# is counted on this run's inputs (ops/chain.op_count)
# ---------------------------------------------------------------------------

def flops_k1(nv, nf, w):
    ny = nv + nf
    return 2 * ny ** 3 + 2 * ny * ny * w + 2 * ny * ny + 3 * ny * ny


def flops_kc(nv, nf, nc):
    return 2 * nc * (nv * nv + nv * nf + nf * nf) + nc * (nv + nf)


def flops_k2(nv, nu, nf):
    w, ny, nx = 2 * nv + nu, nv + nf, 2 * nv
    return (2 * (nv * nv + nf * nf) * w + 2 * nv * nf * w
            + 2 * ny * (nx * nx + nx * nu + nu * nu) + 2 * ny * w
            + 2 * (nv * nv + nf * nf + nv * nf) + 3 * nx * nx)


def flops_k3(nv, nu):
    nx = 2 * nv
    return nv * nx + 2 * nx * nx + 2 * nx * nu + 2 * nx


def flops_k5_step(nx, nu, nf):
    f = (4 * nx ** 3 + 4 * nx * nx * nu + 2 * nu * nu * nx + 2 * nu ** 3
         + 2 * nu * nu * nx + 2 * nx * nx * nu + 6 * nx * nx + 4 * nx * nu)
    if nf:
        f += (2 * nu * nu * nf + 2 * nf * nu * nx + 2 * nf * nu * nf
              + 2 * nf ** 3 + 2 * nf * nf * nx + 2 * nu * nf * nx
              + 2 * nf * nx * nx)
    return f


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def standing_fleet(p, Bn):
    solver = OS.OCPSolver(p.model, p.contacts, (p.cost,), p.limits, T=p.T,
                          N=p.N)
    return solver, problems.fleet(solver, p.grid, p.q0, p.v0, Bn)


def perturbed(model, sol, seed=3, scale=0.05):
    """The fleet iterate moved off its warm start by seeded noise, so that
    every stage slot of every scenario differs."""
    rng = np.random.default_rng(seed)
    kw = dict(dtype=sol.q.dtype, device=sol.q.device)

    def r(x, s=scale):
        return torch.as_tensor(s * rng.standard_normal(tuple(x.shape)), **kw)

    return sol.replace(
        q=rm.integrate(model, sol.q, r(sol.v)), v=sol.v + r(sol.v),
        a=sol.a + r(sol.a, 0.5), u=sol.u + r(sol.u, 0.5),
        f=sol.f + r(sol.f, 5.0))


def trot_inputs(dev, dtype=torch.float64, make=problems.anymal_trot):
    """The trot fleet (B scenarios) at a perturbed iterate: problem and
    fleet-shaped (sol, grid). `make` builds another gait problem the same
    way (the walk)."""
    p = make(dtype=dtype, device=dev)
    sol, q0s, v0s = problems.fleet(p.solver, p.grid, p.q0, p.v0, B)
    sol_b, grid_b, _, _, _ = OS._fleet(perturbed(p.model, sol), p.grid, q0s,
                                       v0s)
    return p, sol_b, grid_b


def walk_problem(dtype=torch.float64, device=None):
    """The iCub walk at full width, planned mid-gait from standing."""
    return problems.icub_walk(N=WALK_N, dtype=dtype, device=device,
                              t0=WALK_T)


def crawl_problem(N=N, dtype=torch.float64, device=None):
    """The A1 crawl at full width, planned at CRAWL_T from standing."""
    return problems.a1_crawl(N=N, dtype=dtype, device=device, t0=CRAWL_T)


def gait_problem(name):
    """problems.anymal_gait(name, ...) ("pace", "flying_trot") as a
    builder of N, dtype and device."""
    def make(N=N, dtype=torch.float64, device=None):
        return problems.anymal_gait(name, N=N, dtype=dtype, device=device)
    return make


def flight_slots(grid):
    """Stage slots of a grid (one scenario's) where no contact is active,
    impact slots left out."""
    cm = grid.contact_mask[:-1].sum(dim=-1).cpu()
    imp = grid.is_impact[:-1].cpu()
    return [i for i in range(cm.shape[0]) if cm[i] == 0 and imp[i] == 0]


def chain_args(model, contacts, costs, sol_b, grid_b, with_cost):
    """K6's inputs for every stage slot of a fleet, as the solver makes
    them."""
    fl = OS._flat
    rowmask = contacts.force_mask(grid_b.contact_mask[:, :-1])
    args = [fl(x).contiguous() for x in (
        sol_b.q[:, :-1], sol_b.v[:, :-1], sol_b.a[:, :-1],
        sol_b.f[:, :-1] * rowmask, grid_b.friction[:, :-1],
        grid_b.p_ref[:, :-1], grid_b.R_ref[:, :-1])]
    cost = (list(chn.cost_fold_inputs(model, contacts, costs, grid_b,
                                      sol_b)) if with_cost else [])
    return args, cost


def lqr_inputs(nf, dtype, dev, Nh, seed=1, nx=36, nu=12):
    """Seeded well-conditioned LQR data (B, Nh, ...) at the slice widths;
    with nf > 0, some steps carry masked switching rows."""
    rng = np.random.default_rng(seed)

    def r(*sh):
        return 0.3 * rng.standard_normal((B,) + sh)

    def spd(X, n):
        return X @ np.swapaxes(X, -1, -2) + 2.0 * np.eye(n)

    f = dict(A=r(Nh, nx, nx) / 3 + np.eye(nx), B=r(Nh, nx, nu),
             xres=r(Nh, nx), Qxx=spd(r(Nh, nx, nx), nx),
             Qxu=0.1 * r(Nh, nx, nu), Quu=spd(r(Nh, nu, nu), nu),
             lx=r(Nh, nx), lu=r(Nh, nu), QxxN=spd(r(nx, nx), nx), lxN=r(nx))
    if nf:
        sw = ((rng.uniform(size=(B, Nh, nf)) < 0.5)
              * (rng.uniform(size=(B, Nh, 1)) < 0.3)).astype(float)
        # at most half the rows active, as when two feet touch down: all
        # nf = nu rows of random Phiu make the Schur block S ill-conditioned
        sw[..., nf // 2:] = 0.0
        f.update(Phix=r(Nh, nf, nx) * sw[..., None],
                 Phiu=r(Nh, nf, nu) * sw[..., None], Pc=r(Nh, nf) * sw, sw=sw)
    order = ("A", "B", "xres", "Qxx", "Qxu", "Quu", "lx", "lu", "QxxN",
             "lxN", "Phix", "Phiu", "Pc", "sw")
    return [torch.as_tensor(f[k], dtype=dtype, device=dev).contiguous()
            if k in f else None for k in order]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    built = kernels.build()
    kernels.host_library("chain_flops")     # K6's operation count (g++)
    secs = time.perf_counter() - t0
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                print(f"  {name}: {line.strip()}")
    print(f"build: {sorted(built)} in {secs:.1f} s (nvcc, one process per "
          "source, in parallel; full logs beside the libraries in "
          "build/kernels/)")
    return secs


def _compare(name, kern_out, plain_out, dtype):
    """max abs error over the outputs; raises past TOL relative to each
    output's largest magnitude."""
    worst = 0.0
    for i, (k, p) in enumerate(zip(kern_out, plain_out)):
        if p is None:
            check(k is None, f"{name}: output {i} missing")
            continue
        check(bool(torch.isfinite(k).all()), f"{name}: output {i} "
              "not finite")
        err = float((k - p).abs().max())
        scale = max(float(p.abs().max()), 1e-30)
        check(err <= TOL[dtype] * scale,
              f"{name} {dtype}: output {i} max error {err:.3e} > "
              f"{TOL[dtype]:.0e} x {scale:.3e}")
        worst = max(worst, err)
    print(f"  {name:10s} {str(dtype):14s} max_abs_err {worst:.3e} "
          f"(tolerance {TOL[dtype]:.0e} x each output's max-abs)")
    return worst


def _record(name, source, replaces, err, kern, plain, b, lib=None,
            plain_reps=1):
    """A kernel's record, timed in float32: `ms` and `library_ms` by device
    time (kernel_ms, the profiler), `call_ms` (one call of the wrapper) and
    `plain_ms` (one call of the plain version) by CUDA events, host time
    included. `clock` says which (kernel_ms falls back to CUDA events
    where the profiler records nothing)."""
    ms, ms_clock = kernel_ms(kern)
    lib_ms, lib_clock = (None, CLOCK["library_ms"]) if lib is None \
        else kernel_ms(lib)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=ms,
                plain_ms=cuda_ms(plain, reps=plain_reps, warmup=1),
                bound_ms=b[0], bound_by=b[1], library_ms=lib_ms,
                call_ms=cuda_ms(kern),
                clock=dict(CLOCK, ms=ms_clock, library_ms=lib_clock))


def _op_counts(pool, model, contacts, args, cost, chunk=256):
    """K6's operation count (ops/chain.op_count) of these stages, in chunks
    on the host thread pool (ctypes releases the GIL; the count adds over
    stages). Returns a function that waits for (value, tangent)."""
    ins = [x.cpu() for x in list(args) + list(cost)]
    parts = [pool.submit(chn.op_count, model, contacts,
                         *[x[i:i + chunk] for x in ins])
             for i in range(0, ins[0].shape[0], chunk)]
    return lambda: tuple(map(sum, zip(*[f.result() for f in parts])))


def _k12_inputs(x):
    """K1's and K2's inputs from one fleet's condense inputs, as
    ops/condense.condense forms them (K2's from the plain K1 and Kc)."""
    k1_in = [x[n] for n in ("M", "J", "inactive", "Tw1", "Tw2", "r1", "e2")]
    _, _, _, G, c0 = cd.k1_plain(*k1_in)
    Hqq, Hqf, Hff = cd.kc_plain(x["dgdq"], x["dgdf"], x["d_cone"])
    d = torch.diag_embed
    k2_in = [G, c0, x["Wq"] + d(x["Hq_d"]) + Hqq, x["Wv"] + d(x["Hv_d"]),
             x["Wu"] + d(x["Hu_d"]), x["Wa"] + d(x["Ha_d"]), x["Wf"] + Hff,
             Hqf, x["gw"], x["gy"]]
    return k1_in, [t.contiguous() for t in k2_in]


def lqr_of_update(p):
    """The LQR inputs one fleet update hands to K5 (bs.bwd): problem p's
    solver on B scenarios (problems.fleet), the first call captured."""
    sol, q0s, v0s = problems.fleet(p.solver, p.grid, p.q0, p.v0, B)
    seen = []

    def make(kern):
        def grab(*a):
            seen.append(a)
            return kern(*a)

        grab.launches = 0   # the wrapper counts on the name it is under
        return grab

    with _swapped("K5", make):
        p.solver.update(p.grid, q0s, v0s, sol)
    return seen[0]


def c2_reading(dev):
    """Open check C2, printed, not gated: K5's switching branch in float32
    against bwd_plain on the LQR inputs of the trot's and the walk's own
    fleet updates: each output's max abs error over its max-abs; beside
    it, the float32 kernel's and the float32 plain version's distance
    from bwd_plain in float64 on the same inputs, the same way."""
    names = ("K", "k", "P", "p", "Mx", "mx")

    def rel(a, b):
        return {n: float((x - y).abs().max()) / max(float(y.abs().max()),
                                                     1e-30)
                for n, x, y in zip(names, a, b) if y is not None}

    out = {}
    for tag, make in (("trot", problems.anymal_trot), ("walk", walk_problem)):
        args = lqr_of_update(make(dtype=torch.float32, device=dev))
        got, want = bs.bwd(*args), bs.bwd_plain(*args)
        ref = bs.bwd_plain(*[None if a is None else a.double()
                             for a in args])
        out[tag] = {"kernel vs plain": rel(got, want),
                    "kernel vs f64": rel(got, ref),
                    "plain vs f64": rel(want, ref)}
        print(f"  C2 {tag}: K5 switching, f32, the update's LQR inputs "
              f"{tuple(args[0].shape[:2])}; max abs error / max-abs: "
              + "; ".join(f"{k}: " + ", ".join(f"{n} {r:.1e}"
                                              for n, r in v.items())
                          for k, v in out[tag].items()))
    return out


def phase_kernels(dev):
    """Every kernel against its plain version; times at float32, the main
    paths' type, at the trot's and the walk's shapes. Returns the
    per-kernel records (launches filled later)."""
    p64, sol64, grid64 = trot_inputs(dev)
    pre64 = OS.stage_pre_all(p64.model, p64.mpc.contacts, p64.mpc.limits,
                             1e-3, p64.costs, sol64, grid64,
                             n_imp=p64.mpc.n_reserved, use_chain=False)
    x64 = {k: pre64[k].contiguous() for k in cd.IN_NAMES}
    ps = problems.anymal_standing(N=N, dtype=torch.float64, device=dev)
    _, (sol_s, q_s, v_s) = standing_fleet(ps, B)
    sol_s, grid_s, _, _, _ = OS._fleet(perturbed(ps.model, sol_s), ps.grid,
                                       q_s, v_s)
    pw, solw, gridw = trot_inputs(dev, make=walk_problem)
    prew = OS.stage_pre_all(pw.model, pw.mpc.contacts, pw.mpc.limits, 1e-3,
                            pw.costs, solw, gridw, n_imp=pw.mpc.n_reserved,
                            use_chain=False)
    xw64 = {k: prew[k].contiguous() for k in cd.IN_NAMES}
    xw = [xw64[k] for k in ("dgdq", "dgdf", "d_cone")]
    # the A1 crawl's stage slots (K6 without the cost fold, the task rows
    # feeding the stack) and the flying trot's condense inputs (flight
    # slots: every contact row of K1 inactive, every cone row of Kc masked)
    pc, solc, gridc = trot_inputs(dev, make=crawl_problem)
    pf, solf, gridf = trot_inputs(dev, make=gait_problem("flying_trot"))
    pref = OS.stage_pre_all(pf.model, pf.mpc.contacts, pf.mpc.limits, 1e-3,
                            pf.costs, solf, gridf, n_imp=pf.mpc.n_reserved,
                            use_chain=False)
    xf64 = {k: pref[k].contiguous() for k in cd.IN_NAMES}
    # the walk's wrench cones act on the local wrench, so its dgdq rows
    # are zero; seeded dense rows at the same shapes reach every block of
    # the 34-row Kc
    rng = np.random.default_rng(5)
    xr = [torch.as_tensor(rng.standard_normal(tuple(t.shape)),
                          dtype=torch.float64, device=dev) for t in xw]
    xr[2] = xr[2].exp()
    Nt = grid64.dt.shape[1]
    recs = {}
    # K6's cases, (model, contacts, args, cost) in float64: point contacts
    # without the cost fold (standing) and with it (trot); surface contacts
    # without it (the biped standing stack) and with it (walk), both on the
    # walk fleet's stage slots; the full iCub's nv 35 tree on seeded stages
    # (no path runs it; absent from packages without it)
    k6_cases = {
        "point": (ps.model, ps.contacts) + chain_args(
            ps.model, ps.contacts, (ps.cost,), sol_s, grid_s, False),
        "point fold": (p64.model, p64.mpc.contacts) + chain_args(
            p64.model, p64.mpc.contacts, p64.costs, sol64, grid64, True),
        "surface": (pw.model, pw.mpc.contacts) + chain_args(
            pw.model, pw.mpc.contacts, pw.costs, solw, gridw, False),
        "surface fold": (pw.model, pw.mpc.contacts) + chain_args(
            pw.model, pw.mpc.contacts, pw.costs, solw, gridw, True)}
    if hasattr(problems, "icub_soles"):
        m35, c35 = problems.icub_soles(device=dev)
        for key, wc in (("nv35", False), ("nv35 fold", True)):
            k6_cases[key] = (m35, c35) + tuple(problems.chain_stages(
                m35, c35, K6_NV35_STAGES, seed=6, with_cost=wc))
    # the A1 tree (K6's four-feet instance): the crawl fleet's stage slots
    # without the fold (its path, timed) and seeded stages without and with
    # it (compared only); absent from packages without the A1
    if hasattr(problems, "a1_crawl"):
        ca = pc.mpc.contacts
        k6_cases["a1"] = (pc.model, ca) + chain_args(
            pc.model, ca, pc.costs, solc, gridc, False)
        for key, wc in (("a1 seeded", False), ("a1 seeded fold", True)):
            k6_cases[key] = (pc.model, ca) + tuple(problems.chain_stages(
                pc.model, ca, K6_A1_STAGES, seed=7, with_cost=wc))
    # K6's operation counts, on the host beside the card's work: (value,
    # tangent) operations over all stages
    kernels.host_library("chain_flops")
    pool = ThreadPoolExecutor(6)
    k6_ops = {key: _op_counts(pool, mo, cts, args, cost)
              for key, (mo, cts, args, cost) in k6_cases.items()
              if key in K6_RECORDS}
    pool.shutdown(wait=False)
    for dtype in (torch.float64, torch.float32):
        x = {k: v.to(dtype) for k, v in x64.items()}
        k1_in, k2_in = _k12_inputs(x)
        p1 = cd.k1_plain(*k1_in)
        e1 = _compare("K1", cd.k1(*k1_in), p1, dtype)
        kc_in = [x["dgdq"], x["dgdf"], x["d_cone"]]
        pc = cd.kc_plain(*kc_in)
        ec = _compare("Kc", cd.kc(*kc_in), pc, dtype)
        kcw_in = [t.to(dtype) for t in xw]
        ecw = _compare("Kc 34", cd.kc(*kcw_in), cd.kc_plain(*kcw_in), dtype)
        kcr_in = [t.to(dtype) for t in xr]
        _compare("Kc 34 seed", cd.kc(*kcr_in), cd.kc_plain(*kcr_in), dtype)
        p2 = cd.k2_plain(*k2_in)
        e2 = _compare("K2", cd.k2(*k2_in), p2, dtype)
        # K1 and K2 on the walk's own condense inputs (3584 stage slots)
        xwd = {k: v.to(dtype) for k, v in xw64.items()}
        k1w_in, k2w_in = _k12_inputs(xwd)
        p1w, p2w = cd.k1_plain(*k1w_in), cd.k2_plain(*k2w_in)
        e1w = _compare("K1 walk", cd.k1(*k1w_in), p1w, dtype)
        e2w = _compare("K2 walk", cd.k2(*k2w_in), p2w, dtype)
        # K1 and Kc on the flying trot's condense inputs (flight slots)
        xf = {k: v.to(dtype) for k, v in xf64.items()}
        k1f_in = [xf[n] for n in ("M", "J", "inactive", "Tw1", "Tw2", "r1",
                                  "e2")]
        e1f = _compare("K1 flying trot", cd.k1(*k1f_in),
                       cd.k1_plain(*k1f_in), dtype)
        kcf_in = [xf["dgdq"], xf["dgdf"], xf["d_cone"]]
        ecf = _compare("Kc flying trot", cd.kc(*kcf_in),
                       cd.kc_plain(*kcf_in), dtype)
        k3_in, k3w_in = ([q1[3], q1[4], q2[3].contiguous()] + [
            xx[n] for n in ("Aqq", "Aqv", "xres_q", "Fv_res", "sA", "lam2",
                            "lmdgmm")]
            for q1, q2, xx in ((p1, p2, x), (p1w, p2w, xwd)))
        e3 = _compare("K3", cd.k3(*k3_in), cd.k3_plain(*k3_in), dtype)
        # K3 on the walk's own condense inputs (3584 stage slots)
        e3w = _compare("K3 walk", cd.k3(*k3w_in), cd.k3_plain(*k3w_in),
                       dtype)
        l0 = lqr_inputs(0, dtype, dev, N)
        e50 = _compare("K5 nf=0", bs.bwd(*l0), bs.bwd_plain(*l0), dtype)
        l12 = lqr_inputs(12, dtype, dev, Nt)
        e512 = _compare("K5 nf=12", bs.bwd(*l12), bs.bwd_plain(*l12), dtype)
        k6 = {}
        for key, (mo, cts, args, cost) in k6_cases.items():
            args = [a.to(dtype) for a in args]
            cost = [c.to(dtype).contiguous() for c in cost]
            model = convert.astype(mo, dtype)
            contacts = convert.astype(cts, dtype)
            names = chn._OUTS + (chn._COST_OUTS if cost else ())
            got = chn.chain(model, contacts, *args, *cost)
            want = chn.chain_plain(model, contacts, *args, *cost)
            err = _compare(f"K6 {key}", [got[n] for n in names],
                           [want[n] for n in names], dtype)
            k6[key] = (model, contacts, args, cost, got, err)
        if dtype != torch.float32:
            continue
        S, Sw, Sf = x["M"].shape[0], xw[0].shape[0], xf["M"].shape[0]
        Xf = torch.cat([xf["dgdq"], xf["dgdf"]], dim=-1).contiguous()
        nv, nf_, nu = 18, 12, 12
        w = 2 * nv + nu
        Xc = torch.cat([x["dgdq"], x["dgdf"]], dim=-1).contiguous()
        Xw = torch.cat(kcw_in[:2], dim=-1).contiguous()
        specs = [
            ("K1", "K1 condense_k1", cd.k1, cd.k1_plain, k1_in, e1,
             S * flops_k1(nv, nf_, w), None,
             "robotoc_tpu/ops/pallas_condense.py:331"),
            ("Kc", "Kc condense_kc", cd.kc, cd.kc_plain, kc_in, ec,
             S * flops_kc(nv, nf_, 20),
             lambda: torch.einsum("sr,sri,srj->sij", x["d_cone"], Xc, Xc),
             "robotoc_tpu/ops/pallas_condense.py:348"),
            ("Kc34", "Kc condense_kc 34 rows", cd.kc, cd.kc_plain, kcw_in,
             ecw, Sw * flops_kc(nv, nf_, 34),
             lambda: torch.einsum("sr,sri,srj->sij", kcw_in[2], Xw, Xw),
             "robotoc_tpu/ops/pallas_condense.py:348"),
            ("K2", "K2 condense_k2", cd.k2, cd.k2_plain, k2_in, e2,
             S * flops_k2(nv, nu, nf_), None,
             "robotoc_tpu/ops/pallas_condense.py:377"),
            ("K1w", "K1 condense_k1 walk", cd.k1, cd.k1_plain, k1w_in, e1w,
             Sw * flops_k1(nv, nf_, w), None,
             "robotoc_tpu/ops/pallas_condense.py:331"),
            ("K2w", "K2 condense_k2 walk", cd.k2, cd.k2_plain, k2w_in, e2w,
             Sw * flops_k2(nv, nu, nf_), None,
             "robotoc_tpu/ops/pallas_condense.py:377"),
            ("K3", "K3 condense_k3", cd.k3, cd.k3_plain, k3_in, e3,
             S * flops_k3(nv, nu), None,
             "robotoc_tpu/ops/pallas_condense.py:399"),
            ("K3w", "K3 condense_k3 walk", cd.k3, cd.k3_plain, k3w_in, e3w,
             Sw * flops_k3(nv, nu), None,
             "robotoc_tpu/ops/pallas_condense.py:399"),
            ("K1ft", "K1 condense_k1 flying trot", cd.k1, cd.k1_plain,
             k1f_in, e1f, Sf * flops_k1(nv, nf_, w), None,
             "robotoc_tpu/ops/pallas_condense.py:331"),
            ("Kcft", "Kc condense_kc flying trot", cd.kc, cd.kc_plain,
             kcf_in, ecf, Sf * flops_kc(nv, nf_, 20),
             lambda: torch.einsum("sr,sri,srj->sij", xf["d_cone"], Xf, Xf),
             "robotoc_tpu/ops/pallas_condense.py:348"),
        ]
        for key, name, kern, plain, args, err, flops, lib, repl in specs:
            outs = kern(*args)
            # K3 reads only rows 0 .. nv - 1 of G and c0
            read = ([args[0][:, :nv], args[1][:, :nv]] + list(args[2:])
                    if kern is cd.k3 else args)
            recs[key] = _record(
                name, "robotoc_tpu_torch/csrc/condense.cu", repl, err,
                lambda: kern(*args), lambda: plain(*args),
                bound(nbytes(*read) + nbytes(*outs), flops, dtype), lib)
        # K5: the main path's switching branch at the trot shapes; the
        # nf = 0 branch (standing path) beside it
        for nf, l_in, err, Nh in ((12, l12, e512, Nt), (0, l0, e50, N)):
            outs = bs.bwd(*l_in)
            recs["K5" if nf else "K5 nf0"] = _record(
                "K5 riccati_bwd" + ("" if nf else " nf=0"),
                "robotoc_tpu_torch/csrc/riccati_bwd.cu",
                "robotoc_tpu/riccati/pallas_scan.py:146", err,
                lambda: bs.bwd(*l_in), lambda: bs.bwd_plain(*l_in),
                bound(nbytes(*l_in) + nbytes(*outs),
                      B * Nh * flops_k5_step(36, 12, nf), dtype))
        for key, (model, contacts, args, cost, got, err) in k6.items():
            if key not in K6_RECORDS:
                continue
            n_val, n_tan = k6_ops[key]()
            print(f"  K6 {key}: {args[0].shape[0]} stages, {n_val} value + "
                  f"{n_tan} tangent operations (csrc/chain_flops.cpp)")
            # R_ref (the last input) is read only by the surface branch
            read = (args if chn.contact_type(contacts) == ct.SURFACE
                    else args[:-1])
            recs[K6_RECORDS[key][0]] = _record(
                K6_RECORDS[key][1], "robotoc_tpu_torch/csrc/" + (
                    "chain_icub.cu" if key.startswith("nv35") else "chain.cu"),
                "robotoc_tpu/ops/pallas_chain.py:1110", err,
                lambda: chn.chain(model, contacts, *args, *cost),
                lambda: chn.chain_plain(model, contacts, *args, *cost),
                bound(nbytes(*read, *cost) + nbytes(*got.values()),
                      n_val + n_tan, dtype))
    for r in recs.values():
        print(f"  {r['name']:30s} {r['ms']:.4f} ms (a call {r['call_ms']:.4f})"
              f"  plain (a call) {r['plain_ms']:.3f}"
              f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              f"  library {r['library_ms']}")
    return recs


COUNTERS = {"K1": cd.k1, "Kc": cd.kc, "K2": cd.k2, "K3": cd.k3,
            "K5": bs.bwd, "K6": chn.chain}


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in COUNTERS.items()}


def _mpc_step(solver, grid, sol, q0s, v0s):
    kkts = []
    for _ in range(2):
        sol, kkt, _, _ = solver.update(grid, q0s, v0s, sol)
        kkts.append(kkt)
    return sol, kkts


def _agree(tag, sol0, out_k, out_p):
    """Kernels vs plain versions after one MPC step: KKT to 1e-3
    relative; each field to 1e-2 of the largest change the plain step
    made to it (float32 rounding through a stiff problem's Newton
    directions). Returns the gates missed, (KKT, fields); both empty when
    all hold."""
    (sol_k, kkt_k), (sol_p, kkt_p) = out_k, out_p
    kkt_fails, fails = [], []
    for i, (a, b) in enumerate(zip(kkt_k, kkt_p)):
        rel = float(((a - b).abs() / b.abs()).max())
        if not rel <= 1e-3:
            kkt_fails.append(f"update {i}: KKT kernel vs plain rel "
                             f"{rel:.2e}")
    worst = {}
    for name in FIELDS:
        xk, xp = getattr(sol_k, name), getattr(sol_p, name)
        step = float((xp - getattr(sol0, name)).abs().max())
        err = float((xk - xp).abs().max())
        worst[name] = err / max(step, 1e-30)
        if not err <= 1e-2 * step + 1e-6:
            fails.append(f"{name}: kernel vs plain {err:.3e} > 1e-2 x step "
                         f"{step:.3e}")
    print(f"  {tag}: kernel vs plain, error / step: "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    return kkt_fails, fails


def _worst(out_a, out_b):
    """Two MPC steps' (sol, kkts) apart: each KKT's largest relative
    difference, and each field's largest difference over its largest
    magnitude in out_b."""
    (sol_a, kkt_a), (sol_b, kkt_b) = out_a, out_b
    worst = {f"kkt{i}": float(((a - b).abs() / b.abs()).max())
             for i, (a, b) in enumerate(zip(kkt_a, kkt_b))}
    for name in FIELDS:
        xa, xb = getattr(sol_a, name), getattr(sol_b, name)
        worst[name] = float((xa - xb).abs().max()) / max(
            float(xb.abs().max()), 1e-30)
    return worst


def _agree_f64(tag, mk, grid, sol0, q0s, v0s, tol=1e-8, strict=True):
    """One MPC step through the kernels against the plain versions in
    float64: the KKT and every field to tol relative to the field's
    largest magnitude (raises past it when strict). Returns the worst
    ratios and the plain step."""
    out_k, out_p = (_mpc_step(mk(k), grid, sol0, q0s, v0s)
                    for k in (True, False))
    worst = _worst(out_k, out_p)
    print(f"  {tag} float64: kernel vs plain, error / max-abs: "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    check(not strict or all(v <= tol for v in worst.values()),
          f"{tag} float64: kernel vs plain past {tol:.0e}: {worst}")
    return worst, out_p[0]


def _jittered(sol, rel=1e-6, seed=7):
    """`sol` with every field but q scaled by 1 + rel N(0, 1) (seeded): a
    few float32 ulps, the size of the kernels' own rounding."""
    rng = np.random.default_rng(seed)

    def jit(x):
        return x * (1 + rel * torch.as_tensor(
            rng.standard_normal(tuple(x.shape)), dtype=x.dtype,
            device=x.device))

    return sol.replace(**{n: jit(getattr(sol, n)) for n in FIELDS
                          if n != "q"})


def on_sphere(model, sol):
    """`sol` with its base quaternion scaled to unit length: a point of
    the configuration manifold. A float64 copy of a float32 iterate sits
    off the unit sphere by float32 rounding (about 3e-8), where K6 and its
    plain version differentiate in q differently (K6 seeds a base tangent
    with R(q) hat(e), the plain version's jacfwd through q (+) e gives
    |q|^2 R(q / |q|) hat(e): their q derivatives differ by a relative
    |q|^2 - 1)."""
    if not model.floating_base:
        return sol
    q = sol.q.clone()
    q[..., 3:7] = q[..., 3:7] / q[..., 3:7].norm(dim=-1, keepdim=True)
    return sol.replace(q=q)


def _drift(name, sol, sol0, sol_64):
    """Field `name` of `sol` against the float64 step `sol_64` from sol0,
    relative to the largest change that step made to it."""
    ref = getattr(sol_64, name)
    step = max(float((ref - getattr(sol0, name)).abs().max()), 1e-30)
    return float((getattr(sol, name).double() - ref).abs().max()) / step


# where the solver looks each kernel up, and its plain version
KERNEL_SITES = {"K1": (cd, "k1", cd.k1_plain), "Kc": (cd, "kc", cd.kc_plain),
                "K2": (cd, "k2", cd.k2_plain), "K3": (cd, "k3", cd.k3_plain),
                "K5": (bs, "bwd", bs.bwd_plain),
                "K6": (chn, "chain", chn.chain_plain)}


@contextlib.contextmanager
def _swapped(key, make):
    """Kernel `key` replaced, where the solver looks it up, by
    make(kernel) while the block runs."""
    mod, name, _ = KERNEL_SITES[key]
    kern = getattr(mod, name)
    setattr(mod, name, make(kern))
    try:
        yield
    finally:
        setattr(mod, name, kern)


def fault(kind, eps=PLANT_EPS, seed=0):
    """A float32 fault to plant in a kernel: make(kernel) returns the
    kernel with every floating output entry x replaced by x (1 + eps
    N(0, 1)) ("noise", a seeded generator on the outputs' device, a new
    draw each call) or by x rounded through torch.bfloat16 ("bf16")."""
    gens = {}

    def spoil(x):
        if isinstance(x, dict):
            return {k: spoil(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(spoil(v) for v in x)
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        if kind == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        if x.device not in gens:
            gens[x.device] = torch.Generator(x.device).manual_seed(seed)
        return x * (1 + eps * torch.randn(x.shape, generator=gens[x.device],
                                          dtype=x.dtype, device=x.device))

    def make(kern):
        def planted(*a, **kw):
            return spoil(kern(*a, **kw))

        planted.launches = 0   # the wrapper counts on the name it is under
        return planted

    return make


def drift_rows(sol0, steps, sol_64):
    """{field: {step: drift}} of float32 steps from the plain float64 step
    from the same iterate (`_drift`). `steps` holds the kernel step
    ("kernel") and plain float32 steps (every other key)."""
    return {n: {k: _drift(n, s, sol0, sol_64) for k, s in steps.items()}
            for n in FIELDS}


def drift_ratios(rows):
    """{field: the kernel step's drift / the largest plain step's}."""
    return {n: r["kernel"] / max(max(v for k, v in r.items()
                                     if k != "kernel"), 1e-300)
            for n, r in rows.items()}


def over_gate(rows, factor):
    """{field: drift ratio / factor} for the fields past the drift gate
    (a drift ratio above factor)."""
    return {n: v / factor for n, v in drift_ratios(rows).items()
            if v > factor}


def _f32_drift(tag, sol0, steps, sol_64, factor=10.0, strict=True):
    """float32 steps against the plain float64 step from the same iterate,
    each field relative to the largest change the float64 step made.
    `steps` holds the kernel step ("kernel") and plain steps (every other
    key: the plain step, "plain", and plain steps from iterates jittered
    by `_jittered`): the plain ones show how far float32 rounding alone
    moves the step. A kernel step that drifts past `factor` times the
    largest of them is a fault in a kernel's float32 arithmetic: raises
    (with strict False, returns it). Returns ({field: {step: drift}},
    {field past the gate: ratio to it})."""
    rows = drift_rows(sol0, steps, sol_64)
    print(f"  {tag} float32 drift from the float64 step / its change ("
          + ", ".join(steps) + "): "
          + ", ".join(f"{n} " + " ".join(f"{v:.1e}" for v in r.values())
                      for n, r in rows.items()))
    bad = over_gate(rows, factor)
    check(not (strict and bad), f"{tag}: the float32 kernel step drifts "
          f"past {factor} x the plain float32 steps' drift: {bad}")
    return rows, bad


def _run_path(tag, mk, grid, sol0, q0s, v0s, strict=True,
              strict_kkt=None, reps=None, expect=None, profile=True):
    """Drive one path: warm-up, counts reset, one MPC step through the
    kernels, counts read; the same step on the plain versions; timings.
    The float32 agreement (`_agree`) gates the KKT when strict_kkt (None:
    as strict) and the fields when strict; a gate not held is returned in
    the result ("f32_gates_missed") for the caller to settle. Returns the
    launch counts, the result and the two steps' (sol, kkts). The kernel
    step is timed on the path run (after its warm-up), with `reps` on the
    median of that many more (host_ms) instead; the plain step on the run
    compared (the warm-up has run the same glue). `expect`: each kernel's
    launches in the step (2 of each when None). With `profile`, one
    update's device ms and the idle share from a profiler trace (else "not
    measured": a trace of a host-bound update costs tens of seconds)."""
    strict_kkt = strict if strict_kkt is None else strict_kkt
    s_kern, s_plain = mk(True), mk(False)
    _mpc_step(s_kern, grid, sol0, q0s, v0s)            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t_path = time.perf_counter()
    out_k = _mpc_step(s_kern, grid, sol0, q0s, v0s)    # the path
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_path) * 1e3
    launches = read_counts()
    print(f"  {tag}: launches in one MPC step (2 updates): {launches}")
    expect = expect or {k: 2 for k in launches}
    check(launches == expect, f"{tag}: launches {launches}, expected "
          f"{expect}")
    for i, kkt in enumerate(out_k[1]):
        check(bool(torch.isfinite(kkt).all()), f"{tag} update {i}: KKT not "
              "finite")
    t_plain = time.perf_counter()
    out_p = _mpc_step(s_plain, grid, sol0, q0s, v0s)
    torch.cuda.synchronize()
    step_plain_ms = (time.perf_counter() - t_plain) * 1e3
    kkt_fails, field_fails = _agree(tag, sol0, out_k, out_p)
    check(not (strict_kkt and kkt_fails), f"{tag}: " + "; ".join(kkt_fails))
    check(not (strict and field_fails), f"{tag}: " + "; ".join(field_fails))
    fails = kkt_fails + field_fails
    print(f"  {tag}: fleet KKT after the step: max "
          f"{float(out_k[1][-1].max()):.4e}")
    if reps:
        step_ms = host_ms(lambda: _mpc_step(s_kern, grid, sol0, q0s, v0s),
                          reps=reps)
    dev_ms, top = (device_time(lambda: s_kern.update(grid, q0s, v0s, sol0))
                   if profile else (None, {}))
    out = dict(B=B, N=s_kern.N, dtype="float32", ms_per_mpc_step=step_ms,
               mpc_updates_per_s=B / (step_ms * 1e-3),
               plain_ms_per_mpc_step=step_plain_ms,
               device_ms_per_update=dev_ms,
               device_idle_share=(None if dev_ms is None
                                  else 1.0 - dev_ms / (step_ms / 2)),
               profiled=profile,
               top_device_kernels_ms=top,
               fleet_max_kkt=float(out_k[1][-1].max()),
               f32_gates_missed=fails)
    print(f"  {tag}: ms per MPC step (2 updates, B={B}): {step_ms:.2f} with "
          f"the kernels, {step_plain_ms:.2f} with the plain versions; "
          f"{out['mpc_updates_per_s']:.1f} MPC updates/s")
    print(f"  {tag}: device time per update {dev_ms} ms (profiler), idle "
          f"share {out['device_idle_share']}; top kernels {top}")
    print(f"{tag}: " + json.dumps(out))
    return launches, out, (out_k, out_p)


def phase_slice(dev):
    """The standing path at full width (K6 without the cost fold)."""
    p = problems.anymal_standing(N=N, dtype=torch.float32, device=dev)
    _, (sol0, q0s, v0s) = standing_fleet(p, B)
    costs = (p.cost,)
    mk = lambda k: OS.OCPSolver(   # noqa: E731
        p.model, p.contacts, costs, p.limits, T=p.T, N=p.N,
        options=OS.SolverOptions(use_kernels=k))
    return _run_path("slice", mk, p.grid, sol0, q0s, v0s, profile=False)


def trot_fleet(dtype, dev, seed=0, n=N, b=B, make=problems.anymal_trot):
    """The trot fleet in `dtype` (horizon n, default N): b scenarios (B)
    whose initial configurations `problems.fleet` moves with numpy seed
    `seed`. Returns the problem, mk(use_kernels, search=False) -> the
    fleet's solver (search: its enable_line_search), and (sol0, q0s,
    v0s). `make` builds another gait problem the same way (the pace, the
    flying trot)."""
    p = make(N=n, dtype=dtype, device=dev)
    mpc = p.mpc

    def mk(k, search=False):
        return OS.OCPSolver(p.model, mpc.contacts, p.costs, mpc.limits,
                            T=p.T, N=p.N, n_reserved_events=mpc.n_reserved,
                            options=OS.SolverOptions(
                                switching_constraints=True, use_kernels=k,
                                enable_line_search=search))

    return p, mk, problems.fleet(p.solver, p.grid, p.q0, p.v0, b, seed=seed)


def plain_steps(mk, grid, sol0, q0s, v0s, sol_p):
    """The plain float32 step `sol_p` from sol0 and the plain steps from
    sol0 jittered (`_jittered`) with each of JITTER_SEEDS."""
    steps = {"plain": sol_p}
    for s in JITTER_SEEDS:
        steps[f"plain jittered {s}"] = _mpc_step(
            mk(False), grid, _jittered(sol0, seed=s), q0s, v0s)[0]
    return steps


def trot_gate(tag, f32, f64, out_k, out_p, factor=TROT_K, strict=True):
    """The trot's gates on one iterate, f32 = (mk, grid, sol0, q0s, v0s) of
    the float32 fleet and f64 the same of the float64 fleet built like it:
    one MPC step through the kernels against the plain versions in float64
    to 1e-8 of each field's max-abs (`_agree_f64`), then each field's drift
    of the float32 kernel step `out_k` from the plain float64 step within
    `factor` times the largest drift among the plain float32 step `out_p`
    and the plain steps from two jittered iterates (`_f32_drift`). Raises
    when strict. Returns the float64 agreement, the plain float32 steps,
    the plain float64 step, the drift rows and the fields past the drift
    gate."""
    mk, grid, sol0, q0s, v0s = f32
    worst64, sol_p64 = _agree_f64(tag, *f64, strict=strict)
    plain = plain_steps(mk, grid, sol0, q0s, v0s, out_p[0])
    rows, bad = _f32_drift(tag, f64[2], {"kernel": out_k[0], **plain},
                           sol_p64, factor=factor, strict=strict)
    ratios = drift_ratios(rows)
    print(f"  {tag} float32 drift / the plain steps' largest (gate "
          f"{factor:g}): " + ", ".join(f"{n} {v:.2f}"
                                       for n, v in ratios.items()))
    return dict(f64_agreement=worst64, plain=plain, sol_p64=sol_p64,
                f32_drift=rows, drift_ratio=ratios, over_gate=bad)


def plant_test(tag, f32, out_p, gate, sol64, factor=TROT_K, cases=None,
               strict=True):
    """The drift gate's power: one fault (`fault`) at a time in one
    kernel's outputs where the solver looks it up, for each of the six
    kernels: relative noise PLANT_EPS and bfloat16 rounding, each judged by
    the old agreement (`_agree`, KKT and fields) and by the drift gate
    (`over_gate` at `factor`, against the plain steps of `gate`); then the
    noise at PLANT_EPS_SHOWN, printed only (`cases`, (kernel, kind, eps,
    gated) tuples, replaces that list). Raises (when strict) if the drift
    gate passes a gated plant that the old agreement refuses. Returns a
    record per plant."""
    mk, grid, sol0, q0s, v0s = f32
    if cases is None:
        cases = [(key, kind, PLANT_EPS, True) for key in KERNEL_SITES
                 for kind in ("noise", "bf16")]
        cases += [(key, "noise", eps, False) for eps in PLANT_EPS_SHOWN
                  for key in KERNEL_SITES]
    recs, missed = [], []
    for key, kind, eps, gated in cases:
        name = f"{key} {kind}" + (f" {eps:.0e}" if kind == "noise" else "")
        with _swapped(key, fault(kind, eps)):
            out_f = _mpc_step(mk(True), grid, sol0, q0s, v0s)
        kkt_f, fld_f = _agree(f"{tag} plant {name}", sol0, out_f, out_p)
        rows = drift_rows(sol64, {"kernel": out_f[0], **gate["plain"]},
                          gate["sol_p64"])
        ratio = drift_ratios(rows)
        top = max(ratio, key=ratio.get)
        drift_refuses = bool(over_gate(rows, factor))
        # the new gate: the drift gate and the KKT gate the old one shares
        rec = dict(plant=name, gated=gated, old_refuses=bool(kkt_f or fld_f),
                   old_kkt_refuses=bool(kkt_f), drift_refuses=drift_refuses,
                   new_refuses=drift_refuses or bool(kkt_f),
                   max_drift_ratio=ratio[top], field=top)
        recs.append(rec)
        print(f"  {tag} plant {name}: old agreement "
              f"{'refuses' if rec['old_refuses'] else 'passes'}"
              f"{' (KKT)' if kkt_f else ''}; drift gate "
              f"{'refuses' if rec['drift_refuses'] else 'passes'}, largest "
              f"drift / plain {ratio[top]:.3g} ({top}); with the KKT "
              f"{'refuses' if rec['new_refuses'] else 'passes'}"
              + ("" if gated else " [shown, not gated]"))
        if gated and rec["old_refuses"] and not rec["drift_refuses"]:
            missed.append(name)
    check(not (strict and missed), f"{tag}: the drift gate passes plants "
          f"the old agreement refuses: {missed}")
    return recs


def phase_trot(dev):
    """The main path: the trot MPC update at full width, float32, gated
    against the float64 fleet and self-tested on planted faults; then the
    float64 convergence run of one unperturbed scenario."""
    f32_, f64_ = torch.float32, torch.float64
    p, mk, (sol0, q0s, v0s) = trot_fleet(f32_, dev)
    # the float32 agreement with the plain step is printed; its KKT gated
    launches, out, (out_k, out_p) = _run_path(
        "trot", mk, p.grid, sol0, q0s, v0s, strict=False, strict_kkt=True)
    p64, mk64, (sol64, q64, v64) = trot_fleet(f64_, dev)
    f32 = (mk, p.grid, sol0, q0s, v0s)
    gate = trot_gate("trot", f32, (mk64, p64.grid, sol64, q64, v64), out_k,
                     out_p)
    # the float64 gate one step in: from the plain float64 step rounded to
    # float32, its base quaternion back on the unit sphere (`on_sphere`)
    sol64_1 = on_sphere(p64.model, gate["sol_p64"].map(
        lambda x: x.to(f32_).to(f64_)))
    out.update(f64_agreement=gate["f64_agreement"],
               f64_agreement_iterate_1=_agree_f64(
                   "trot iterate 1", mk64, p64.grid, sol64_1, q64, v64)[0],
               f32_drift=gate["f32_drift"], drift_ratio=gate["drift_ratio"],
               drift_factor=TROT_K)
    # the gated plants; the noise plants only printed (PLANT_EPS_SHOWN)
    # are read by the "readings" phase
    out["plants"] = plant_test("trot", f32, out_p, gate, sol64, cases=[
        (key, kind, PLANT_EPS, True) for key in KERNEL_SITES
        for kind in ("noise", "bf16")])
    # float64, one unperturbed scenario, 15 updates through the kernels
    sol = p64.solver.init_solution(p64.grid, p64.q0, p64.v0)
    before = read_counts()
    kkts = []
    for _ in range(15):
        sol, kkt, _, _ = p64.solver.update(p64.grid, p64.q0, p64.v0, sol)
        kkts.append(float(kkt))
    after = read_counts()
    check(all(after[k] - before[k] == 15 for k in after),
          f"trot f64 run bypassed a kernel: {before} -> {after}")
    print("  trot f64, one scenario, KKT by update: "
          + ", ".join(f"{k:.3e}" for k in kkts))
    check(kkts[-1] < 1e-3, f"trot f64: KKT {kkts[-1]:.3e} >= 1e-3 after 15 "
          "updates")
    out["f64_kkt_after_15"] = kkts[-1]
    print("trot gate: " + json.dumps({k: out[k] for k in (
        "f64_agreement", "f64_agreement_iterate_1", "drift_ratio",
        "drift_factor", "plants")}))
    return launches, out


def f64_sources(tag, mk, grid, sol0, q0s, v0s):
    """Where a float64 difference between the kernel step and the plain
    step from sol0 comes from: the plain step from sol0 jittered by 1e-12
    (`_jittered`; the step's own sensitivity) against the plain step, and
    the kernel step with each kernel in turn swapped for its plain version
    against the plain step. Returns {case: `_worst`}."""
    ref = _mpc_step(mk(False), grid, sol0, q0s, v0s)
    out = {"plain jittered 1e-12": _worst(_mpc_step(
        mk(False), grid, _jittered(sol0, rel=1e-12), q0s, v0s), ref)}
    for key, (_, _, plain) in KERNEL_SITES.items():
        with _swapped(key, lambda kern: plain):
            out[f"{key} plain"] = _worst(
                _mpc_step(mk(True), grid, sol0, q0s, v0s), ref)
    for case, w in out.items():
        print(f"  {tag} float64 {case} vs plain, error / max-abs: "
              + ", ".join(f"{k} {v:.1e}" for k, v in w.items()))
    return out


def phase_readings(dev, seeds=(0, 1, 2)):
    """The trot's gates (`trot_gate`, not raising) on the fleets of three
    perturbation seeds, each at its initial iterate and at the iterate one
    plain float64 MPC step later, rounded to float32 (the float64 fleet
    starts from it with its base quaternion back on the unit sphere,
    `on_sphere`), with the twelve gated plants (`plant_test`) on every
    reading and the printed ones on the first, one JSON line per reading.
    At the later iterate also the float64 agreement from the rounded
    iterate off the unit sphere with its sources (`f64_sources`), and from
    the float64 fleet's own, unrounded iterate. Ends with a summary line.
    Not among the default phases. Also the K5 reading of closed check C2
    (`c2_reading`)."""
    c2_reading(dev)
    f32_, f64_ = torch.float32, torch.float64
    gated = [(key, kind, PLANT_EPS, True) for key in KERNEL_SITES
             for kind in ("noise", "bf16")]
    out = []
    for seed in seeds:
        p, mk, (sol0, q0s, v0s) = trot_fleet(f32_, dev, seed)
        p64, mk64, (sol64, q64, v64) = trot_fleet(f64_, dev, seed)
        for it in (0, 1):
            tag = f"readings seed {seed} iterate {it}"
            out_k = _mpc_step(mk(True), p.grid, sol0, q0s, v0s)
            out_p = _mpc_step(mk(False), p.grid, sol0, q0s, v0s)
            kkt_f, fld_f = _agree(tag, sol0, out_k, out_p)
            f32 = (mk, p.grid, sol0, q0s, v0s)
            gate = trot_gate(tag, f32, (mk64, p64.grid, sol64, q64, v64),
                             out_k, out_p, strict=False)
            rec = dict(seed=seed, iterate=it, old_kkt_fails=kkt_f,
                       old_field_fails=fld_f,
                       f64_agreement=gate["f64_agreement"],
                       drift_ratio=gate["drift_ratio"],
                       over_gate=gate["over_gate"])
            rec["plants"] = plant_test(tag, f32, out_p, gate, sol64,
                                       cases=None if not out else gated,
                                       strict=False)
            if it == 1:
                rec["f64_agreement_off_sphere"] = _agree_f64(
                    tag + " off the unit sphere", mk64, p64.grid, off64,
                    q64, v64, strict=False)[0]
                rec["f64_sources_off_sphere"] = f64_sources(
                    tag + " off the unit sphere", mk64, p64.grid, off64,
                    q64, v64)
                # the float64 fleet's own iterate, not rounded to float32
                rec["f64_agreement_unrounded"] = _agree_f64(
                    tag + " unrounded", mk64, p64.grid, prev, q64, v64,
                    strict=False)[0]
            print("reading: " + json.dumps(rec), flush=True)
            out.append(rec)
            prev = gate["sol_p64"]
            sol0 = prev.map(lambda x: x.to(f32_))
            off64 = sol0.map(lambda x: x.to(f64_))
            sol64 = on_sphere(p64.model, off64)
    plants = [r for rec in out for r in rec.get("plants", []) if r["gated"]]
    summary = dict(
        readings=len(out),
        largest_drift_ratio=max(max(r["drift_ratio"].values()) for r in out),
        largest_f64_agreement=max(max(r["f64_agreement"].values())
                                  for r in out),
        plants_judged=len(plants),
        plants_old_refuses=sum(r["old_refuses"] for r in plants),
        plants_drift_refuses=sum(r["drift_refuses"] for r in plants),
        plants_missed=[r["plant"] for r in plants
                       if r["old_refuses"] and not r["drift_refuses"]],
        plants_missed_by_new_gate=[r["plant"] for r in plants
                                   if r["old_refuses"]
                                   and not r["new_refuses"]],
        smallest_plant_ratio={k: min(r["max_drift_ratio"] for r in plants
                                     if r["plant"] == k)
                              for k in dict.fromkeys(r["plant"]
                                                     for r in plants)})
    print("readings summary: " + json.dumps(summary), flush=True)
    return out


def phase_golden(dev):
    ref = np.load(GOLDEN)
    p = problems.anymal_standing(N=N, dtype=torch.float64, device=dev)
    solver = OS.OCPSolver(p.model, p.contacts, (p.cost,), p.limits, T=p.T,
                          N=p.N)
    sol = solver.init_solution(p.grid, p.q0, p.v0)
    before = read_counts()
    for _ in range(16):
        sol, kkt, _, _ = solver.update(p.grid, p.q0, p.v0, sol)
    after = read_counts()
    check(all(after[k] - before[k] == 16 for k in after),
          "golden run bypassed a kernel")
    kkt = float(kkt)
    check(kkt < 1e-6, f"golden: kkt {kkt:.3e} >= 1e-6")
    errs = {}
    for name in ("q", "v", "a", "u", "f"):
        got = getattr(sol, name).cpu().numpy()
        errs[name] = float(np.abs(got - ref[name]).max())
        check(np.allclose(got, ref[name], rtol=1e-6, atol=1e-6),
              f"golden: {name} off by {errs[name]:.3e}")
    print(f"golden: kkt {kkt:.3e} after 16 f64 updates through the "
          f"kernels; max |x - golden| {max(errs.values()):.3e} "
          "(tolerance 1e-6)")


def phase_walk(dev):
    """The iCub lower half on two surface contacts: the standing OCP in
    float64, then the biped-walk MPC warmed in float64 and driven as a
    B-scenario float32 fleet."""
    f64, f32 = torch.float64, torch.float32
    # standing, float64, through the kernels (K6 surface without the cost
    # fold, the 34-row Kc, K5 without switching rows)
    ps = problems.icub_standing(N=4, dtype=f64, device=dev)
    solver = OS.OCPSolver(ps.model, ps.contacts, (ps.cost,), ps.limits,
                          T=ps.T, N=ps.N)
    sol = solver.init_solution(ps.grid, ps.q0, ps.v0)
    reset_counts()
    for _ in range(12):
        sol, _, _, _ = solver.update(ps.grid, ps.q0, ps.v0, sol)
    standing_launches = read_counts()
    check(all(v == 12 for v in standing_launches.values()),
          f"biped standing run bypassed a kernel: {standing_launches}")
    kkt = float(solver.kkt_error(ps.grid, ps.q0, ps.v0, sol))
    print(f"  biped standing: kkt {kkt:.3e} after 12 f64 updates through "
          "the kernels (gate 1e-6)")
    check(kkt < 1e-6, f"biped standing: kkt {kkt:.3e} >= 1e-6")
    # the walk's iterate warmed as the MPC runs, float64, one scenario
    t0 = time.perf_counter()
    p = problems.icub_walk(N=WALK_N, dtype=f64, device=dev)
    t, q, v = problems.warm_start(p, WALK_T, WALK_DT, init_iters=WALK_INIT)
    mpc = p.mpc
    kkt_w = mpc.kkt_error(t, q, v)
    warm_s = time.perf_counter() - t0
    print(f"  walk warm start: t = {t:.3f} s in steps of {WALK_DT} s, kkt "
          f"{kkt_w:.3e}, {warm_s:.1f} s")
    check(np.isfinite(kkt_w), "walk warm start: KKT not finite")
    n_slots = mpc.grid.n_slots
    print(f"  walk grid: {n_slots} slots, {n_slots - 1} stage slots per "
          f"scenario, {B * (n_slots - 1)} for the fleet; impact slots "
          f"{int(mpc.grid.is_impact.sum())}")
    # the fleet: B scenarios whose initial states are moved by
    # 0.0075 N(0, 1) in the tangent space (numpy seed 0)
    def fleet(dtype):
        return warm_fleet(p, q, v, dtype, dev, scale=0.0075)

    _, (_, _, _, grid, _), sol0, q0s, v0s, mk = fleet(f32)
    WALK_FLEET.update(mk=mk, grid=grid, sol0=sol0, q0s=q0s, v0s=v0s)
    launches, out, (out_k, out_p) = _run_path(
        "walk", mk, grid, sol0, q0s, v0s, strict=False, profile=False)
    # kernels against plain versions in float64 on the same fleet; the
    # float32 gate of the trot is reported beside it, and the float32
    # steps' drift from the float64 one is gated
    _, (_, _, _, grid64, _), sol64, q64, v64, mk64 = fleet(f64)
    out["f64_agreement"], sol_p64 = _agree_f64("walk", mk64, grid64, sol64,
                                               q64, v64)
    sol_j = _mpc_step(mk(False), grid, _jittered(sol0), q0s, v0s)[0]
    out["f32_drift"], _ = _f32_drift("walk", sol64, {
        "kernel": out_k[0], "plain": out_p[0], "plain jittered": sol_j},
        sol_p64)
    if out["f32_gates_missed"]:
        print("  walk: float32 gates missed (reported, float64 gate holds): "
              + "; ".join(out["f32_gates_missed"]))
    out.update(warm_start_s=warm_s, warm_start_kkt=kkt_w,
               biped_standing_kkt=kkt, stage_slots=B * (n_slots - 1),
               biped_standing_launches=standing_launches)
    print("walk: " + json.dumps(out))
    return launches, out


def warm_fleet(p, q, v, dtype, dev, scale, seed=0):
    """A fleet of B scenarios at the iterate a gait problem's MPC holds
    (after `problems.warm_start`), in `dtype`: the MPC's contacts, limits,
    cost stack, grid and solution cast and the solution broadcast, the
    initial state (q, v) with q moved by scale N(0, 1) in the tangent
    space (numpy seed `seed`, the same draw in every dtype). Returns
    (model, (contacts, limits, costs, grid, sol), sol0, q0s, v0s, mk),
    mk(use_kernels, search=False) -> the fleet's solver."""
    mpc = p.mpc
    dq = np.random.default_rng(seed).standard_normal((B, p.model.nv))
    model = convert.astype(p.model, dtype)
    objs = [convert.astype(x, dtype) for x in (
        mpc.contacts, mpc.limits, mpc._costs, mpc.grid, mpc.sol)]
    sol0 = objs[4].map(lambda x: x.expand((B,) + x.shape).contiguous())
    q0s = rm.integrate(model, q.to(dtype).expand(B, model.nq),
                       torch.as_tensor(scale * dq, dtype=dtype, device=dev))
    v0s = v.to(dtype).expand(B, model.nv).contiguous()

    def mk(k, search=False):
        return OS.OCPSolver(model, objs[0], objs[2], objs[1], T=p.T, N=p.N,
                            n_reserved_events=mpc.n_reserved,
                            options=OS.SolverOptions(
                                switching_constraints=True, use_kernels=k,
                                enable_line_search=search))
    return model, objs, sol0, q0s, v0s, mk


# the walk's float32 fleet, kept by phase_walk for phase_solve's reading
WALK_FLEET = {}


def sync_sites(fn):
    """The synchronising CUDA calls fn makes, counted by the innermost line
    of this repository on the stack when each was made: the warnings of
    torch.cuda.set_sync_debug_mode("warn") while it runs."""
    torch.cuda.synchronize()
    sites = Counter()

    def note(message, *args, **kwargs):
        if "synchroniz" not in str(message).lower():
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(ROOT + os.sep)
                and f.name not in ("note", "sync_sites")]
        where = ours[-1] if ours else None
        sites["?" if where is None else
              f"{os.path.relpath(where.filename, ROOT)}:{where.lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def _launches_per_build(tag, launches, builds, directions):
    """solve launches K1, Kc, K2, K3 and K6 once per build and K5 once per
    Newton direction."""
    want = {k: directions if k == "K5" else builds for k in launches}
    check(launches == want, f"{tag}: launches {launches} != {want} "
          f"({builds} builds, {directions} directions)")


def phase_solve(dev, readings=False):
    """OCPSolver.solve and the line searches on the card, through the
    kernels: (a) the golden standing problem in float64 through solve, 16
    iterations, against 16 updates (1e-10 of each field's max-abs) and
    the golden trace (1e-6); (b) the barrier path of
    tests/test_barrier_schedule.py (N 6, mu 1e-2 to 1e-5) to KKT < 1e-7
    with that test's statistics; (c) the trot fleet in float32 with the
    merit search: launches, finite KKT, each accepted step at most its
    scenario's fraction-to-boundary step, the float64 fleet's merit step
    through the kernels against the plain versions (1e-8), the
    synchronising calls of one update with and without the search (the
    search adds none), and, printed, how many scenarios backtracked and
    ms per MPC step with and without the search; (d) the filter search
    through solve on the standing fleet in float32, 4 iterations: finite
    KKT and launches per build; (e) printed: the walk fleet's KKT after
    one MPC step with the merit search (when the walk phase ran)."""
    f32, f64 = torch.float32, torch.float64
    out = {}
    # (a) the golden problem through solve
    ref = np.load(GOLDEN)
    p = problems.anymal_standing(N=N, dtype=f64, device=dev)

    def standing(pp, **opts):
        return OS.OCPSolver(pp.model, pp.contacts, (pp.cost,), pp.limits,
                            T=pp.T, N=pp.N, options=OS.SolverOptions(**opts))

    solver = standing(p, max_iter=16, kkt_tol=0.0)
    sol0 = solver.init_solution(p.grid, p.q0, p.v0)
    reset_counts()
    sol, st = solver.solve(p.grid, p.q0, p.v0, sol=sol0)
    launches = read_counts()
    check(int(st["iterations"]) == 16, f"golden solve: {st['iterations']}"
          " iterations")
    _launches_per_build("golden solve", launches, 17, 16)
    sol_u = sol0
    for _ in range(16):
        sol_u, _, _, _ = solver.update(p.grid, p.q0, p.v0, sol_u)
    worst = {n: float((getattr(sol, n) - getattr(sol_u, n)).abs().max())
             / max(float(getattr(sol_u, n).abs().max()), 1e-30)
             for n in FIELDS}
    check(all(v <= 1e-10 for v in worst.values()),
          f"golden solve vs 16 updates past 1e-10: {worst}")
    gold = max(float(np.abs(getattr(sol, n).cpu().numpy() - ref[n]).max())
               for n in ("q", "v", "a", "u", "f"))
    check(gold <= 1e-6 * max(1.0, max(float(np.abs(ref[n]).max())
                                      for n in ("q", "v", "a", "u", "f"))),
          f"golden solve: off the golden trace by {gold:.3e}")
    kkt_a = float(st["kkt_error"])
    print(f"  solve golden: 16 iterations, kkt {kkt_a:.3e}; vs 16 updates, "
          f"error / max-abs {max(worst.values()):.1e}; max |x - golden| "
          f"{gold:.3e}; launches {launches}")
    out["golden"] = dict(kkt=kkt_a, vs_updates=max(worst.values()),
                         vs_golden=gold)
    # (b) the barrier path (tests/test_barrier_schedule.py's problem)
    pb = problems.anymal_standing(N=6, T=0.025 * 6, dtype=f64, device=dev)
    solver = standing(pb, max_iter=30, kkt_tol=1e-7, barrier=1e-2,
                      mu_min=1e-5, kkt_tol_mu=1e-4,
                      mu_linear_decrease_factor=0.2,
                      mu_superlinear_decrease_power=1.5)
    sol, st, stats = solver.solve(pb.grid, pb.q0, pb.v0, statistics=True)
    kkt_b = float(st["kkt_error"])
    check(bool(st["convergence"]) and kkt_b < 1e-7 and stats.convergence,
          f"barrier path: kkt {kkt_b:.3e}, {st}")
    check(stats.barrier[0] == 1e-2 and np.isclose(stats.barrier[-1], 1e-5)
          and len(stats.barrier) >= 3, f"barrier path: {stats.barrier}")
    check(stats.iter == len(stats.kkt_error) > 0
          and stats.kkt_error[-1] < 1e-7
          and all(np.isfinite(k) for k in stats.kkt_error)
          and stats.cpu_time > 0.0, f"barrier path statistics: {stats}")
    print(f"  solve barrier path: mu {stats.barrier}, {stats.iter} "
          f"iterations, kkt {kkt_b:.3e}, {stats.cpu_time:.0f} ms")
    out["barrier_path"] = dict(mu=stats.barrier, iterations=stats.iter,
                               kkt=kkt_b, ms=stats.cpu_time)
    # (c) the trot fleet with the merit search, float32
    pt, mk, (sol0, q0s, v0s) = trot_fleet(f32, dev)
    s_ls, s_no = mk(True, "merit"), mk(True)
    _mpc_step(s_ls, pt.grid, sol0, q0s, v0s)            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    sol_ls, kkts = _mpc_step(s_ls, pt.grid, sol0, q0s, v0s)
    torch.cuda.synchronize()
    launches = read_counts()
    check(all(v == 2 for v in launches.values()),
          f"trot merit: expected 1 launch of each kernel per update: "
          f"{launches}")
    check(all(bool(torch.isfinite(k).all()) for k in kkts),
          "trot merit: KKT not finite")
    sol_i, backtracked = sol0, []
    for i in range(2):
        new, _, a_ls, _ = s_ls.update(pt.grid, q0s, v0s, sol_i)
        a_max = s_no.update(pt.grid, q0s, v0s, sol_i)[2]
        check(bool((a_ls <= a_max).all()), f"trot merit update {i}: a step "
              "past its fraction-to-boundary step")
        backtracked.append(int((a_ls < a_max).sum()))
        sol_i = new
    p64, mk64, (sol64, q64, v64) = trot_fleet(f64, dev)
    worst64, _ = _agree_f64("trot merit", lambda k: mk64(k, "merit"),
                            p64.grid, sol64, q64, v64)
    # the first use of the debug mode is discarded: it can count a call of
    # its own, made at no line of the program
    sync_sites(lambda: s_no.update(pt.grid, q0s, v0s, sol0))
    sites = {name: sync_sites(lambda: sv.update(pt.grid, q0s, v0s, sol0))
             for name, sv in (("without", s_no), ("with search", s_ls))}
    syncs = {name: sum(c.values()) for name, c in sites.items()}
    print(f"  solve trot: synchronising calls of one update by line: "
          f"{ {k: dict(v) for k, v in sites.items()} }")
    check(syncs["with search"] == syncs["without"],
          f"trot merit: the search adds synchronising calls: {syncs}, at "
          f"{dict(sites['with search'] - sites['without'])}")
    # both solvers' glue has run above: one timed MPC step each
    ms = {name: host_ms(lambda: _mpc_step(sv, pt.grid, sol0, q0s, v0s),
                        reps=1, warmup=False)
          for name, sv in (("with search", s_ls), ("without", s_no))}
    print(f"  solve trot merit (B={B}, float32): launches {launches}; fleet "
          f"KKT max {float(kkts[-1].max()):.4e}; scenarios backtracked, "
          f"update 1 / 2: {backtracked[0]} / {backtracked[1]} of {B}; "
          f"synchronising calls in one update {syncs}; ms per MPC step "
          f"{ms}")
    out["trot_merit"] = dict(launches=launches,
                             fleet_max_kkt=float(kkts[-1].max()),
                             backtracked=backtracked, syncs=syncs,
                             ms_per_mpc_step=ms, f64_agreement=worst64)
    # (d) the filter through solve on the standing fleet, float32
    ps = problems.anymal_standing(N=N, dtype=f32, device=dev)
    _, (sol0, q0s, v0s) = standing_fleet(ps, B)
    solver = standing(ps, max_iter=4, enable_line_search="filter")
    reset_counts()
    sol, st = solver.solve(ps.grid, q0s, v0s, sol=sol0)
    launches = read_counts()
    loops = int(st["iterations"].max())
    check(bool(torch.isfinite(st["kkt_error"]).all()),
          "standing filter solve: KKT not finite")
    _launches_per_build("standing filter solve", launches, loops + 1, loops)
    print(f"  solve standing filter (B={B}, float32, max_iter 4): "
          f"{loops} iterations, fleet KKT max "
          f"{float(st['kkt_error'].max()):.4e}, steps by iteration (min) "
          + ", ".join(f"{float(a):.3g}" for a in
                      st["step_size_history"].amin(dim=0))
          + f"; launches {launches}")
    out["standing_filter"] = dict(iterations=loops, launches=launches,
                                  fleet_max_kkt=float(st["kkt_error"].max()))
    # (e) the walk fleet with the merit search, printed (with the readings)
    if WALK_FLEET and readings:
        w = WALK_FLEET
        _, kkts = _mpc_step(w["mk"](True, "merit"), w["grid"], w["sol0"],
                            w["q0s"], w["v0s"])
        out["walk_merit_kkt"] = float(kkts[-1].max())
        print(f"  solve walk merit (B={B}, float32): fleet KKT max after "
              f"one MPC step {out['walk_merit_kkt']:.4e} (printed, not "
              "gated)")
    else:
        print("  solve walk merit: not read (it needs the walk and the "
              "readings phases)")
    print("solve: " + json.dumps(out))
    return out


IIWA_GOLDEN = os.path.join(ROOT, "tests", "golden", "iiwa14_config_ocp.npz")
# the JAX package's iteration count on the iiwa14 task-space OCP
# (tests/test_torch_costs.py)
TASK_SPACE_ITERS = 12
UNCONSTR_FIELDS = ("q", "v", "a", "u", "lmd", "gmm", "beta", "slack", "dual")


def _arm_timing(tag, p, q0s, v0s, sol):
    """ms per solve iteration of the fleet (one `update` is one iteration's
    work: a build and a Newton step; host clock, synchronised, one timed
    call; the solve just before has run the same glue). Its parts and
    device time are not measured: a profiler trace of the serial sweep's
    launches costs tens of seconds."""
    ms = host_ms(lambda: p.solver.update(q0s, v0s, sol), 1, warmup=False)
    print(f"  {tag}: {ms:.2f} ms per solve iteration (host clock); by part "
          f"and device time not measured; {card_line()}")
    return dict(ms_per_iteration=ms)


def _same(tag, got, want, tol):
    """Each field of `got` within tol of `want`'s max-abs (at least one)."""
    worst = 0.0
    for name in dataclasses.fields(want):
        w = getattr(want, name.name)
        g = getattr(got, name.name)
        scale = max(1.0, float(w.abs().max()))
        err = float((g.to(w.dtype) - w).abs().max()) / scale
        worst = max(worst, err)
        check(err <= tol, f"{tag}: {name.name} off by {err:.3e} of its "
              f"max-abs (> {tol:g})")
    return worst


def phase_unconstr(dev):
    """The unconstrained family on the iiwa14 (fixed base, no contacts),
    through UnconstrOCPSolver.solve and UnconstrParNMPCSolver.solve: (a)
    the golden trace, N 60, T 3, float64, one scenario: converged, KKT <
    1e-7 in < 30 iterations, q, v, a, u within 1e-6 of
    tests/golden/iiwa14_config_ocp.npz; (b) a B = 128 float64 fleet with
    q0 moved by 0.05 N(0, 1): every scenario below 1e-7, two sampled
    scenarios equal to their own solves (1e-10 of each field's max-abs),
    and printed iterations, ms per iteration, device ms and idle share;
    the same fleet in float32 (as many iterations as the float64 fleet's
    most): finite KKT gated, its KKT, ms per iteration and agreement with
    the float64 fleet printed; (c) the filter search on
    tests/test_unconstr_solver.py's case (N 20, T 3): converged below
    1e-7; (d) ParNMPC on tests/test_parnmpc.py's problem (N 20, T 1): KKT
    < 1e-7 in < 60 iterations, agreement with the Riccati solver at that
    test's tolerances, the filter search's case to KKT < 1e-6 without a
    numerical failure, and a B = 128 fleet printed with ms per iteration;
    (e) the iiwa14 task-space OCP of examples/iiwa14_task_space_ocp.py
    (float64): converged below 1e-7 in the JAX package's iteration count.
    The family reaches none of the six kernels: their counts stay 0."""
    f32, f64 = torch.float32, torch.float64
    card = card_line()
    out = {}
    seconds = {}
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        seconds[part] = now - clock[0]
        clock[0] = now

    reset_counts()
    # (a) the golden trace
    ref = np.load(IIWA_GOLDEN)
    p = problems.iiwa14_config(dtype=f64, device=dev)
    sol, st = p.solver.solve(p.q0, p.v0)
    its, kkt = int(st["iterations"]), float(st["kkt_error"])
    check(bool(st["convergence"]) and kkt < 1e-7 and its < 30,
          f"unconstr golden: convergence {bool(st['convergence'])}, kkt "
          f"{kkt:.3e}, {its} iterations")
    errs = {}
    for name in ("q", "v", "a", "u"):
        got = getattr(sol, name).cpu().numpy()
        errs[name] = float(np.abs(got - ref[name]).max())
        check(np.allclose(got, ref[name], rtol=1e-6, atol=1e-6),
              f"unconstr golden: {name} off by {errs[name]:.3e}")
    out["golden"] = dict(iterations=its, kkt=kkt,
                         max_abs_err=max(errs.values()))
    lap("golden")
    print(f"  unconstr golden (N 60, float64): kkt {kkt:.3e} in {its} "
          f"iterations; max |x - golden| {max(errs.values()):.3e} "
          f"(tolerance 1e-6); {card}")
    # (b) the fleet, float64 then float32
    q0s, v0s = problems.iiwa14_fleet(p, B, seed=0)
    sol_b, st_b = p.solver.solve(q0s, v0s)
    kkts = st_b["kkt_error"]
    check(bool((kkts < 1e-7).all()), f"unconstr fleet: KKT max "
          f"{float(kkts.max()):.3e} >= 1e-7")
    its_b = st_b["iterations"]
    worst = 0.0
    for b in (0, B - 1):
        sol_1, st_1 = p.solver.solve(q0s[b], v0s[b])
        check(int(st_1["iterations"]) == int(its_b[b]),
              f"unconstr fleet scenario {b}: {int(its_b[b])} iterations, "
              f"alone {int(st_1['iterations'])}")
        worst = max(worst, _same(f"unconstr fleet scenario {b}",
                                 sol_b.map(lambda x: x[b]), sol_1, 1e-10))
    lap("fleet float64 with two single solves")
    timing = _arm_timing("unconstr fleet float64", p, q0s, v0s, sol_b)
    lap("fleet float64 timing")
    out["fleet_f64"] = dict(B=B, N=p.N, iterations_max=int(its_b.max()),
                            iterations_min=int(its_b.min()),
                            kkt_max=float(kkts.max()),
                            sampled_vs_single=worst, **timing)
    print(f"  unconstr fleet (B={B}, N 60, float64): KKT max "
          f"{float(kkts.max()):.3e}, iterations {int(its_b.min())}-"
          f"{int(its_b.max())}; scenarios 0 and {B - 1} vs their own "
          f"solves {worst:.3e} of max-abs (tolerance 1e-10); {card}")
    p32 = problems.iiwa14_config(dtype=f32, device=dev,
                                 options=US.SolverOptions(
                                     max_iter=int(its_b.max())))
    q32, v32 = q0s.to(f32), v0s.to(f32)
    sol_32, st_32 = p32.solver.solve(q32, v32)
    k32 = st_32["kkt_error"]
    check(bool(torch.isfinite(k32).all()), "unconstr fleet float32: KKT "
          "not finite")
    agree = max(float((getattr(sol_32, n).double() - getattr(sol_b, n))
                      .abs().max()) / max(1.0, float(getattr(sol_b, n)
                                                     .abs().max()))
                for n in UNCONSTR_FIELDS)
    timing32 = _arm_timing("unconstr fleet float32", p32, q32, v32, sol_32)
    out["fleet_f32"] = dict(iterations=int(st_32["iterations"].max()),
                            kkt_max=float(k32.max()),
                            kkt_median=float(k32.median()),
                            vs_f64=agree, **timing32)
    print(f"  unconstr fleet float32: KKT max {float(k32.max()):.3e}, "
          f"median {float(k32.median()):.3e} after "
          f"{int(st_32['iterations'].max())} iterations; largest field "
          f"difference from the float64 fleet {agree:.3e} of max-abs "
          f"(printed, not gated); {card}")
    lap("fleet float32 with timing")
    # (c) the filter search
    pls = problems.iiwa14_config(N=20, T=3.0, dtype=f64, device=dev,
                                 options=US.SolverOptions(
                                     enable_line_search=True))
    _, st_ls = pls.solver.solve(pls.q0, pls.v0)
    check(bool(st_ls["convergence"]) and float(st_ls["kkt_error"]) < 1e-7,
          f"unconstr filter search: kkt {float(st_ls['kkt_error']):.3e}")
    out["filter"] = dict(iterations=int(st_ls["iterations"]),
                         kkt=float(st_ls["kkt_error"]))
    print(f"  unconstr filter search (N 20, T 3): kkt "
          f"{float(st_ls['kkt_error']):.3e} in {int(st_ls['iterations'])} "
          f"iterations; {card}")
    lap("filter search")
    # (d) ParNMPC
    pp = problems.iiwa14_config(N=20, T=1.0, dtype=f64, device=dev,
                                parnmpc=True)
    sol_p, st_p = pp.solver.solve(pp.q0, pp.v0)
    its_p, kkt_p = int(st_p["iterations"]), float(st_p["kkt_error"])
    check(kkt_p < 1e-7 and its_p < 60 and not bool(
        st_p["numerical_failure"]), f"parnmpc: kkt {kkt_p:.3e} in {its_p} "
          "iterations")
    pr = problems.iiwa14_config(N=20, T=1.0, dtype=f64, device=dev)
    sol_r, st_r = pr.solver.solve(pr.q0, pr.v0)
    check(bool(st_r["convergence"]), "parnmpc: the Riccati solve did not "
          "converge")
    dt = 1.0 / 20
    gaps = {"q": (sol_p.q - sol_r.q[1:], 5.0 * dt),
            "v[3:]": (sol_p.v[3:] - sol_r.v[4:], 5.0 * dt),
            "q[-1]": (sol_p.q[-1] - sol_r.q[-1], 2.0 * dt)}
    for name, (d, tol) in gaps.items():
        check(float(d.abs().max()) <= tol, f"parnmpc vs Riccati: {name} "
              f"off by {float(d.abs().max()):.3e} > {tol:g}")
    pls_p = problems.iiwa14_config(
        N=20, T=1.0, dtype=f64, device=dev, parnmpc=True,
        options=PN.SolverOptions(enable_line_search=True, max_iter=60,
                                 kkt_tol=1e-6))
    _, st_pl = pls_p.solver.solve(pls_p.q0, pls_p.v0)
    check(float(st_pl["kkt_error"]) < 1e-6 and not bool(
        st_pl["numerical_failure"]), "parnmpc filter search: kkt "
          f"{float(st_pl['kkt_error']):.3e}, failure "
          f"{bool(st_pl['numerical_failure'])}")
    lap("parnmpc, Riccati and filter search, one scenario each")
    q0p, v0p = problems.iiwa14_fleet(pp, B, seed=0)
    sol_pb, st_pb = pp.solver.solve(q0p, v0p)
    kpb = st_pb["kkt_error"]
    check(bool(torch.isfinite(kpb).all()), "parnmpc fleet: KKT not finite")
    tp = _arm_timing("parnmpc fleet float64", pp, q0p, v0p, sol_pb)
    out["parnmpc"] = dict(
        iterations=its_p, kkt=kkt_p,
        vs_riccati={k: float(d.abs().max()) for k, (d, _) in gaps.items()},
        filter_iterations=int(st_pl["iterations"]),
        filter_kkt=float(st_pl["kkt_error"]),
        fleet=dict(B=B, N=pp.N, kkt_max=float(kpb.max()),
                   iterations_max=int(st_pb["iterations"].max()),
                   failures=int(st_pb["numerical_failure"].sum()), **tp))
    print(f"  parnmpc (N 20, T 1, float64): kkt {kkt_p:.3e} in {its_p} "
          f"iterations; vs the Riccati solver "
          + ", ".join(f"{k} {float(d.abs().max()):.3e}"
                      for k, (d, _) in gaps.items())
          + f"; filter search kkt {float(st_pl['kkt_error']):.3e} in "
          f"{int(st_pl['iterations'])}; fleet B={B} KKT max "
          f"{float(kpb.max()):.3e}, iterations "
          f"{int(st_pb['iterations'].max())}; {card}")
    lap("parnmpc fleet with timing")
    # (e) the iiwa14 task-space OCP (TaskSpace3DCost on a ConstantRef)
    pt = problems.iiwa14_task_space(dtype=f64, device=dev)
    sol_t, st_t = pt.solver.solve(pt.q0, pt.v0)
    its_t, kkt_t = int(st_t["iterations"]), float(st_t["kkt_error"])
    dist = float((rm.frame_position(pt.model, pt.frame_id, sol_t.q[-1])
                  - pt.target).norm())
    check(bool(st_t["convergence"]) and kkt_t < 1e-7
          and its_t == TASK_SPACE_ITERS, f"task space: convergence "
          f"{bool(st_t['convergence'])}, kkt {kkt_t:.3e}, {its_t} "
          f"iterations (JAX: {TASK_SPACE_ITERS})")
    out["task_space"] = dict(iterations=its_t, kkt=kkt_t,
                             end_effector_error=dist)
    print(f"  task space (iiwa14, N 30, float64): kkt {kkt_t:.3e} in "
          f"{its_t} iterations (JAX {TASK_SPACE_ITERS}); end effector "
          f"{dist:.3e} m from its target; {card}")
    lap("task space")
    out["seconds"] = seconds
    launches = read_counts()
    check(all(v == 0 for v in launches.values()),
          f"unconstr: a kernel launched on the unconstrained family: "
          f"{launches}")
    out["kernel_launches"] = launches
    out["card"] = card
    print("unconstr: " + json.dumps(out))
    return out


def _cpu(obj):
    """A dataclass of tensors (a solution, grid or policy) with every
    tensor copied to the host."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def policy_check(p):
    """The MPC's control policy on the card at five times, across its
    first stage interval and across the first touchdown's impact slot,
    against the same policy computed from a host copy of its solution,
    grid and gains (float64, 1e-12 of each output's max-abs), with the
    control input of a seeded measurement. Returns the worst error
    ratio."""
    mpc = p.mpc
    ts = mpc.grid.t.cpu().numpy()
    imp = [i for i in range(len(ts) - 1) if float(mpc.grid.is_impact[i]) > 0
           and float(mpc.grid.imp_mask[i].sum()) > 0]
    check(bool(imp), "policy: no touchdown in the horizon")
    times = [ts[0], ts[0] + 0.3 * (ts[1] - ts[0]), ts[0] + 0.8 * (ts[1] - ts[0]),
             ts[imp[0]] - 1e-3, ts[imp[0]] + 1e-3]
    grid, sol, gains = _cpu(mpc.grid), _cpu(mpc.sol), _cpu(mpc.lqr_policy)
    rng = np.random.default_rng(9)
    worst = 0.0
    for t in times:
        got = mpc.get_control_policy(t)
        want = ControlPolicy.from_solution(p.model, grid, sol, gains, t)
        meas = torch.as_tensor(rng.standard_normal((2, p.model.dimu)),
                               dtype=torch.float64)
        pairs = [(getattr(got, n).cpu(), getattr(want, n))
                 for n in ("tauJ", "qJ", "dqJ", "Kp", "Kd")]
        pairs.append((got.control_input(meas[0].to(got.tauJ.device),
                                        meas[1].to(got.tauJ.device)).cpu(),
                      want.control_input(meas[0], meas[1])))
        for g, w in pairs:
            worst = max(worst, float((g - w).abs().max())
                        / max(1.0, float(w.abs().max())))
    print(f"  crawl control policy at t = "
          + ", ".join(f"{t:.4f}" for t in times)
          + f": card vs host copy, error / max-abs {worst:.1e} (gate 1e-12)")
    check(worst <= 1e-12, f"crawl control policy: card vs host {worst:.3e}")
    return worst


def slot_errors(tag, p, sol_b, grid_b, idx):
    """Every stage kernel against its plain version on one fleet's own
    inputs (K6 with the problem's cost fold when its stack folds, the
    condense kernels on the plain route's condense inputs), the error at
    the stage slots idx (flat indices) over each output's max-abs over
    all slots; gated at TOL. Returns {kernel: ratio}."""
    model, contacts, costs = p.model, p.mpc.contacts, p.costs
    dtype = sol_b.q.dtype
    args, cost = chain_args(model, contacts, costs, sol_b, grid_b,
                            chn.cost_fold_supported(model, costs, contacts))
    pre = OS.stage_pre_all(model, contacts, p.mpc.limits, 1e-3, costs,
                           sol_b, grid_b, n_imp=p.mpc.n_reserved,
                           use_chain=False)
    x = {k: pre[k].contiguous() for k in cd.IN_NAMES}
    k1_in, k2_in = _k12_inputs(x)
    p1, p2 = cd.k1_plain(*k1_in), cd.k2_plain(*k2_in)
    k3_in = [p1[3], p1[4], p2[3].contiguous()] + [
        x[n] for n in ("Aqq", "Aqv", "xres_q", "Fv_res", "sA", "lam2",
                       "lmdgmm")]
    kc_in = [x["dgdq"], x["dgdf"], x["d_cone"]]
    names = chn._OUTS + (chn._COST_OUTS if cost else ())
    cases = {"K6": (lambda: [chn.chain(model, contacts, *args, *cost)[n]
                             for n in names],
                    lambda: [chn.chain_plain(model, contacts, *args,
                                             *cost)[n] for n in names]),
             "K1": (lambda: cd.k1(*k1_in), lambda: p1),
             "Kc": (lambda: cd.kc(*kc_in), lambda: cd.kc_plain(*kc_in)),
             "K2": (lambda: cd.k2(*k2_in), lambda: p2),
             "K3": (lambda: cd.k3(*k3_in), lambda: cd.k3_plain(*k3_in))}
    out = {}
    for key, (kern, plain) in cases.items():
        worst = 0.0
        for k, w in zip(kern(), plain()):
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((k[idx] - w[idx]).abs().max()) / scale)
        out[key] = worst
    print(f"  {tag} {str(dtype):14s} kernel vs plain at the {len(idx)} "
          "flight slots, error / each output's max-abs: "
          + ", ".join(f"{k} {v:.1e}" for k, v in out.items())
          + f" (gate {TOL[dtype]:.0e})")
    check(all(v <= TOL[dtype] for v in out.values()),
          f"{tag} {dtype}: kernel vs plain at the flight slots past "
          f"{TOL[dtype]:.0e}: {out}")
    return out


def gait_gates(tag, f32, f64):
    """The gates of a gait fleet, as the trot's: one MPC step of the
    float32 fleet through the kernels (`_run_path`: launch counts, finite
    KKT; the agreement with the plain step printed; ms per MPC step, not
    profiled), the float64 fleet's step through the kernels
    against the plain versions (1e-8) and the float32 drift gate at TROT_K
    (`trot_gate`). f32, f64: (mk, grid, sol0, q0s, v0s). Returns the
    result with the launch counts."""
    t0 = time.perf_counter()
    launches, out, (out_k, out_p) = _run_path(
        tag, *f32, strict=False, profile=False)
    t1 = time.perf_counter()
    gate = trot_gate(tag, f32, f64, out_k, out_p)
    out.update(launches=launches, f64_agreement=gate["f64_agreement"],
               drift_ratio=gate["drift_ratio"], drift_factor=TROT_K,
               seconds={"path": t1 - t0, "gate": time.perf_counter() - t1})
    print(f"{tag} gates: " + json.dumps({k: out[k] for k in (
        "launches", "f64_agreement", "drift_ratio")}))
    return out


def phase_gaits(dev):
    """The remaining periodic gaits through the kernels. (a) The A1 crawl
    on terrain (K6's four-feet instance on the A1 tree, without the cost
    fold, its task rows feeding the stack): warmed in float64 at B = 1
    (`init`, closed-loop updates to CRAWL_T), its control policy on the
    card against a host copy; then fleets of B scenarios around the warm
    state: `gait_gates`, with the host time by part. (b) The ANYmal pace
    (no fold) and (c) flying trot (the fold; a flight with no contact
    active, then its touchdown, in the horizon): `gait_gates` on fleets
    built as the trot's; the flying trot's kernels against their plain
    versions at the flight slots (`slot_errors`, float64 and float32)."""
    f32_, f64_ = torch.float32, torch.float64
    t_phase = time.perf_counter()
    out = {}
    # (a) the A1 crawl
    t0 = time.perf_counter()
    p = problems.a1_crawl(N=N, dtype=f64_, device=dev)
    t, q, v = problems.warm_start(p, CRAWL_T, CRAWL_DT,
                                  init_iters=CRAWL_INIT)
    mpc = p.mpc
    kkt_w = mpc.kkt_error(t, q, v)
    warm_s = time.perf_counter() - t0
    cm0 = mpc.grid.contact_mask[0].tolist()
    n_td = int((mpc.grid.imp_mask.sum(dim=-1) > 0).sum())
    print(f"  crawl warm start: t = {t:.3f} s in steps of {CRAWL_DT} s after "
          f"{CRAWL_INIT} init updates (the MPC's last plan at "
          f"{float(mpc.grid.t[0]):.3f} s), kkt {kkt_w:.3e}, {warm_s:.1f} s; "
          f"contacts in the plan's first stage {cm0}, touchdowns in its "
          f"horizon {n_td}")
    check(np.isfinite(kkt_w), "crawl warm start: KKT not finite")
    check(sum(cm0) == 3 and n_td >= 1, "crawl warm start: not one foot in "
          f"swing with a touchdown ahead: {cm0}, {n_td}")
    check(not chn.cost_fold_supported(p.model, mpc._costs, mpc.contacts),
          "crawl: its stack should not fold")
    out["crawl_policy_err"] = policy_check(p)
    _, (_, _, _, grid, _), sol0, q0s, v0s, mk = warm_fleet(
        p, q, v, f32_, dev, scale=GAIT_SCALE)
    _, (_, _, _, grid64, _), sol64, q64, v64, mk64 = warm_fleet(
        p, q, v, f64_, dev, scale=GAIT_SCALE)
    out["crawl"] = gait_gates(
        "crawl", (mk, grid, sol0, q0s, v0s), (mk64, grid64, sol64, q64, v64))
    out["crawl"].update(warm_start_s=warm_s, warm_start_kkt=kkt_w,
                        stage_slots=B * (grid.n_slots - 1))
    seconds = {"crawl warm start": warm_s,
               "crawl": time.perf_counter() - t0 - warm_s}
    # (b) the pace, (c) the flying trot
    for name in ("pace", "flying_trot"):
        t0 = time.perf_counter()
        make = gait_problem(name)
        p32, mk, (sol0, q0s, v0s) = trot_fleet(f32_, dev, make=make)
        p64, mk64, (sol64, q64, v64) = trot_fleet(f64_, dev, make=make)
        folds = chn.cost_fold_supported(p32.model, p32.costs,
                                        p32.mpc.contacts)
        check(folds == (name == "flying_trot"), f"{name}: cost fold {folds}")
        res = {}
        if name == "flying_trot":
            flight = flight_slots(p32.grid)
            print(f"  flying trot: {len(flight)} flight slots per scenario "
                  f"(no contact active) at t = "
                  + ", ".join(f"{float(p32.grid.t[i]):.3f}" for i in flight))
            check(len(flight) >= 1, "flying trot: no flight slot in the "
                  "horizon")
            S1 = p32.grid.n_slots - 1
            idx = torch.tensor([b * S1 + i for b in range(B)
                                for i in flight], device=dev)
            for pp, s_, q_, v_ in ((p64, sol64, q64, v64),
                                   (p32, sol0, q0s, v0s)):
                sb, gb, _, _, _ = OS._fleet(s_, pp.grid, q_, v_)
                res[str(pp.model.dtype)] = slot_errors(
                    "flying trot", pp, sb, gb, idx)
            res["flight_slots"] = len(flight)
        out[name] = gait_gates(name, (mk, p32.grid, sol0, q0s, v0s),
                               (mk64, p64.grid, sol64, q64, v64))
        out[name].update(flight_errors=res, cost_fold=folds,
                         stage_slots=B * (p32.grid.n_slots - 1))
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = dict(seconds, phase=time.perf_counter() - t_phase)
    print("  gaits seconds: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in out["seconds"].items()))
    print("gaits: " + json.dumps(out))
    return out


def jump_fleet(p, dtype, dev, seed=0):
    """A fleet of B scenarios of the jump MPC `p` (planned by its `init`)
    at JUMP_T, in `dtype`: its grid there, the solver's warm start at the
    standing state broadcast, the initial configurations moved by
    JUMP_SCALE N(0, 1) in the tangent space (`problems.fleet`, numpy seed
    `seed`: the same draw in every dtype). Returns (model, contacts, cost,
    grid, (sol0, q0s, v0s), mk), mk(use_kernels, search="kkt") -> the
    fleet's solver with the MPC's options and that search."""
    mpc = p.mpc
    model, contacts, cost, limits, grid = [convert.astype(x, dtype) for x in (
        p.model, mpc.contacts, mpc.config_cost, mpc.limits,
        mpc._grid(JUMP_T))]

    def mk(k, search="kkt"):
        return OS.OCPSolver(model, contacts, (cost,), limits, T=p.T, N=p.N,
                            n_reserved_events=mpc.n_reserved,
                            options=OS.SolverOptions(
                                max_iter=2, switching_constraints=True,
                                use_kernels=k, enable_line_search=search))
    return model, contacts, cost, grid, problems.fleet(
        mk(True), grid, p.q0.to(dtype), p.v0.to(dtype), B, seed=seed,
        scale=JUMP_SCALE), mk


def kernel_calls(fn):
    """The arguments of every call of each of the six kernels' wrappers
    while fn runs, in order: {kernel: [args, ...]}."""
    seen = {key: [] for key in KERNEL_SITES}

    def grabber(key):
        def make(kern):
            def grab(*a):
                seen[key].append(a)
                return kern(*a)

            grab.launches = 0   # the wrapper counts on the name it is under
            return grab
        return make

    with contextlib.ExitStack() as stack:
        for key in KERNEL_SITES:
            stack.enter_context(_swapped(key, grabber(key)))
        fn()
    return seen


def _kernel_outputs(key, out):
    """A kernel's outputs as a list (K6's dict in _OUTS order)."""
    return [out[n] for n in chn._OUTS] if key == "K6" else list(out)


def path_kernels(tag, calls, dtype, shown=()):
    """Each kernel against its plain version on the arguments of every
    call the path made (`kernel_calls`), at TOL (`_compare`); the kernels
    in `shown` printed only (each output's max abs error over its
    max-abs). Returns {kernel: [max abs error of each call]}."""
    out = {}
    for key, arg_list in calls.items():
        _, name, plain = KERNEL_SITES[key]
        kern = getattr(KERNEL_SITES[key][0], name)
        out[key] = []
        for i, a in enumerate(arg_list):
            got = _kernel_outputs(key, kern(*a))
            want = _kernel_outputs(key, plain(*a))
            if key not in shown:
                out[key].append(_compare(f"{key} {tag} {i}", got, want,
                                         dtype))
                continue
            rel = [float((g - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
                   for g, w in zip(got, want) if w is not None]
            out[key].append(max(rel))
            print(f"  {key} {tag} {i} {str(dtype):14s} error / max-abs by "
                  "output " + ", ".join(f"{r:.1e}" for r in rel)
                  + " (printed, not gated)")
    return out


def _rungs(fn):
    """The KKT search's rung index of each scenario in each search fn
    makes (OS._kkt_search recorded)."""
    seen, search = [], OS._kkt_search

    def recording(*a, **kw):
        scale, k = search(*a, **kw)
        seen.append(k)
        return scale, k

    OS._kkt_search = recording
    try:
        fn()
    finally:
        OS._kkt_search = search
    return seen


def phase_jump(dev):
    """The jump MPC through the kernels with the KKT-residual search. (a)
    float64, B = 1 (tests/test_mpc_jump.py): MPCJump's `init` with
    JUMP_INIT updates to KKT < 1e-2, the landing targets 0.1 m ahead
    (1e-12), then `update_solution` at JUMP_TIMES (finite KKT), the first
    control input and the policy finite; every kernel's launches per
    update (two builds: the update's and the ladder's; one Riccati sweep).
    (b) A B = 128 fleet of the MPC's plan at JUMP_T (`jump_fleet`: the
    solver's warm start at the standing state; a flight with no contact
    active, the landing impact with its switching rows and stance in the
    horizon), initial configurations moved by JUMP_SCALE N(0, 1): one MPC
    step of
    the float32 fleet (`_run_path`: launches, finite KKT), the float64
    fleet's step through the kernels against the plain versions (1e-8)
    and the float32 drift at TROT_K (`trot_gate`); the synchronising
    calls of one update with the search (none); printed: the scenarios
    that backtracked, ms per MPC step with the search. (c) Every kernel
    against its plain version on the
    arguments of each call of one fleet update (the update's build, the
    ladder's build of 9 B scenarios, the Riccati sweep), float64 and
    float32 (K5 in float32 printed there: the switching-constrained
    Riccati's float32 rounding floor on these inputs, check C2; gated on
    seeded inputs of the same shapes, `lqr_inputs`); K6 (no fold) on the
    path's stage slots and K5 (switching) on those seeded inputs timed
    for the kernels line. Returns (launches of the fleet's MPC step,
    result, records)."""
    f32_, f64_ = torch.float32, torch.float64
    t_phase = time.perf_counter()
    out, seconds = {}, {}
    # (a) the MPC in float64 at B = 1
    t0 = time.perf_counter()
    p = problems.anymal_jump(dtype=f64_, device=dev)
    mpc = p.mpc
    reset_counts()
    kkt0, kkts = None, []

    def run_mpc():
        nonlocal kkt0
        kkt0 = mpc.init(0.0, p.q0, p.v0, num_iters=JUMP_INIT)
        kkts.extend(mpc.update_solution(t, 0.05, p.q0, p.v0, max_iter=2)
                    for t in JUMP_TIMES)

    rungs_b1 = _rungs(run_mpc)
    launches = read_counts()
    n_upd = JUMP_INIT + 2 * len(JUMP_TIMES)
    want = {k: n_upd * (1 if k == "K5" else 2) for k in launches}
    check(launches == want, f"jump MPC: launches {launches} != {want}")
    back_b1 = sum(int(k.max()) > 0 for k in rungs_b1)
    moved = mpc._p_land[:, 0] - mpc._p_stance[:, 0]
    check(np.isfinite(kkt0) and kkt0 < 1e-2, f"jump init: KKT {kkt0:.3e}")
    check(np.allclose(moved, 0.1, rtol=0, atol=1e-12),
          f"jump: landing targets moved {moved}")
    check(all(np.isfinite(k) for k in kkts), f"jump updates: KKT {kkts}")
    u0 = mpc.get_initial_control_input()
    pol = mpc.get_control_policy(0.01)
    check(tuple(u0.shape) == (12,) and bool(torch.isfinite(u0).all())
          and bool(torch.isfinite(pol.tauJ).all()),
          "jump: control input or policy not finite")
    seconds["mpc float64"] = time.perf_counter() - t0
    print(f"  jump MPC (float64, B = 1): init KKT {kkt0:.3e} after "
          f"{JUMP_INIT} updates; landing targets moved {moved.tolist()}; "
          "KKT after update_solution at "
          + ", ".join(f"t {t}: {k:.3e}" for t, k in zip(JUMP_TIMES, kkts))
          + f"; launches in its {n_upd} updates {launches}; updates that "
          f"backtracked {back_b1} (rungs "
          f"{[int(k.max()) for k in rungs_b1 if int(k.max()) > 0]}); "
          f"{seconds['mpc float64']:.1f} s")
    out["mpc"] = dict(init_kkt=kkt0, launches=launches, update_kkts=kkts,
                      landing_moved=moved.tolist(), backtracked=back_b1)
    # (b) the fleet
    t0 = time.perf_counter()
    model, contacts, cost, grid, (sol0, q0s, v0s), mk = jump_fleet(
        p, f32_, dev)
    _, _, _, grid64, (sol64, q64, v64), mk64 = jump_fleet(p, f64_, dev)
    cm = grid.contact_mask.sum(dim=-1).tolist()
    print(f"  jump fleet at t = {JUMP_T}: contacts per slot {cm}")
    check(min(cm) == 0 and float(grid.imp_mask.sum()) == 4,
          "jump fleet: no flight and landing in the horizon")
    check(not chn.cost_fold_supported(model, (cost,), contacts),
          "jump: its stack should not fold")
    expect = {k: 2 if k == "K5" else 4 for k in COUNTERS}
    launches, res, (out_k, out_p) = _run_path(
        "jump", mk, grid, sol0, q0s, v0s, strict=False, expect=expect,
        profile=False)
    gate = trot_gate("jump", (mk, grid, sol0, q0s, v0s),
                     (mk64, grid64, sol64, q64, v64), out_k, out_p)
    res.update(launches=launches, f64_agreement=gate["f64_agreement"],
               drift_ratio=gate["drift_ratio"], drift_factor=TROT_K)
    # the first use of the debug mode is discarded (it can count a call of
    # its own)
    s_kkt = mk(True)
    sync_sites(lambda: s_kkt.update(grid, q0s, v0s, sol0))
    sites = {}
    rungs = _rungs(lambda: sites.update({"with search": sync_sites(
        lambda: s_kkt.update(grid, q0s, v0s, sol0))}))
    back = int((rungs[0] > 0).sum())
    hist = torch.bincount(rungs[0], minlength=len(OS.KKT_SCALES)).tolist()
    syncs = {name: sum(c.values()) for name, c in sites.items()}
    print(f"  jump: synchronising calls of one update by line: "
          f"{ {k: dict(v) for k, v in sites.items()} }")
    check(syncs["with search"] == 0, f"jump: the update with the search "
          f"synchronises: {dict(sites['with search'])}")
    res.update(backtracked=back, rungs=hist, syncs=syncs,
               stage_slots=B * (grid.n_slots - 1))
    print(f"  jump (B={B}, float32): scenarios that backtracked in the "
          f"first update: {back} of {B} (scenarios by rung: {hist}); ms "
          f"per MPC step {res['ms_per_mpc_step']:.2f} with the search")
    out["fleet"] = res
    seconds["fleet"] = time.perf_counter() - t0
    # (c) the kernels on the path's own arguments, both dtypes
    t0 = time.perf_counter()
    recs = {}
    for dtype, (g, s_, q_, v_, mk_) in ((f64_, (grid64, sol64, q64, v64,
                                                mk64)),
                                        (f32_, (grid, sol0, q0s, v0s, mk))):
        sv = mk_(True)
        calls = kernel_calls(lambda: sv.update(g, q_, v_, s_))
        n = {k: len(v) for k, v in calls.items()}
        check(n == {k: 1 if k == "K5" else 2 for k in n},
              f"jump update: kernel calls {n}")
        # K5 in float32 on the path's own LQR inputs is printed: the
        # switching-constrained Riccati's rounding floor there (C2); it is
        # gated on seeded inputs of the same shapes below
        errs = path_kernels("jump", calls, dtype,
                            shown=("K5",) if dtype == f32_ else ())
        out[f"kernel_errors {dtype}"] = errs
        Nh = calls["K5"][0][0].shape[1]
        l_in = lqr_inputs(12, dtype, dev, Nh)
        e5 = _compare("K5 jump seeded", bs.bwd(*l_in), bs.bwd_plain(*l_in),
                      dtype)
        if dtype != f32_:
            continue
        k6 = calls["K6"][0]          # the update's own build, B (N + 1)
        mo, cts, args = k6[0], k6[1], list(k6[2:])
        kernels.host_library("chain_flops")
        n_val, n_tan = chn.op_count(mo, cts, *[x.cpu() for x in args])
        got = chn.chain(mo, cts, *args)
        recs["K6 jump nofold"] = _record(
            "K6 chain jump no fold", "robotoc_tpu_torch/csrc/chain.cu",
            "robotoc_tpu/ops/pallas_chain.py:1110", errs["K6"][0],
            lambda: chn.chain(mo, cts, *args),
            lambda: chn.chain_plain(mo, cts, *args),
            bound(nbytes(*args[:-1]) + nbytes(*got.values()),
                  n_val + n_tan, dtype))
        outs = bs.bwd(*l_in)
        recs["K5 jump"] = _record(
            "K5 riccati_bwd jump", "robotoc_tpu_torch/csrc/riccati_bwd.cu",
            "robotoc_tpu/riccati/pallas_scan.py:146", e5,
            lambda: bs.bwd(*l_in), lambda: bs.bwd_plain(*l_in),
            bound(nbytes(*l_in) + nbytes(*outs),
                  B * Nh * flops_k5_step(36, 12, 12), dtype))
        print(f"  jump kernels: K6 on {args[0].shape[0]} stage slots (the "
              f"ladder's build {calls['K6'][1][2].shape[0]}), {n_val} + "
              f"{n_tan} operations; K5 timed on seeded inputs of the "
              f"path's {B} x {Nh} steps")
    seconds["kernels"] = time.perf_counter() - t0
    out["seconds"] = dict(seconds, phase=time.perf_counter() - t_phase)
    print("  jump seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in out["seconds"].items()))
    print("jump: " + json.dumps({k: v for k, v in out.items()
                                 if not k.startswith("kernel_errors")}))
    return launches, out, recs


class _TimedMPC:
    """An MPC whose `update_solution` calls are timed on the host clock
    (each returns its KKT as a float, so the card has finished) with each
    call's kernel launches recorded in `rec`; everything else is the
    MPC's."""

    def __init__(self, mpc, rec):
        self.mpc, self.rec = mpc, rec

    def update_solution(self, t, dt, q, v):
        before = read_counts()
        t0 = time.perf_counter()
        kkt = self.mpc.update_solution(t, dt, q, v)
        self.rec["update_s"].append(time.perf_counter() - t0)
        after = read_counts()
        self.rec["update_launches"].append(
            {k: after[k] - before[k] for k in after})
        return kkt

    def __getattr__(self, name):
        return getattr(self.mpc, name)


class _TimedPlant:
    """A plant whose `step` calls are timed on the host clock between two
    synchronisations of the card; everything else is the plant's."""

    def __init__(self, plant, rec):
        self.plant, self.rec = plant, rec

    def step(self, state, u, n_substeps=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.plant.step(state, u, n_substeps=n_substeps)
        torch.cuda.synchronize()
        self.rec["plant_s"].append(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self.plant, name)


def sim_run(p, ticks, timed=False, q0=None):
    """The closed loop of `p` (problems.anymal_trot_sim, its MPC planned by
    `init`) for `ticks` control ticks of SIM_DT from (q0 or p.q0, rest):
    sim.MPCSimulation with the feedback policy, the one-tick delay and one
    MPC update every SIM_STEPS ticks. With `timed`, each MPC update's
    seconds and kernel launches and each plant step's seconds are recorded
    (`_TimedMPC`, `_TimedPlant`). Returns (the log's arrays, the record
    with the run's seconds)."""
    rec = dict(update_s=[], update_launches=[], plant_s=[])
    mpc, plant = p.mpc, p.simulator
    if timed:
        mpc, plant = _TimedMPC(mpc, rec), _TimedPlant(plant, rec)
    t0 = time.perf_counter()
    log = MPCSimulation(plant).run(
        mpc, t0=0.0, q0=p.q0 if q0 is None else q0,
        simulation_time=ticks * SIM_DT, control_dt=SIM_DT,
        feedback_policy=True, feedback_delay=True,
        simulation_steps_per_mpc_update=SIM_STEPS)
    rec["seconds"] = time.perf_counter() - t0
    return log.as_arrays(), rec


def _log_gap(got, want, names=("q", "v", "u")):
    """Each log's largest difference over max(1, its largest magnitude)."""
    return {n: float(np.abs(got[n] - want[n]).max())
            / max(1.0, float(np.abs(want[n]).max())) for n in names}


def sim_problem(dev, use_kernels=True, init_iters=SIM_INIT):
    """The closed loop's problem (float64) with its MPC on the kernels or
    on the plain route, planned by `init` with `init_iters` updates."""
    p = problems.anymal_trot_sim(
        N=N, dtype=torch.float64, device=dev,
        options=OS.SolverOptions(switching_constraints=True,
                                 use_kernels=use_kernels))
    kkt0 = p.mpc.init(0.0, p.q0, p.v0, num_iters=init_iters)
    return p, kkt0


def phase_sim(dev):
    """The closed loop on the card (float64, one scenario): the ANYmal
    trot MPC (problems.anymal_trot_sim, N 20, the gait stack folded into
    K6) driven by sim.MPCSimulation against the penalty-ground plant
    (LeggedSimulator, sim_dt 2.5e-4, one CUDA graph of 10 substeps a tick):
    `init` with SIM_INIT updates (one launch of each kernel an update),
    then SIM_TIME s of SIM_DT ticks with the feedback policy, the one-tick
    delay and an MPC update every SIM_STEPS ticks. Gates: the bounds of
    tests/test_mpc_simulation.py (120 log rows; 0.30 < z < 0.65; |quat w|
    > 0.97; finite KKT, after the first 5 ticks at most 200 and a median
    under 10; finite u); 2 launches of each of the six kernels in every
    MPC update; each kernel against its plain version on the arguments of
    every call of one more closed-loop update (TOL); the first SIM_REPLAY
    ticks replayed with the MPC on the plain route from the same plan (the
    `init` iterate): q, v and u within SIM_TOL of max(1, |x|). Printed:
    ms per MPC update, plant ms per tick, ms per control tick. Returns
    (launches of the closed loop, result)."""
    f64 = torch.float64
    card = card_line()
    t_phase = time.perf_counter()
    out, seconds = {}, {}
    t0 = time.perf_counter()
    reset_counts()
    p, kkt0 = sim_problem(dev)
    init_launches = read_counts()
    check(init_launches == {k: SIM_INIT for k in init_launches},
          f"sim init: launches {init_launches}")
    check(np.isfinite(kkt0), f"sim init: KKT {kkt0}")
    planned = {k: getattr(p.mpc, k) for k in ("sol", "grid", "_costs",
                                              "lqr_policy")}
    seconds["init"] = time.perf_counter() - t0
    # the closed loop
    ticks = int(round(SIM_TIME / SIM_DT))
    n_upd = ticks // SIM_STEPS
    reset_counts()
    arr, rec = sim_run(p, ticks, timed=True)
    launches = read_counts()
    seconds["closed loop"] = rec["seconds"]
    check(len(rec["update_launches"]) == n_upd, "sim: "
          f"{len(rec['update_launches'])} MPC updates, expected {n_upd}")
    per_update = {k: 2 for k in launches}
    off = [(i, c) for i, c in enumerate(rec["update_launches"])
           if c != per_update]
    check(not off, f"sim: MPC updates with other launches than "
          f"{per_update}: {off[:3]}")
    check(launches == {k: 2 * n_upd for k in launches},
          f"sim: launches {launches}")
    z, w, kkt = arr["q"][:, 2], arr["q"][:, 6], arr["kkt"]
    check(arr["q"].shape[0] == ticks, f"sim: {arr['q'].shape[0]} log rows")
    check(bool(np.all(z > 0.30) and np.all(z < 0.65)),
          f"sim: base height out of (0.30, 0.65): {z.min():.4f}, "
          f"{z.max():.4f}")
    check(bool(np.all(np.abs(w) > 0.97)), f"sim: |quat w| down to "
          f"{np.abs(w).min():.4f}")
    check(bool(np.all(np.isfinite(kkt))), "sim: KKT not finite")
    check(float(kkt[5:].max()) < 200.0 and float(np.median(kkt[5:]))
          < 10.0, f"sim: KKT after 5 ticks max {kkt[5:].max():.3e}, "
          f"median {np.median(kkt[5:]):.3e}")
    check(bool(np.all(np.isfinite(arr["u"]))), "sim: u not finite")
    upd_ms = 1e3 * np.asarray(rec["update_s"])
    plant_ms = 1e3 * np.asarray(rec["plant_s"])
    res = dict(ticks=ticks, mpc_updates=n_upd, init_kkt=kkt0,
               z_range=[float(z.min()), float(z.max())],
               quat_w_min=float(np.abs(w).min()),
               kkt_max_after_5=float(kkt[5:].max()),
               kkt_median_after_5=float(np.median(kkt[5:])),
               launches=launches,
               ms_per_mpc_update=float(upd_ms.mean()),
               ms_per_mpc_update_median=float(np.median(upd_ms)),
               plant_ms_per_tick=float(plant_ms.mean()),
               plant_ms_per_tick_median=float(np.median(plant_ms)),
               plant_first_tick_ms=float(plant_ms[0]),
               ms_per_control_tick=1e3 * rec["seconds"] / ticks)
    print(f"  sim closed loop (B = 1, float64, N {N}, {ticks} ticks, "
          f"{n_upd} MPC updates): z {z.min():.4f}-{z.max():.4f}, |quat w| "
          f">= {np.abs(w).min():.5f}, KKT after 5 ticks max "
          f"{kkt[5:].max():.3e} median {np.median(kkt[5:]):.3e}; launches "
          f"{launches}; ms per MPC update {upd_ms.mean():.2f} (median "
          f"{np.median(upd_ms):.2f}), plant ms per tick {plant_ms.mean():.3f}"
          f" (median {np.median(plant_ms):.3f}, first tick with the graph's "
          f"capture {plant_ms[0]:.1f}), ms per control tick "
          f"{res['ms_per_control_tick']:.2f}; {card}")
    # the kernels on the calls of one more closed-loop update, from the
    # loop's last logged state at the next tick
    t0 = time.perf_counter()
    q_l, v_l = (torch.as_tensor(arr[k][-1], dtype=f64, device=dev)
                for k in ("q", "v"))
    calls = kernel_calls(lambda: p.mpc.update_solution(
        float(arr["t"][-1]) + SIM_DT, SIM_DT, q_l, v_l))
    n = {k: len(v) for k, v in calls.items()}
    check(n == {k: 2 for k in n}, f"sim update: kernel calls {n}")
    res["kernel_errors"] = path_kernels("sim", calls, f64)
    seconds["kernels"] = time.perf_counter() - t0
    # the first ticks replayed with the MPC on the plain route, from the
    # plan the kernel run's `init` made (its iterate, grid, costs and
    # policy; the plain MPC's own `init` without an update plans the same)
    t0 = time.perf_counter()
    reset_counts()
    pp, _ = sim_problem(dev, use_kernels=False, init_iters=0)
    for k, v in planned.items():
        setattr(pp.mpc, k, v)
    arr_p, _ = sim_run(pp, SIM_REPLAY)
    plain_launches = read_counts()
    check(all(v == 0 for v in plain_launches.values()),
          f"sim plain replay launched kernels: {plain_launches}")
    gap = _log_gap(arr_p, {k: v[:SIM_REPLAY] for k, v in arr.items()})
    check(max(gap.values()) <= SIM_TOL, f"sim: the plain replay of the "
          f"first {SIM_REPLAY} ticks off by {gap} (> {SIM_TOL:g})")
    res.update(replay_ticks=SIM_REPLAY, replay_gap=gap)
    seconds["plain replay"] = time.perf_counter() - t0
    print(f"  sim: the first {SIM_REPLAY} ticks through the plain route vs "
          f"the kernels, from the same plan: {gap} of max(1, |x|) "
          f"(tolerance {SIM_TOL:g})")
    out.update(res)
    out["seconds"] = dict(seconds, phase=time.perf_counter() - t_phase)
    print("  sim seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in out["seconds"].items()))
    print("sim: " + json.dumps({k: v for k, v in out.items()
                                if k != "kernel_errors"}))
    return launches, out


def bounce_problem(dev, use_kernels=True, max_iter=None):
    """The bounce (problems.anymal_bounce, one cycle, float64) with its
    solver's options (the KKT-residual search to KKT 1e-6) on this route
    and with this iteration cap (BOUNCE_ITERS when None)."""
    return problems.anymal_bounce(
        cycles=1, dtype=torch.float64, device=dev,
        options=OS.SolverOptions(max_iter=max_iter or BOUNCE_ITERS,
                                 kkt_tol=1e-6,
                                 enable_line_search="kkt",
                                 use_kernels=use_kernels))


def bounce_solve(p, q0=None):
    """`solve` of the bounce from its warm start at (q0 or p.q0, rest):
    (sol, stats, launches, seconds, KKT of the warm start)."""
    sv = p.solver
    q0 = p.q0 if q0 is None else q0
    sol0 = sv.init_solution(p.grid, q0, p.v0)
    kkt0 = float(sv.kkt_error(p.grid, q0, p.v0, sol0))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sol, st = sv.solve(p.grid, q0, p.v0, sol=sol0)
    torch.cuda.synchronize()
    return sol, st, read_counts(), time.perf_counter() - t0, kkt0


def _rel_gaps(got, want):
    """Each output's largest difference over its max-abs."""
    return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want) if w is not None]


def k5_readings(args, draws=2):
    """K5 (float64) on one call's LQR inputs, each reading the largest
    over the outputs of the difference over the output's max-abs: the
    kernel against its plain version on the card ("kernel"), the plain
    version on the host's CPU against the one on the card ("cpu plain"),
    the kernel against the host's ("kernel vs cpu"), the rounding floor:
    how far the plain version moves when every input moves by 1e-15 N(0,
    1) relative (seeded draws, "floor"), and a faulty kernel: the kernel's
    outputs rounded to float32 against the plain version ("float32
    outputs")."""
    want = bs.bwd_plain(*args)
    got = list(bs.bwd(*args))
    f32 = [None if x is None else x.float().double() for x in got]
    host = bs.bwd_plain(*[None if x is None else x.cpu() for x in args])
    host = [None if x is None else x.to(args[0].device) for x in host]
    gen = torch.Generator(args[0].device).manual_seed(0)
    floor = 0.0
    for _ in range(draws):
        moved = [x if x is None else x * (1 + 1e-15 * torch.randn(
            x.shape, generator=gen, dtype=x.dtype, device=x.device))
            for x in args]
        floor = max(floor, max(_rel_gaps(bs.bwd_plain(*moved), want)))
    return {"kernel": max(_rel_gaps(got, want)),
            "cpu plain": max(_rel_gaps(host, want)),
            "kernel vs cpu": max(_rel_gaps(got, host)), "floor": floor,
            "float32 outputs": max(_rel_gaps(f32, want))}


def phase_bounce(dev):
    """The ANYmal bounce (problems.anymal_bounce, one cycle, float64: N 35,
    two touchdown impacts, a configuration cost beside a task cost on the
    stacked periodic swing-foot and CoM references, which K6 does not fold;
    the KKT-residual search): the first BOUNCE_ITERS iterations of `solve`
    through the kernels and through the plain route. Gates: the iterates
    and the KKT histories of the two routes within BOUNCE_TOL of max(1,
    |x|); the KKT after them below the warm start's; each kernel's
    launches per iteration (K6, K1, Kc, K2, K3 two: the iteration's build
    and the search's trial build, one more for the warm start's; K5 one);
    each kernel against its plain version on the calls of one iteration
    (`update`: its build, the trial build of 9 scenarios, the Riccati
    sweep), TOL; K5 there within K5_BOUNCE_TOL of both the plain version on
    the card and the plain version on the host's CPU (`k5_readings`), a
    limit that its outputs rounded to float32 must exceed, and at TOL on
    seeded inputs of its shapes. Printed: the KKT history,
    seconds per iteration, K5's rounding floor on the iteration's inputs.
    Returns (launches of the kernel route, result)."""
    f64 = torch.float64
    card = card_line()
    t_phase = time.perf_counter()
    p = bounce_problem(dev)
    check(not chn.cost_fold_supported(p.model, p.costs, p.contacts),
          "bounce: its stack should not fold")
    sol_k, st_k, launches, secs_k, kkt0 = bounce_solve(p)
    sol_p, st_p, launches_p, secs_p, _ = bounce_solve(
        bounce_problem(dev, use_kernels=False))
    its = int(st_k["iterations"])
    check(its == int(st_p["iterations"]) == BOUNCE_ITERS,
          f"bounce: iterations {its}, {int(st_p['iterations'])}")
    want = {k: BOUNCE_ITERS if k == "K5" else 2 * BOUNCE_ITERS + 1
            for k in launches}
    check(launches == want, f"bounce: launches {launches}, expected {want}")
    check(all(v == 0 for v in launches_p.values()),
          f"bounce: the plain route launched kernels: {launches_p}")
    hist_k = st_k["kkt_history"][:its].cpu().numpy()
    hist_p = st_p["kkt_history"][:its].cpu().numpy()
    gaps = {"kkt_history": float(np.abs(hist_k - hist_p).max()
                                 / max(1.0, float(np.abs(hist_p).max())))}
    for f in dataclasses.fields(sol_p):
        a, b = getattr(sol_k, f.name), getattr(sol_p, f.name)
        gaps[f.name] = float((a - b).abs().max()) / max(
            1.0, float(b.abs().max()))
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= BOUNCE_TOL, f"bounce: kernels vs plain after "
          f"{its} iterations: {worst} off by {gaps[worst]:.3e} (> "
          f"{BOUNCE_TOL:g})")
    check(float(hist_k[-1]) < kkt0, f"bounce: KKT {hist_k[-1]:.3e} after "
          f"{its} iterations, {kkt0:.3e} at the warm start")
    # the kernels on the calls of one iteration, from the last iterate
    calls = kernel_calls(lambda: p.solver.update(p.grid, p.q0, p.v0, sol_k))
    n = {k: len(v) for k, v in calls.items()}
    check(n == {k: 1 if k == "K5" else 2 for k in n},
          f"bounce iteration: kernel calls {n}")
    errs = path_kernels("bounce", calls, f64, shown=("K5",))
    k5 = k5_readings(calls["K5"][0])
    check(k5["kernel"] <= K5_BOUNCE_TOL and k5["kernel vs cpu"]
          <= K5_BOUNCE_TOL, f"bounce: K5 on the iteration's own inputs "
          f"{k5} of max-abs, past {K5_BOUNCE_TOL:g}")
    check(k5["float32 outputs"] > K5_BOUNCE_TOL, f"bounce: K5's gate "
          f"{K5_BOUNCE_TOL:g} would pass its outputs rounded to float32 "
          f"({k5['float32 outputs']:.3e})")
    l_in = lqr_inputs(0, f64, dev, calls["K5"][0][0].shape[1])
    errs["K5 seeded"] = [_compare("K5 bounce seeded", bs.bwd(*l_in),
                                  bs.bwd_plain(*l_in), f64)]
    print("  bounce: K5 on the iteration's own inputs, of max-abs: "
          + ", ".join(f"{k} {v:.3e}" for k, v in k5.items())
          + f" (gate {K5_BOUNCE_TOL:g} on the kernel against both plain "
          "versions)")
    out = dict(N=p.N, slots=p.grid.n_slots, iterations=its,
               warm_start_kkt=kkt0, kkt_history=hist_k.tolist(),
               kkt_history_plain=hist_p.tolist(), gaps=gaps,
               launches=launches,
               launches_per_iteration={k: (v - (k != "K5")) / its
                                       for k, v in launches.items()},
               s_per_iteration=secs_k / its,
               s_per_iteration_plain=secs_p / its,
               k5_readings=k5, kernel_errors=errs)
    out["seconds"] = dict(kernels=secs_k, plain=secs_p,
                          phase=time.perf_counter() - t_phase)
    print(f"  bounce (N {p.N}, {p.grid.n_slots} slots, float64, KKT "
          f"search): KKT {kkt0:.3e} at the warm start, then "
          + ", ".join(f"{k:.3e}" for k in hist_k)
          + f"; kernels vs plain {gaps[worst]:.3e} ({worst}); launches "
          f"{launches}; s per iteration {secs_k / its:.2f} (plain "
          f"{secs_p / its:.2f}); {card}")
    print("bounce: " + json.dumps({k: v for k, v in out.items()
                                   if k != "kernel_errors"}))
    return launches, out


def phase_bounce_full():
    """Not a default phase: the single-cycle bounce solved through the
    kernels to KKT < 1e-6 within BOUNCE_FULL_ITERS iterations, the gate of
    tests/test_offline_gaits.py (the JAX package's own solve of
    examples/anymal_bounce.py: 131 iterations, KKT 8.741e-07)."""
    p = bounce_problem(torch.device("cuda"), max_iter=BOUNCE_FULL_ITERS)
    sol, st, launches, secs, kkt0 = bounce_solve(p)
    its, kkt = int(st["iterations"]), float(st["kkt_error"])
    hist = st["kkt_history"][:its].cpu().numpy()
    print(f"  bounce_full: convergence {bool(st['convergence'])}, {its} "
          f"iterations, KKT {kkt:.4e}, {secs:.1f} s ({secs / its:.2f} s an "
          f"iteration); warm start KKT {kkt0:.3e}; launches {launches}; "
          f"KKT history " + ", ".join(f"{k:.3e}" for k in hist)
          + f"; {card_line()}")
    check(bool(st["convergence"]) and kkt < 1e-6 and its <= BOUNCE_FULL_ITERS,
          f"bounce_full: convergence {bool(st['convergence'])}, KKT "
          f"{kkt:.3e} after {its} iterations")
    return dict(iterations=its, kkt=kkt, seconds=secs,
                kkt_history=hist.tolist())


def phase_floors(dev):
    """Not a default phase: the readings behind the sim and bounce gates.
    (a) Each path run twice through the kernels, the second time from an
    initial configuration moved by 1e-15 (the base height); printed, each
    log's (sim: the first SIM_REPLAY ticks' q, v, u) or each field's and
    the KKT history's (bounce: BOUNCE_ITERS iterations) difference over
    max(1, |x|). (b) K5 on the LQR inputs of every one of those bounce
    iterations (`k5_readings`, four draws for the floor). (c) The plant's
    tick (10 substeps) op by op and as the captured CUDA graph, from the
    closed loop's state after SIM_REPLAY ticks: ms per tick, each the
    median of five."""
    out = {}
    p, _ = sim_problem(dev)
    a0, _ = sim_run(p, SIM_REPLAY)
    p1, _ = sim_problem(dev)
    q1 = p1.q0.clone()
    q1[2] += 1e-15
    p1.mpc.init(0.0, q1, p1.v0, num_iters=SIM_INIT)
    a1, _ = sim_run(p1, SIM_REPLAY, q0=q1)
    out["sim"] = _log_gap(a1, a0)
    b = bounce_problem(dev)
    qb = b.q0.clone()
    qb[2] += 1e-15
    s0, st0 = bounce_solve(b)[:2]
    s1, st1 = bounce_solve(b, q0=qb)[:2]
    gaps = {f.name: float((getattr(s1, f.name) - getattr(s0, f.name))
                          .abs().max()) / max(1.0, float(
                              getattr(s0, f.name).abs().max()))
            for f in dataclasses.fields(s0)}
    h0, h1 = (st["kkt_history"][:BOUNCE_ITERS].cpu().numpy()
              for st in (st0, st1))
    gaps["kkt_history"] = float(np.abs(h1 - h0).max()) / max(
        1.0, float(np.abs(h0).max()))
    out["bounce"] = gaps
    print(f"floors: the initial configuration moved by 1e-15 moves the "
          f"sim's first {SIM_REPLAY} ticks by {out['sim']} and the "
          f"bounce's {BOUNCE_ITERS} iterations by {gaps} (of max(1, |x|)); "
          f"{card_line()}")
    # (b) K5 at every iterate of the bounce's kernel route
    rows = []
    sol = b.solver.init_solution(b.grid, b.q0, b.v0)
    for i in range(BOUNCE_ITERS):
        upd = {}
        calls = kernel_calls(lambda: upd.update(step=b.solver.update(
            b.grid, b.q0, b.v0, sol)))
        args = calls["K5"][0]
        rows.append(k5_readings(args, draws=4))
        sol = upd["step"][0]
        print(f"  K5 bounce iteration {i}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rows[-1].items()))
    out["k5_bounce"] = {k: max(r[k] for r in rows) for k in rows[0]}
    out["k5_bounce_min"] = {k: min(r[k] for r in rows) for k in rows[0]}
    # (c) the plant: op by op and replayed as a CUDA graph
    pl = p.simulator
    n_sub = int(round(SIM_DT / pl.sim_dt))
    state = pl.init(a0["q"][-1], a0["v"][-1], float(a0["t"][-1]))
    u = torch.as_tensor(a0["u"][-1], dtype=torch.float64, device=dev)
    times = {}
    for name, fn in (("ops", lambda: pl._substeps(state, u, n_sub)),
                     ("graph", lambda: pl.step(state, u, n_sub))):
        fn()
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        times[name] = float(np.median(ts))
    out["plant_ms_per_tick"] = times
    print(f"floors: K5 on the bounce's iterations, largest (smallest) of "
          f"each reading: " + ", ".join(
              f"{k} {v:.3e} ({out['k5_bounce_min'][k]:.3e})"
              for k, v in out["k5_bounce"].items())
          + f"; the plant's tick ({n_sub} substeps) op by op "
          f"{times['ops']:.2f} ms, as a CUDA graph {times['graph']:.2f} ms; "
          f"{card_line()}")
    print("floors: " + json.dumps(out))
    return out


def _summary(out):
    """Each kernel's device time (ms) and ms per MPC step from one run's
    output, and the kernels phase's kernel-vs-plain max abs errors
    ("<name> float32 err", "<name> float64 err")."""
    row = {}
    for line in out.splitlines():
        if line.startswith('{"kernels"'):
            for r in json.loads(line)["kernels"]:
                row[r["name"]] = r["ms"]
        for tag in ("slice", "trot", "walk", "crawl", "pace",
                    "flying_trot"):
            if line.startswith(tag + ": {"):
                row[tag + " ms/step"] = json.loads(
                    line[len(tag) + 2:])["ms_per_mpc_step"]
        if line.startswith("seconds by phase: "):
            for part in line[len("seconds by phase: "):].split(", "):
                name, secs = part.rsplit(" ", 1)
                row[f"seconds {name}"] = float(secs)
        if line.startswith("total ") and line.endswith(" s"):
            row["seconds total"] = float(line.split()[1])
        m = re.match(r"  (\S.*?)\s+torch\.(float\d\d)\s+max_abs_err (\S+)",
                     line)
        if m:
            row[f"{m.group(1)} {m.group(2)} err"] = float(m.group(3))
    return row


def pair(other, phases, out_dir, runs=4):
    """Run `phases` of this script on the package of the tree at `other`
    and on this tree's in turns (other, this, this, other; with runs = 2,
    other, this) on this card, each in its own process, so that both are
    measured the same way; phases ["all"] runs each tree's own script with
    its own default phases instead (`python3 chip_smoke.py` in each tree:
    the two scripts' totals compared).
    Each run's output goes to <out_dir>/pair_<i>.txt. Prints the kernels'
    device times, ms per MPC step and seconds by phase of each run;
    returns non-zero if a run failed."""
    os.makedirs(out_dir, exist_ok=True)
    rc = 0
    rows = []
    order = (other, ROOT, ROOT, other) if runs == 4 else (other, ROOT)
    for i, tree in enumerate(order):
        if list(phases) == ["all"]:
            cmd = [sys.executable, "chip_smoke.py"]
        else:
            cmd = [sys.executable, "-c", (
                f"import runpy, sys; sys.path[:0] = [{tree!r}]; "
                f"g = runpy.run_path({os.path.abspath(__file__)!r}); "
                f"sys.exit(g['main'](phases={tuple(phases)!r}))")]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
        with open(os.path.join(out_dir, f"pair_{i}.txt"), "w") as fh:
            fh.write(run.stdout + run.stderr)
        tag = "parent" if tree == other else "change"
        rows.append(_summary(run.stdout))
        print(f"pair run {i} ({tag}, {tree}): rc {run.returncode}, "
              f"{time.perf_counter() - t0:.1f} s: " + json.dumps(rows[-1]),
              flush=True)
        rc = rc or run.returncode
    # each number beside the other tree's: runs 0, 3 (other) / 1, 2 (this)
    mine, theirs = ((1, 2), (0, 3)) if runs == 4 else ((1,), (0,))
    print(f"pair, other (runs {theirs}) / this (runs {mine}):")
    for key in sorted(set().union(*rows)):
        vals = [r.get(key) for r in rows]
        fmt = [f"{v:.4g}" if v is not None else "-" for v in vals]
        print(f"  {key:40s} " + ", ".join(fmt[i] for i in theirs) + " / "
              + ", ".join(fmt[i] for i in mine))
    return rc


def main(phases=ALL_PHASES):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seconds = {}
    lap = [t0]

    def done(phase):
        """The seconds since the last phase ended."""
        now = time.perf_counter()
        seconds[phase] = now - lap[0]
        lap[0] = now

    if "build" in phases:
        phase_build()
        done("build")
    recs = phase_kernels(dev) if "kernels" in phases else {}
    done("kernels")

    def note(launches, pairs, run):
        """Each record's launches: its kernel's count over the run named,
        counted from 0 just before it."""
        for key, name in pairs:
            if key in recs:
                recs[key].update(launches=launches[name], launches_of=run)

    note({"K6": 0}, (("K6 nv35", "K6"), ("K6 nv35 nofold", "K6")),
         "no path runs it")
    step = f"one MPC step (2 updates) of the B = {B} float32 fleet"
    if "slice" in phases:
        launches, _, _ = phase_slice(dev)
        note(launches, (("K5 nf0", "K5"), ("K6 nofold", "K6")),
             "standing: " + step)
        done("slice")
    if "trot" in phases:
        launches, _ = phase_trot(dev)
        note(launches, [(k, k) for k in COUNTERS], "trot: " + step)
        done("trot")
    if "readings" in phases:
        phase_readings(dev)
        done("readings")
    if "golden" in phases:
        phase_golden(dev)
        done("golden")
    if "walk" in phases:
        launches, out = phase_walk(dev)
        note(launches, (("K6s", "K6"), ("Kc34", "Kc"), ("K1w", "K1"),
                        ("K2w", "K2"), ("K3w", "K3")), "walk: " + step)
        note(out["biped_standing_launches"], (("K6s nofold", "K6"),),
             "biped standing OCP (N 4, one scenario, float64): 12 updates")
        done("walk")
    if "solve" in phases:
        phase_solve(dev, readings="readings" in phases)
        done("solve")
    if "unconstr" in phases:
        phase_unconstr(dev)
        done("unconstr")
    if "gaits" in phases:
        out = phase_gaits(dev)
        note(out["crawl"]["launches"], (("K6 a1 nofold", "K6"),),
             "a1 crawl: " + step)
        note(out["flying_trot"]["launches"], (("K1ft", "K1"), ("Kcft", "Kc")),
             "flying trot: " + step)
        done("gaits")
    if "jump" in phases:
        launches, _, jrecs = phase_jump(dev)
        recs.update(jrecs)
        note(launches, (("K6 jump nofold", "K6"), ("K5 jump", "K5")),
             "jump: " + step + " with the KKT search (each update builds "
             "twice: its own build and the ladder's of 9 B scenarios)")
        done("jump")

    def note_path(launches, pairs, run):
        """Each record's launches on a later path, beside its own: its
        kernel's count over the run named, counted from 0 just before."""
        for key, name in pairs:
            if key in recs:
                recs[key].setdefault("launches_by_path", {})[run] = \
                    launches[name]

    if "sim" in phases:
        launches, _ = phase_sim(dev)
        note_path(launches, [(k, k) for k in ("K1", "Kc", "K2", "K3", "K5",
                                              "K6")],
                  "sim: the closed loop's 60 MPC updates (B = 1, float64)")
        done("sim")
    if "bounce" in phases:
        launches, _ = phase_bounce(dev)
        note_path(launches, [(k, k[:2]) for k in ("K1", "Kc", "K2", "K3")]
                  + [("K5 nf0", "K5"), ("K6 nofold", "K6")],
                  f"bounce: {BOUNCE_ITERS} solve iterations (B = 1, "
                  "float64)")
        done("bounce")
    if "bounce_full" in phases:
        phase_bounce_full()
        done("bounce_full")
    if "floors" in phases:
        phase_floors(dev)
        done("floors")
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in seconds.items()))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(recs.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # python3 chip_smoke.py --pair <tree> <phase,...> <out_dir> [runs]:
    # that tree and this one in turns on one card (see `pair`)
    if len(sys.argv) in (5, 6) and sys.argv[1] == "--pair":
        sys.exit(pair(os.path.abspath(sys.argv[2]), sys.argv[3].split(","),
                      os.path.abspath(sys.argv[4]),
                      runs=int(sys.argv[5]) if len(sys.argv) == 6 else 4))
    sys.exit(main())

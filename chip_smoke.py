"""Smoke run of the PyTorch/CUDA port (robotoc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  0. require a CUDA device; print the card's name and power limit and the
     TF32 switches (both off: reduced-precision products stall Newton);
  1. build the hand-written CUDA kernels from csrc/ with nvcc, one process
     per source, all at once;
  2. hold every kernel against its plain PyTorch version on the card, in
     float64 and float32: condense K1, Kc, K2, K3 on the stage slots of the
     trot fleet; the Riccati backward sweep K5 without switching rows
     (standing shapes) and with them (trot shapes); the chain kernel K6
     without the cost fold at the standing shapes and with it at the trot
     shapes; on the stage slots of the iCub walk fleet, K6's surface-contact
     instance without and with the cost fold and the 34-row Kc (also on
     seeded dense cone rows of the same shapes). Time kernel,
     plain version and library call (float32); count K6's operations on the
     host (csrc/chain_flops.cpp, g++) for its bound;
  3. "slice": the ANYmal standing contact OCP (T 0.5, N 20), B = 128
     scenarios with perturbed initial configurations, float32, two updates
     per MPC step through OCPSolver.update with the kernels (K6 without the
     cost fold); launch counts, finite KKT, agreement with the plain
     versions, time per MPC step;
  4. "trot": the main path, the mid-gait ANYmal trot MPC update (T 0.5,
     N 20, 4 impact slots, switching constraints, the gait cost stack
     folded into K6), B = 128, float32, two updates per MPC step; launch
     counts of all six kernels, finite KKT, agreement with the plain
     versions, time per MPC step, host time by part and the device idle
     share; then float64, one unperturbed scenario, 15 updates through the
     kernels, ending at KKT < 1e-3;
  5. "golden": float64, one standing scenario, 16 updates through the
     kernels: reproduce tests/golden/anymal_standing_ocp.npz to 1e-6 with
     KKT below 1e-6;
  6. "walk": the iCub lower half on two surface contacts. The standing OCP
     (N 4) in float64, 12 updates through the kernels to KKT < 1e-6; the
     biped-walk MPC (T 0.7, N 25, 3 impact slots, switching constraints,
     the gait cost stack folded into K6's surface instance, 34 cone rows
     through Kc) warmed in float64 at B = 1 the way the MPC runs (standing
     init, closed-loop updates to mid-gait t = 0.62), then B = 128 float32
     scenarios with perturbed initial states, two updates per MPC step:
     launch counts, finite KKT, agreement with the plain versions (in
     float64 gated; in float32 reported, and the kernel step's drift from
     the float64 step gated against the plain float32 steps', then shown
     with one kernel at a time swapped for its plain version), time per
     MPC step, host time by part and the device idle share;
  7. print the kernels' JSON line, the card line and the final status line.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from robotoc_tpu_torch import convert, kernels, problems
from robotoc_tpu_torch.models import contacts as ct
from robotoc_tpu_torch.models import robot as rm
from robotoc_tpu_torch.ops import chain as chn
from robotoc_tpu_torch.ops import condense as cd
from robotoc_tpu_torch.riccati import backward_sweep as bs
from robotoc_tpu_torch.solver import ocp_solver as OS

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "anymal_standing_ocp.npz")
B, N = 128, 20
# H100 SXM: HBM3 rate and the non-tensor-core peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# kernel vs plain version, relative to each output's largest magnitude
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
ALL_PHASES = ("build", "kernels", "slice", "trot", "golden", "walk")
# the walk's closed-loop warm start: control step (the JAX package's bench
# takes 0.005 s; 0.02 s reaches mid-gait in a quarter of the updates)
WALK_N, WALK_T, WALK_DT = 25, 0.62, 0.02
FIELDS = ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu", "s_lim",
          "z_lim", "s_cone", "z_cone")


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


def host_ms(fn, reps=5):
    """Median wall time of `fn` ending in a device synchronise."""
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
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
            if "registers" in line or "spill" in line:
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


def _record(name, source, replaces, err, ms, plain_ms, b, library_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b[0], bound_by=b[1], library_ms=library_ms)


def _op_counts(pool, model, contacts, args, cost, as_written=False,
               chunk=256):
    """K6's operation count (ops/chain.op_count) of these stages, in chunks
    on the host thread pool (ctypes releases the GIL; the count adds over
    stages). Returns a function that waits for (value, tangent)."""
    ins = [x.cpu() for x in list(args) + list(cost)]
    parts = [pool.submit(chn.op_count, model, contacts,
                         *[x[i:i + chunk] for x in ins],
                         as_written=as_written)
             for i in range(0, ins[0].shape[0], chunk)]
    return lambda: tuple(map(sum, zip(*[f.result() for f in parts])))


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
    xw = [prew[k].contiguous() for k in ("dgdq", "dgdf", "d_cone")]
    # the walk's wrench cones act on the local wrench, so its dgdq rows
    # are zero; seeded dense rows at the same shapes reach every block of
    # the 34-row Kc
    rng = np.random.default_rng(5)
    xr = [torch.as_tensor(rng.standard_normal(tuple(t.shape)),
                          dtype=torch.float64, device=dev) for t in xw]
    xr[2] = xr[2].exp()
    Nt = grid64.dt.shape[1]
    recs, extra = {}, {}
    # K6's cases: point contacts without the cost fold (standing) and with
    # it (trot); surface contacts without it (the biped standing stack)
    # and with it (walk), both on the walk fleet's stage slots
    k6_cases = {
        "point": (ps.model, ps.contacts, (ps.cost,), sol_s, grid_s, False),
        "point fold": (p64.model, p64.mpc.contacts, p64.costs, sol64,
                       grid64, True),
        "surface": (pw.model, pw.mpc.contacts, pw.costs, solw, gridw,
                    False),
        "surface fold": (pw.model, pw.mpc.contacts, pw.costs, solw, gridw,
                         True)}
    # K6's operation counts, on the host beside the card's work: (value,
    # tangent) operations over all stages and, on the trot, the arithmetic
    # the kernel as written does
    kernels.host_library("chain_flops")
    pool = ThreadPoolExecutor(6)
    k6_ops = {}
    for key, (mo, cts, costs, sb, gb, wc) in k6_cases.items():
        args, cost = chain_args(mo, cts, costs, sb, gb, wc)
        k6_ops[key] = _op_counts(pool, mo, cts, args, cost)
        if key == "point fold":
            k6_written = _op_counts(pool, mo, cts, args, cost,
                                    as_written=True)
    pool.shutdown(wait=False)
    for dtype in (torch.float64, torch.float32):
        x = {k: v.to(dtype) for k, v in x64.items()}
        k1_in = [x[n] for n in ("M", "J", "inactive", "Tw1", "Tw2", "r1",
                                "e2")]
        p1 = cd.k1_plain(*k1_in)
        e1 = _compare("K1", cd.k1(*k1_in), p1, dtype)
        kc_in = [x["dgdq"], x["dgdf"], x["d_cone"]]
        pc = cd.kc_plain(*kc_in)
        ec = _compare("Kc", cd.kc(*kc_in), pc, dtype)
        kcw_in = [t.to(dtype) for t in xw]
        ecw = _compare("Kc 34", cd.kc(*kcw_in), cd.kc_plain(*kcw_in), dtype)
        kcr_in = [t.to(dtype) for t in xr]
        _compare("Kc 34 seed", cd.kc(*kcr_in), cd.kc_plain(*kcr_in), dtype)
        d = torch.diag_embed
        k2_in = [p1[3], p1[4], x["Wq"] + d(x["Hq_d"]) + pc[0],
                 x["Wv"] + d(x["Hv_d"]), x["Wu"] + d(x["Hu_d"]),
                 x["Wa"] + d(x["Ha_d"]), x["Wf"] + pc[2], pc[1], x["gw"],
                 x["gy"]]
        k2_in = [t.contiguous() for t in k2_in]
        p2 = cd.k2_plain(*k2_in)
        e2 = _compare("K2", cd.k2(*k2_in), p2, dtype)
        k3_in = [p1[3], p1[4], p2[3].contiguous()] + [
            x[n] for n in ("Aqq", "Aqv", "xres_q", "Fv_res", "sA", "lam2",
                           "lmdgmm")]
        e3 = _compare("K3", cd.k3(*k3_in), cd.k3_plain(*k3_in), dtype)
        l0 = lqr_inputs(0, dtype, dev, N)
        e50 = _compare("K5 nf=0", bs.bwd(*l0), bs.bwd_plain(*l0), dtype)
        l12 = lqr_inputs(12, dtype, dev, Nt)
        e512 = _compare("K5 nf=12", bs.bwd(*l12), bs.bwd_plain(*l12), dtype)
        k6 = {}
        for key, (mo, cts, costs, sb, gb, wc) in k6_cases.items():
            args, cost = chain_args(mo, cts, costs, sb, gb, wc)
            args = [a.to(dtype) for a in args]
            cost = [c.to(dtype).contiguous() for c in cost]
            model = convert.astype(mo, dtype)
            contacts = convert.astype(cts, dtype)
            names = chn._OUTS + (chn._COST_OUTS if wc else ())
            got = chn.chain(model, contacts, *args, *cost)
            want = chn.chain_plain(model, contacts, *args, *cost)
            err = _compare(f"K6 {key}", [got[n] for n in names],
                           [want[n] for n in names], dtype)
            k6[key] = (model, contacts, args, cost, got, err)
        if dtype != torch.float32:
            continue
        S, Sw = x["M"].shape[0], xw[0].shape[0]
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
            ("K3", "K3 condense_k3", cd.k3, cd.k3_plain, k3_in, e3,
             S * flops_k3(nv, nu), None,
             "robotoc_tpu/ops/pallas_condense.py:399"),
        ]
        for key, name, kern, plain, args, err, flops, lib, repl in specs:
            outs = kern(*args)
            recs[key] = _record(
                name, "robotoc_tpu_torch/csrc/condense.cu", repl, err,
                cuda_ms(lambda: kern(*args)),
                cuda_ms(lambda: plain(*args), reps=5),
                bound(nbytes(*args) + nbytes(*outs), flops, dtype),
                cuda_ms(lib) if lib is not None else None)
        # K5: the main path's switching branch at the trot shapes; the
        # nf = 0 branch (standing path) beside it
        for nf, l_in, err, Nh in ((12, l12, e512, Nt), (0, l0, e50, N)):
            outs = bs.bwd(*l_in)
            rec = _record(
                "K5 riccati_bwd", "robotoc_tpu_torch/csrc/riccati_bwd.cu",
                "robotoc_tpu/riccati/pallas_scan.py:146", err,
                cuda_ms(lambda: bs.bwd(*l_in)),
                cuda_ms(lambda: bs.bwd_plain(*l_in), reps=5),
                bound(nbytes(*l_in) + nbytes(*outs),
                      B * Nh * flops_k5_step(36, 12, nf), dtype), None)
            if nf:
                recs["K5"] = rec
            else:
                extra["K5 nf=0 (standing, N=20)"] = rec
        for key in ("point fold", "point", "surface fold", "surface"):
            model, contacts, args, cost, got, err = k6[key]
            n_val, n_tan = k6_ops[key]()
            print(f"  K6 {key}: {args[0].shape[0]} stages, {n_val} value + "
                  f"{n_tan} tangent operations (csrc/chain_flops.cpp)")
            if key == "point fold":
                w_val, w_tan = k6_written()
                ratio = (w_val + w_tan) / (n_val + n_tan)
                print(f"  K6 point fold as written: {w_val} value + {w_tan} "
                      f"tangent operations, {ratio:.1f} x the function's")
            # R_ref (the last input) is read only by the surface branch
            read = (args if chn.contact_type(contacts) == ct.SURFACE
                    else args[:-1])
            rec = _record(
                "K6 chain" + (" surface" if "surface" in key else ""),
                "robotoc_tpu_torch/csrc/chain.cu",
                "robotoc_tpu/ops/pallas_chain.py:1110", err,
                cuda_ms(lambda: chn.chain(model, contacts, *args, *cost)),
                cuda_ms(lambda: chn.chain_plain(model, contacts, *args,
                                                *cost), reps=3, warmup=1),
                bound(nbytes(*read, *cost) + nbytes(*got.values()),
                      n_val + n_tan, dtype), None)
            if key == "point fold":
                recs["K6"] = rec
            elif key == "surface fold":
                recs["K6s"] = rec
            elif key == "point":
                extra["K6 cost=0 (standing, 2560 stages)"] = rec
            else:
                extra["K6 surface cost=0 (walk stages, 3584)"] = rec
    for r in list(recs.values()) + list(extra.values()):
        print(f"  {r['name']:24s} {r['ms']:.4f} ms  plain {r['plain_ms']:.3f}"
              f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              f"  library {r['library_ms']}")
    print("kernels_extra: " + json.dumps(extra))
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
    directions). Returns the gates missed (empty when all hold)."""
    (sol_k, kkt_k), (sol_p, kkt_p) = out_k, out_p
    fails = []
    for i, (a, b) in enumerate(zip(kkt_k, kkt_p)):
        rel = float(((a - b).abs() / b.abs()).max())
        if not rel <= 1e-3:
            fails.append(f"update {i}: KKT kernel vs plain rel {rel:.2e}")
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
    return fails


def _agree_f64(tag, mk, grid, sol0, q0s, v0s, tol=1e-8):
    """One MPC step through the kernels against the plain versions in
    float64: the KKT and every field to tol relative to the field's
    largest magnitude. Returns the worst ratios."""
    (sol_k, kkt_k), (sol_p, kkt_p) = (_mpc_step(mk(k), grid, sol0, q0s, v0s)
                                      for k in (True, False))
    worst = {f"kkt{i}": float(((a - b).abs() / b.abs()).max())
             for i, (a, b) in enumerate(zip(kkt_k, kkt_p))}
    for name in FIELDS:
        xk, xp = getattr(sol_k, name), getattr(sol_p, name)
        worst[name] = float((xk - xp).abs().max()) / max(
            float(xp.abs().max()), 1e-30)
    print(f"  {tag} float64: kernel vs plain, error / max-abs: "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    check(all(v <= tol for v in worst.values()),
          f"{tag} float64: kernel vs plain past {tol:.0e}: {worst}")
    return worst, sol_p


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


def _drift(name, sol, sol0, sol_64):
    """Field `name` of `sol` against the float64 step `sol_64` from sol0,
    relative to the largest change that step made to it."""
    ref = getattr(sol_64, name)
    step = max(float((ref - getattr(sol0, name)).abs().max()), 1e-30)
    return float((getattr(sol, name).double() - ref).abs().max()) / step


def _drift_by_kernel(tag, step, sol0, sol_64):
    """The float32 kernel step (`step()`) with one kernel at a time replaced
    by its plain version, where its caller looks it up: each field's drift
    from the float64 step. A single swap that brings a field's drift down
    to the plain step's points at that kernel's float32 rounding; several
    such swaps point at the step's sensitivity to any rounding change.
    Returns {kernel: {field: drift}}."""
    swaps = {"K1": (cd, "k1", cd.k1_plain), "Kc": (cd, "kc", cd.kc_plain),
             "K2": (cd, "k2", cd.k2_plain), "K3": (cd, "k3", cd.k3_plain),
             "K5": (bs, "bwd", bs.bwd_plain),
             "K6": (chn, "chain", chn.chain_plain)}
    out = {}
    for key, (mod, name, plain) in swaps.items():
        kern = getattr(mod, name)
        setattr(mod, name, plain)
        try:
            sol = step()
        finally:
            setattr(mod, name, kern)
        out[key] = {n: _drift(n, sol, sol0, sol_64) for n in FIELDS}
        print(f"  {tag} float32 drift with {key} plain: "
              + ", ".join(f"{n} {v:.1e}" for n, v in out[key].items()))
    return out


def _f32_drift(tag, sol0, steps, sol_64, factor=10.0):
    """float32 steps against the plain float64 step from the same iterate,
    each field relative to the largest change the float64 step made.
    `steps` holds the kernel step ("kernel"), the plain step ("plain") and
    the plain step from the iterate jittered by `_jittered` ("plain
    jittered"): the two plain ones show how far float32 rounding alone
    moves the step. A kernel step that drifts past `factor` times the
    larger of them is a fault in a kernel's float32 arithmetic: raises.
    Returns {field: {step: drift}}."""
    rows = {n: {k: _drift(n, s, sol0, sol_64) for k, s in steps.items()}
            for n in FIELDS}
    print(f"  {tag} float32 drift from the float64 step / its change ("
          + ", ".join(steps) + "): "
          + ", ".join(f"{n} " + " ".join(f"{v:.1e}" for v in r.values())
                      for n, r in rows.items()))
    bad = {n: r for n, r in rows.items()
           if r["kernel"] > factor * max(r["plain"], r["plain jittered"])}
    check(not bad, f"{tag}: the float32 kernel step drifts past {factor} x "
          f"the plain float32 steps' drift: {bad}")
    return rows


def _run_path(tag, mk, grid, sol0, q0s, v0s, parts_fn, strict=True):
    """Drive one path: warm-up, counts reset, one MPC step through the
    kernels, counts read; the same step on the plain versions; timings.
    With strict False a missed float32 agreement gate is returned in the
    result ("f32_gates_missed") for the caller to settle. Returns the
    launch counts, the result and the two steps' (sol, kkts)."""
    s_kern, s_plain = mk(True), mk(False)
    _mpc_step(s_kern, grid, sol0, q0s, v0s)            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out_k = _mpc_step(s_kern, grid, sol0, q0s, v0s)    # the path
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  {tag}: launches in one MPC step (2 updates): {launches}")
    check(all(v == 2 for v in launches.values()),
          f"{tag}: expected 1 launch of each kernel per update: {launches}")
    for i, kkt in enumerate(out_k[1]):
        check(bool(torch.isfinite(kkt).all()), f"{tag} update {i}: KKT not "
              "finite")
    out_p = _mpc_step(s_plain, grid, sol0, q0s, v0s)
    fails = _agree(tag, sol0, out_k, out_p)
    check(not (strict and fails), f"{tag}: " + "; ".join(fails))
    print(f"  {tag}: fleet KKT after the step: max "
          f"{float(out_k[1][-1].max()):.4e}")
    step_ms = host_ms(lambda: _mpc_step(s_kern, grid, sol0, q0s, v0s))
    step_plain_ms = host_ms(lambda: _mpc_step(s_plain, grid, sol0, q0s,
                                              v0s))
    parts = parts_fn()
    dev_ms, top = device_time(lambda: s_kern.update(grid, q0s, v0s, sol0))
    out = dict(B=B, N=s_kern.N, dtype="float32", ms_per_mpc_step=step_ms,
               mpc_updates_per_s=B / (step_ms * 1e-3),
               plain_ms_per_mpc_step=step_plain_ms,
               ms_per_update_parts=parts, device_ms_per_update=dev_ms,
               device_idle_share=(None if dev_ms is None
                                  else 1.0 - dev_ms / (step_ms / 2)),
               top_device_kernels_ms=top,
               fleet_max_kkt=float(out_k[1][-1].max()),
               f32_gates_missed=fails)
    print(f"  {tag}: ms per MPC step (2 updates, B={B}): {step_ms:.2f} with "
          f"the kernels, {step_plain_ms:.2f} with the plain versions; "
          f"{out['mpc_updates_per_s']:.1f} MPC updates/s")
    print(f"  {tag}: one update, by part (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(f"  {tag}: device time per update {dev_ms} ms (profiler), idle "
          f"share {out['device_idle_share']}; top kernels {top}")
    print(f"{tag}: " + json.dumps(out))
    return launches, out, (out_k, out_p)


def _parts(model, contacts, limits, costs, sol_b, grid_b, q_b, v_b,
           n_imp, enable_sw, with_cost):
    """Host time of the synchronised parts of one update (kernels on)."""
    args, cost = chain_args(model, contacts, costs, sol_b, grid_b,
                            with_cost)
    pre = OS.stage_pre_all(model, contacts, limits, 1e-3, costs, sol_b,
                           grid_b, n_imp=n_imp, use_chain=True)
    kin = {k: v for k, v in pre.items() if not k.startswith("aux_")}
    kw = dict(n_imp=n_imp, enable_sw=enable_sw, use_chain=True)
    built = OS._build(model, contacts, limits, 1e-3, costs, sol_b, grid_b,
                      q_b, v_b, **kw)
    return {
        "chain_K6": host_ms(lambda: chn.chain(model, contacts, *args,
                                              *cost)),
        "stage_pre_all": host_ms(lambda: OS.stage_pre_all(
            model, contacts, limits, 1e-3, costs, sol_b, grid_b,
            n_imp=n_imp, use_chain=True)),
        "condense": host_ms(lambda: cd.condense(kin)),
        "build": host_ms(lambda: OS._build(model, contacts, limits, 1e-3,
                                           costs, sol_b, grid_b, q_b, v_b,
                                           **kw)),
        "riccati": host_ms(lambda: bs.solve(built[0], built[2])),
        "direction_and_step": host_ms(lambda: OS._direction_and_step(
            model, contacts, limits, 1e-3, 0.995, sol_b, grid_b, built,
            n_imp=n_imp)),
    }


def phase_slice(dev):
    """The standing path at full width (K6 without the cost fold)."""
    p = problems.anymal_standing(N=N, dtype=torch.float32, device=dev)
    _, (sol0, q0s, v0s) = standing_fleet(p, B)
    costs = (p.cost,)
    mk = lambda k: OS.OCPSolver(   # noqa: E731
        p.model, p.contacts, costs, p.limits, T=p.T, N=p.N,
        options=OS.SolverOptions(use_kernels=k))
    sol_b, grid_b, q_b, v_b, _ = OS._fleet(sol0, p.grid, q0s, v0s)
    return _run_path("slice", mk, p.grid, sol0, q0s, v0s, lambda: _parts(
        p.model, p.contacts, p.limits, costs, sol_b, grid_b, q_b, v_b, 0,
        False, False))


def phase_trot(dev):
    """The main path: the trot MPC update at full width, float32, then the
    float64 convergence run of one unperturbed scenario."""
    p = problems.anymal_trot(N=N, dtype=torch.float32, device=dev)
    sol0, q0s, v0s = problems.fleet(p.solver, p.grid, p.q0, p.v0, B)
    mpc = p.mpc
    n_imp = mpc.n_reserved

    def mk(k):
        return OS.OCPSolver(p.model, mpc.contacts, p.costs, mpc.limits,
                            T=p.T, N=p.N, n_reserved_events=n_imp,
                            options=OS.SolverOptions(
                                switching_constraints=True, use_kernels=k))

    sol_b, grid_b, q_b, v_b, _ = OS._fleet(sol0, p.grid, q0s, v0s)
    launches, out, _ = _run_path(
        "trot", mk, p.grid, sol0, q0s, v0s, lambda: _parts(
            p.model, mpc.contacts, mpc.limits, p.costs, sol_b, grid_b, q_b,
            v_b, n_imp, True, True))
    # float64, one unperturbed scenario, 15 updates through the kernels
    p64 = problems.anymal_trot(N=N, dtype=torch.float64, device=dev)
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
    return launches, out


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
    before = read_counts()
    for _ in range(12):
        sol, _, _, _ = solver.update(ps.grid, ps.q0, ps.v0, sol)
    after = read_counts()
    check(all(after[k] - before[k] == 12 for k in after),
          f"biped standing run bypassed a kernel: {before} -> {after}")
    kkt = float(solver.kkt_error(ps.grid, ps.q0, ps.v0, sol))
    print(f"  biped standing: kkt {kkt:.3e} after 12 f64 updates through "
          "the kernels (gate 1e-6)")
    check(kkt < 1e-6, f"biped standing: kkt {kkt:.3e} >= 1e-6")
    # the walk's iterate warmed as the MPC runs, float64, one scenario
    t0 = time.perf_counter()
    p = problems.icub_walk(N=WALK_N, dtype=f64, device=dev)
    t, q, v = problems.walk_warm_start(p, WALK_T, WALK_DT)
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
    rng = np.random.default_rng(0)
    dq = rng.standard_normal((B, p.model.nv))

    def fleet(dtype):
        model = convert.astype(p.model, dtype)
        objs = [convert.astype(x, dtype) for x in (
            mpc.contacts, mpc.limits, mpc._costs, mpc.grid, mpc.sol)]
        sol0 = objs[4].map(lambda x: x.expand((B,) + x.shape).contiguous())
        q0s = rm.integrate(model, q.to(dtype).expand(B, model.nq),
                           torch.as_tensor(0.0075 * dq, dtype=dtype,
                                           device=dev))
        v0s = v.to(dtype).expand(B, model.nv).contiguous()

        def mk(k):
            return OS.OCPSolver(model, objs[0], objs[2], objs[1], T=p.T,
                                N=p.N, n_reserved_events=mpc.n_reserved,
                                options=OS.SolverOptions(
                                    switching_constraints=True,
                                    use_kernels=k))
        return model, objs, sol0, q0s, v0s, mk

    model, (contacts, limits, costs, grid, _), sol0, q0s, v0s, mk = fleet(f32)
    sol_b, grid_b, q_b, v_b, _ = OS._fleet(sol0, grid, q0s, v0s)
    launches, out, (out_k, out_p) = _run_path(
        "walk", mk, grid, sol0, q0s, v0s, lambda: _parts(
            model, contacts, limits, costs, sol_b, grid_b, q_b, v_b,
            mpc.n_reserved, True, True), strict=False)
    # kernels against plain versions in float64 on the same fleet; the
    # float32 gate of the trot is reported beside it, and the float32
    # steps' drift from the float64 one is gated
    _, (_, _, _, grid64, _), sol64, q64, v64, mk64 = fleet(f64)
    out["f64_agreement"], sol_p64 = _agree_f64("walk", mk64, grid64, sol64,
                                               q64, v64)
    sol_j = _mpc_step(mk(False), grid, _jittered(sol0), q0s, v0s)[0]
    out["f32_drift"] = _f32_drift("walk", sol64, {
        "kernel": out_k[0], "plain": out_p[0], "plain jittered": sol_j},
        sol_p64)
    out["f32_drift_by_kernel"] = _drift_by_kernel(
        "walk", lambda: _mpc_step(mk(True), grid, sol0, q0s, v0s)[0], sol64,
        sol_p64)
    if out["f32_gates_missed"]:
        print("  walk: float32 gates missed (reported, float64 gate holds): "
              + "; ".join(out["f32_gates_missed"]))
    out.update(warm_start_s=warm_s, warm_start_kkt=kkt_w,
               biped_standing_kkt=kkt, stage_slots=B * (n_slots - 1))
    print("walk: " + json.dumps(out))
    return launches, out


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
    if "build" in phases:
        phase_build()
    recs = phase_kernels(dev) if "kernels" in phases else {}
    if "slice" in phases:
        phase_slice(dev)
    if "trot" in phases:
        launches, _ = phase_trot(dev)
        for name, n in launches.items():
            if name in recs:
                recs[name]["launches"] = n
    if "golden" in phases:
        phase_golden(dev)
    if "walk" in phases:
        launches, _ = phase_walk(dev)
        for key, name in (("K6s", "K6"), ("Kc34", "Kc")):
            if key in recs:
                recs[key]["launches"] = launches[name]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(recs.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

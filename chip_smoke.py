"""Smoke run of the PyTorch/CUDA port (robotoc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  0. require a CUDA device; print the card's name and power limit and the
     TF32 switches (both off: reduced-precision products stall Newton);
  1. build the hand-written CUDA kernels from csrc/ with nvcc;
  2. hold every kernel of the main path (condense K1, Kc, K2, K3; Riccati
     backward sweep K5 without and with switching rows) against its plain
     PyTorch version on the card, in float64 and float32, at the shapes of
     the main path, and time kernel, plain version and library call;
  3. the main path: the ANYmal contact-OCP Newton update (T 0.5, N 20) for
     a fleet of B = 128 scenarios with perturbed initial configurations,
     float32, two updates per MPC step, through OCPSolver.update with the
     kernels; launch counts, finite KKT, agreement with the same run on
     the plain versions, and the time per MPC step;
  4. float64, one scenario, 16 updates through the kernels: reproduce
     tests/golden/anymal_standing_ocp.npz to 1e-6 with KKT below 1e-6;
  5. print the kernels' JSON line, the card line and the final status line.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from robotoc_tpu_torch import kernels, problems
from robotoc_tpu_torch.models import robot as rm
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
ALL_PHASES = ("build", "kernels", "slice", "golden")


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
# operation counts per stage (K1-K3) or per step (K5), from the dims
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

def fleet_start(p, Bn, seed=0):
    """Warm start broadcast to Bn scenarios whose initial configurations
    are moved by 0.03 N(0, 1) in the tangent space (numpy seed)."""
    solver = OS.OCPSolver(p.model, p.contacts, (p.cost,), p.limits, T=p.T,
                          N=p.N)
    sol = solver.init_solution(p.grid, p.q0, p.v0).map(
        lambda x: x.expand((Bn,) + x.shape).contiguous())
    rng = np.random.default_rng(seed)
    kw = dict(dtype=p.model.dtype, device=p.model.device)
    dq = torch.as_tensor(0.03 * rng.standard_normal((Bn, p.model.nv)), **kw)
    q0s = rm.integrate(p.model, p.q0.expand(Bn, p.model.nq), dq)
    v0s = torch.zeros((Bn, p.model.nv), **kw)
    return sol, q0s, v0s


def condense_inputs(dev):
    """The condense kernels' inputs at the main path's shapes: stage_pre
    of every stage of the B x N fleet at its perturbed start (float64)."""
    p = problems.anymal_standing(N=N, dtype=torch.float64, device=dev)
    sol, q0s, v0s = fleet_start(p, B)
    sol_b, grid_b, _, _, _ = OS._fleet(sol, p.grid, q0s, v0s)
    pre = OS.stage_inputs(p.model, p.contacts, p.limits, 1e-3, (p.cost,),
                          sol_b, grid_b)
    return {k: pre[k].contiguous() for k in cd.IN_NAMES}


def lqr_inputs(nf, dtype, dev, seed=1, nx=36, nu=12):
    """Seeded well-conditioned LQR data (B, N, ...) at the slice widths;
    with nf > 0, some steps carry masked switching rows."""
    rng = np.random.default_rng(seed)

    def r(*sh):
        return 0.3 * rng.standard_normal((B,) + sh)

    def spd(X, n):
        return X @ np.swapaxes(X, -1, -2) + 2.0 * np.eye(n)

    f = dict(A=r(N, nx, nx) / 3 + np.eye(nx), B=r(N, nx, nu),
             xres=r(N, nx), Qxx=spd(r(N, nx, nx), nx),
             Qxu=0.1 * r(N, nx, nu), Quu=spd(r(N, nu, nu), nu),
             lx=r(N, nx), lu=r(N, nu), QxxN=spd(r(nx, nx), nx), lxN=r(nx))
    sw = None
    if nf:
        sw = ((rng.uniform(size=(B, N, nf)) < 0.5)
              * (rng.uniform(size=(B, N, 1)) < 0.3)).astype(float)
        # at most half the rows active, as when two feet touch down: all
        # nf = nu rows of random Phiu make the Schur block S ill-conditioned
        sw[..., nf // 2:] = 0.0
        f.update(Phix=r(N, nf, nx) * sw[..., None],
                 Phiu=r(N, nf, nu) * sw[..., None], Pc=r(N, nf) * sw, sw=sw)
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
    print(f"  {name:7s} {str(dtype):14s} max_abs_err {worst:.3e} "
          f"(tolerance {TOL[dtype]:.0e} x each output's max-abs)")
    return worst


def phase_kernels(dev):
    """Every kernel against its plain version; times at float32, the main
    path's type. Returns the per-kernel records (launches filled later)."""
    x64 = condense_inputs(dev)
    recs = {}
    for dtype in (torch.float64, torch.float32):
        x = {k: v.to(dtype) for k, v in x64.items()}
        k1_in = [x[n] for n in ("M", "J", "inactive", "Tw1", "Tw2", "r1",
                                "e2")]
        p1 = cd.k1_plain(*k1_in)
        e1 = _compare("K1", cd.k1(*k1_in), p1, dtype)
        kc_in = [x["dgdq"], x["dgdf"], x["d_cone"]]
        pc = cd.kc_plain(*kc_in)
        ec = _compare("Kc", cd.kc(*kc_in), pc, dtype)
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
        e5 = {}
        for nf in (0, 12):
            l_in = lqr_inputs(nf, dtype, dev)
            e5[nf] = _compare(f"K5 nf={nf}", bs.bwd(*l_in),
                              bs.bwd_plain(*l_in), dtype)
        if dtype != torch.float32:
            continue
        S = x["M"].shape[0]
        nv, nf_, nu = 18, 12, 12
        w = 2 * nv + nu
        Xc = torch.cat([x["dgdq"], x["dgdf"]], dim=-1).contiguous()
        specs = [
            ("K1", "k1", cd.k1, cd.k1_plain, k1_in, e1,
             S * flops_k1(nv, nf_, w), None,
             "robotoc_tpu/ops/pallas_condense.py:331"),
            ("Kc", "kc", cd.kc, cd.kc_plain, kc_in, ec,
             S * flops_kc(nv, nf_, 20),
             lambda: torch.einsum("sr,sri,srj->sij", x["d_cone"], Xc, Xc),
             "robotoc_tpu/ops/pallas_condense.py:348"),
            ("K2", "k2", cd.k2, cd.k2_plain, k2_in, e2,
             S * flops_k2(nv, nu, nf_), None,
             "robotoc_tpu/ops/pallas_condense.py:377"),
            ("K3", "k3", cd.k3, cd.k3_plain, k3_in, e3,
             S * flops_k3(nv, nu), None,
             "robotoc_tpu/ops/pallas_condense.py:399"),
        ]
        for name, fn_name, kern, plain, args, err, flops, lib, repl in specs:
            outs = kern(*args)
            b_ms, b_by = bound(nbytes(*args) + nbytes(*outs), flops, dtype)
            recs[name] = dict(
                name=f"{name} condense_{fn_name}", route="cuda",
                source="robotoc_tpu_torch/csrc/condense.cu", replaces=repl,
                launches=None, max_abs_err=err,
                ms=cuda_ms(lambda: kern(*args)),
                plain_ms=cuda_ms(lambda: plain(*args), reps=5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(lib) if lib is not None else None)
        l_in = lqr_inputs(0, dtype, dev)
        outs = bs.bwd(*l_in)
        b_ms, b_by = bound(nbytes(*l_in) + nbytes(*outs),
                           B * N * flops_k5_step(36, 12, 0), dtype)
        recs["K5"] = dict(
            name="K5 riccati_bwd", route="cuda",
            source="robotoc_tpu_torch/csrc/riccati_bwd.cu",
            replaces="robotoc_tpu/riccati/pallas_scan.py:146",
            launches=None, max_abs_err=e5[0],
            ms=cuda_ms(lambda: bs.bwd(*l_in)),
            plain_ms=cuda_ms(lambda: bs.bwd_plain(*l_in), reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for r in recs.values():
        print(f"  {r['name']:20s} {r['ms']:.4f} ms  plain {r['plain_ms']:.3f}"
              f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              f"  library {r['library_ms']}")
    return recs


def _mpc_step(solver, p, sol, q0s, v0s):
    kkts = []
    for _ in range(2):
        sol, kkt, _, _ = solver.update(p.grid, q0s, v0s, sol)
        kkts.append(kkt)
    return sol, kkts


def phase_slice(dev):
    """The main path at full width; returns the launch counts and timings."""
    p = problems.anymal_standing(N=N, dtype=torch.float32, device=dev)
    sol0, q0s, v0s = fleet_start(p, B)
    mk = lambda k: OS.OCPSolver(   # noqa: E731
        p.model, p.contacts, (p.cost,), p.limits, T=p.T, N=p.N,
        options=OS.SolverOptions(use_kernels=k))
    s_kern, s_plain = mk(True), mk(False)
    _mpc_step(s_kern, p, sol0, q0s, v0s)            # warm-up
    torch.cuda.synchronize()
    cd.reset_launches()
    bs.bwd.launches = 0
    sol_k, kkt_k = _mpc_step(s_kern, p, sol0, q0s, v0s)   # the main path
    torch.cuda.synchronize()
    launches = {"K1": cd.k1.launches, "Kc": cd.kc.launches,
                "K2": cd.k2.launches, "K3": cd.k3.launches,
                "K5": bs.bwd.launches}
    print(f"  launches in one MPC step (2 updates): {launches}")
    check(all(v == 2 for v in launches.values()),
          f"expected 1 launch of each kernel per update: {launches}")
    for i, kkt in enumerate(kkt_k):
        check(bool(torch.isfinite(kkt).all()), f"update {i}: KKT not "
              "finite")
    sol_p, kkt_p = _mpc_step(s_plain, p, sol0, q0s, v0s)
    # agreement with the plain versions: KKT to 1e-3 relative; each
    # solution field to 1e-2 of the largest change the plain MPC step made
    # to it (float32 rounding through a stiff problem's Newton directions)
    for i, (a, b) in enumerate(zip(kkt_k, kkt_p)):
        rel = float(((a - b).abs() / b.abs()).max())
        check(rel <= 1e-3, f"update {i}: KKT kernel vs plain rel {rel:.2e}")
    worst = {}
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "beta", "mu",
                 "s_lim", "z_lim", "s_cone", "z_cone"):
        xk, xp = getattr(sol_k, name), getattr(sol_p, name)
        step = float((xp - getattr(sol0, name)).abs().max())
        err = float((xk - xp).abs().max())
        worst[name] = err / max(step, 1e-30)
        check(err <= 1e-2 * step + 1e-6, f"{name}: kernel vs plain "
              f"{err:.3e} > 1e-2 x step {step:.3e}")
    print("  kernel vs plain, error / step: "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    print(f"  fleet KKT after the step: max {float(kkt_k[-1].max()):.4e}")

    step_ms = host_ms(lambda: _mpc_step(s_kern, p, sol0, q0s, v0s))
    step_plain_ms = host_ms(lambda: _mpc_step(s_plain, p, sol0, q0s, v0s))
    # where the time of one update goes (host clock, synchronised phases)
    sol_b, grid_b, q_b, v_b, _ = OS._fleet(sol0, p.grid, q0s, v0s)
    lim, costs = p.limits, (p.cost,)
    pre = OS.stage_inputs(p.model, p.contacts, lim, 1e-3, costs, sol_b,
                          grid_b)
    kin = {k: v for k, v in pre.items() if not k.startswith("aux_")}
    built = OS._build(p.model, p.contacts, lim, 1e-3, costs, sol_b, grid_b,
                      q_b, v_b)
    parts = {
        "stage_pre": host_ms(lambda: OS.stage_inputs(
            p.model, p.contacts, lim, 1e-3, costs, sol_b, grid_b)),
        "condense": host_ms(lambda: cd.condense(kin)),
        "build": host_ms(lambda: OS._build(p.model, p.contacts, lim, 1e-3,
                                           costs, sol_b, grid_b, q_b, v_b)),
        "riccati": host_ms(lambda: bs.solve(built[0], built[2])),
        "direction_and_step": host_ms(lambda: OS._direction_and_step(
            p.model, p.contacts, lim, 1e-3, 0.995, sol_b, grid_b, built)),
    }
    dev_ms, top = device_time(lambda: s_kern.update(p.grid, q0s, v0s,
                                                      sol0))
    out = dict(B=B, N=N, dtype="float32", ms_per_mpc_step=step_ms,
               mpc_updates_per_s=B / (step_ms * 1e-3),
               plain_ms_per_mpc_step=step_plain_ms,
               ms_per_update_parts=parts,
               device_ms_per_update=dev_ms,
               device_idle_share=(None if dev_ms is None
                                  else 1.0 - dev_ms / (step_ms / 2)),
               top_device_kernels_ms=top,
               fleet_max_kkt=float(kkt_k[-1].max()))
    print(f"  ms per MPC step (2 updates, B={B}): {step_ms:.2f} with the "
          f"kernels, {step_plain_ms:.2f} with the plain versions; "
          f"{out['mpc_updates_per_s']:.1f} MPC updates/s")
    print("  one update, by part (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(f"  device time per update {dev_ms} ms (profiler), idle share "
          f"{out['device_idle_share']}; top kernels {top}")
    print("slice: " + json.dumps(out))
    return launches, out


def phase_golden(dev):
    ref = np.load(GOLDEN)
    p = problems.anymal_standing(N=N, dtype=torch.float64, device=dev)
    solver = OS.OCPSolver(p.model, p.contacts, (p.cost,), p.limits, T=p.T,
                          N=p.N)
    sol = solver.init_solution(p.grid, p.q0, p.v0)
    before = bs.bwd.launches
    for _ in range(16):
        sol, kkt, _, _ = solver.update(p.grid, p.q0, p.v0, sol)
    check(bs.bwd.launches - before == 16, "golden run bypassed the kernels")
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
        launches, _ = phase_slice(dev)
        for name, n in launches.items():
            if name in recs:
                recs[name]["launches"] = n
    if "golden" in phases:
        phase_golden(dev)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(recs.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

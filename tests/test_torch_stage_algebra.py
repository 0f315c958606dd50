"""The CUDA kernels' per-stage arithmetic, built for the host.

csrc/host_shim.cpp compiles the same __host__ __device__ templates the
condense and Riccati kernels run (csrc/stage_algebra.cuh,
condense_stage.cuh, riccati_stage.cuh) with g++, one "thread" per stage,
and exposes them through a plain C interface. Here they are held against
the port's plain PyTorch versions in f64: Gauss-Jordan and the products
at 1e-12 on well-conditioned inputs, the stage bodies of K1, Kc, K2, K3
on stages of the ANYmal contact OCP and K5 on seeded LQR data at 1e-12
relative to each output's largest magnitude. Skipped only where g++ is
absent."""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from robotoc_tpu_torch import kernels, problems
from robotoc_tpu_torch.ops import condense as cd
from robotoc_tpu_torch.ops.linalg import gauss_jordan_inverse
from robotoc_tpu_torch.riccati import backward_sweep
from robotoc_tpu_torch.solver import ocp_solver as TOS

NV, NU, NF, NC = 18, 12, 12, 20
NX, NY, W = 2 * NV, NV + NF, 2 * NV + NU
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = kernels.host_library()
    lib.rtt_host_gauss_jordan.argtypes = [P, I]
    lib.rtt_host_gemm_537.argtypes = [I, I, P, P, P, P, ctypes.c_double]
    lib.rtt_host_gemv_53.argtypes = [I, P, P, P, P, ctypes.c_double]
    lib.rtt_host_k1.argtypes = [ctypes.c_longlong] + [P] * 12
    lib.rtt_host_kc.argtypes = [I, ctypes.c_longlong] + [P] * 6
    lib.rtt_host_k2.argtypes = [ctypes.c_longlong] + [P] * 14
    lib.rtt_host_k3.argtypes = [ctypes.c_longlong] + [P] * 15
    lib.rtt_host_riccati_bwd.argtypes = [I, I, I] + [P] * 20
    for name in ("gauss_jordan", "gemm_537", "gemv_53", "k1", "kc", "k2",
                 "k3", "riccati_bwd"):
        getattr(lib, f"rtt_host_{name}").restype = I
    return lib


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _rel_close(got, want, tol=1e-12, name=""):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("n", [6, 12, 30])
def test_gauss_jordan(lib, n):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, n))
    A = torch.as_tensor(X @ X.T + n * np.eye(n))
    if n == 30:   # the contact KKT shape: [[M, J^T], [J, -D]]
        A[18:, 18:] = -torch.eye(12, dtype=torch.float64)
        A[18:, :18] = torch.as_tensor(rng.standard_normal((12, 18)))
        A[:18, 18:] = A[18:, :18].T
    got = A.clone()
    assert lib.rtt_host_gauss_jordan(_p(got), n) == 0
    _rel_close(got, gauss_jordan_inverse(A), name=f"gj{n}")


@pytest.mark.parametrize("ta,tb", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_gemm(lib, ta, tb):
    rng = np.random.default_rng(10 + 2 * ta + tb)
    A = torch.as_tensor(rng.standard_normal((3, 5) if ta else (5, 3)))
    B = torch.as_tensor(rng.standard_normal((7, 3) if tb else (3, 7)))
    D = torch.as_tensor(rng.standard_normal((5, 7)))
    C = torch.empty(5, 7, dtype=torch.float64)
    assert lib.rtt_host_gemm_537(ta, tb, _p(C), _p(A), _p(B), _p(D),
                                 -0.5) == 0
    want = D - 0.5 * ((A.T if ta else A) @ (B.T if tb else B))
    _rel_close(C, want, name="gemm")
    assert lib.rtt_host_gemm_537(ta, tb, _p(C), _p(A), _p(B), None,
                                 1.0) == 0
    _rel_close(C, (A.T if ta else A) @ (B.T if tb else B), name="gemm0")


@pytest.mark.parametrize("ta", [0, 1])
def test_gemv(lib, ta):
    rng = np.random.default_rng(20 + ta)
    A = torch.as_tensor(rng.standard_normal((3, 5) if ta else (5, 3)))
    x = torch.as_tensor(rng.standard_normal(3))
    d = torch.as_tensor(rng.standard_normal(5))
    y = torch.empty(5, dtype=torch.float64)
    assert lib.rtt_host_gemv_53(ta, _p(y), _p(A), _p(x), _p(d), 2.0) == 0
    _rel_close(y, d + 2.0 * ((A.T if ta else A) @ x), name="gemv")


@pytest.fixture(scope="module")
def stage_batch():
    """Condense inputs of 8 stages (B = 2, N = 4) of the ANYmal OCP after
    one Newton update from a perturbed start, so no block is trivial."""
    p = problems.anymal_standing(N=4, device="cpu")
    solver = TOS.OCPSolver(p.model, p.contacts, (p.cost,), p.limits,
                           T=p.T, N=p.N)
    sol = solver.init_solution(p.grid, p.q0, p.v0).map(
        lambda x: torch.stack([x, x]))
    rng = np.random.default_rng(0)
    from robotoc_tpu_torch.models import robot as rm
    q0s = rm.integrate(p.model, p.q0.expand(2, 19),
                       torch.as_tensor(0.03 * rng.standard_normal((2, 18))))
    v0s = torch.zeros(2, 18, dtype=torch.float64)
    sol, _, _, _ = solver.update(p.grid, q0s, v0s, sol)
    sol_b, grid_b, _, _, _ = TOS._fleet(sol, p.grid, q0s, v0s)
    pre = TOS.stage_inputs(p.model, p.contacts, p.limits, 1e-3, (p.cost,),
                           sol_b, grid_b)
    return {k: pre[k].contiguous() for k in cd.IN_NAMES}


def _empty(S, *shape):
    return torch.empty((S,) + shape, dtype=torch.float64)


def test_k1_stage(lib, stage_batch):
    x = stage_batch
    S = x["M"].shape[0]
    ins = [x[n] for n in ("M", "J", "inactive", "Tw1", "Tw2", "r1", "e2")]
    outs = [_empty(S, NV, NV), _empty(S, NV, NF), _empty(S, NF, NF),
            _empty(S, NY, W), _empty(S, NY)]
    assert lib.rtt_host_k1(S, *[_p(t) for t in ins + outs]) == 0
    for name, got, want in zip(("inv11", "inv12", "Sinv", "G", "c0"), outs,
                               cd.k1_plain(*ins)):
        _rel_close(got, want, name=name)


def test_kc_stage(lib, stage_batch):
    x = stage_batch
    S = x["M"].shape[0]
    ins = [x["dgdq"], x["dgdf"], x["d_cone"]]
    outs = [_empty(S, NV, NV), _empty(S, NV, NF), _empty(S, NF, NF)]
    assert lib.rtt_host_kc(NC, S, *[_p(t) for t in ins + outs]) == 0
    for got, want in zip(outs, cd.kc_plain(*ins)):
        _rel_close(got, want, name="kc")


def test_kc_stage_34_rows(lib):
    """Kc's 34-row instance (the iCub soles' two 17-row wrench cones) on
    seeded data: every block nonzero, unlike a surface stack's zero
    dg/dq. Other row counts are refused."""
    S, ng = 6, 34
    rng = np.random.default_rng(34)
    ins = [torch.as_tensor(rng.standard_normal((S, ng, NV))),
           torch.as_tensor(rng.standard_normal((S, ng, NF))),
           torch.as_tensor(rng.uniform(0.1, 2.0, (S, ng)))]
    outs = [_empty(S, NV, NV), _empty(S, NV, NF), _empty(S, NF, NF)]
    assert lib.rtt_host_kc(ng, S, *[_p(t) for t in ins + outs]) == 0
    for got, want in zip(outs, cd.kc_plain(*ins)):
        _rel_close(got, want, name="kc34")
    assert lib.rtt_host_kc(17, S, *[_p(t) for t in ins + outs]) == -1


def _k2_inputs(x):
    inv11, inv12, Sinv, G, c0 = cd.k1_plain(
        *[x[n] for n in ("M", "J", "inactive", "Tw1", "Tw2", "r1", "e2")])
    Hqq, Hqf, Hff = cd.kc_plain(x["dgdq"], x["dgdf"], x["d_cone"])
    d = torch.diag_embed
    return G, c0, [G, c0, x["Wq"] + d(x["Hq_d"]) + Hqq,
                   x["Wv"] + d(x["Hv_d"]), x["Wu"] + d(x["Hu_d"]),
                   x["Wa"] + d(x["Ha_d"]), x["Wf"] + Hff, Hqf, x["gw"],
                   x["gy"]]


def test_k2_stage(lib, stage_batch):
    S = stage_batch["M"].shape[0]
    _, _, ins = _k2_inputs(stage_batch)
    ins = [t.contiguous() for t in ins]
    outs = [_empty(S, NX, NX), _empty(S, NX, NU), _empty(S, NU, NU),
            _empty(S, W)]
    assert lib.rtt_host_k2(S, *[_p(t) for t in ins + outs]) == 0
    for name, got, want in zip(("Qxx", "Qxu", "Quu", "gtil"), outs,
                               cd.k2_plain(*ins)):
        _rel_close(got, want, name=name)


def test_k3_stage(lib, stage_batch):
    x = stage_batch
    S = x["M"].shape[0]
    G, c0, k2_ins = _k2_inputs(x)
    gtil = cd.k2_plain(*k2_ins)[3].contiguous()
    ins = [G.contiguous(), c0.contiguous(), gtil] + [
        x[n] for n in ("Aqq", "Aqv", "xres_q", "Fv_res", "sA", "lam2",
                       "lmdgmm")]
    outs = [_empty(S, NX, NX), _empty(S, NX, NU), _empty(S, NX),
            _empty(S, NX), _empty(S, NU)]
    assert lib.rtt_host_k3(S, *[_p(t) for t in ins + outs]) == 0
    for name, got, want in zip(("A", "Bm", "xres", "lx", "lu"), outs,
                               cd.k3_plain(*ins)):
        _rel_close(got, want, name=name)


@pytest.mark.parametrize("nf", [0, 12])
def test_riccati_bwd(lib, nf):
    f = _lqr_fields(nf, seed=nf + 5)
    Bn, N = f["A"].shape[0], f["A"].shape[1]
    names = ("A", "B", "xres", "Qxx", "Qxu", "Quu", "lx", "lu")
    sw_names = ("Phix", "Phiu", "Pc", "sw")
    ins = [f[n] for n in names]
    sws = [f[n] for n in sw_names] if nf else [None] * 4
    K, k = _empty(Bn, N, NU, NX), _empty(Bn, N, NU)
    Pm, p = _empty(Bn, N, NX, NX), _empty(Bn, N, NX)
    Mx, mx = ((_empty(Bn, N, nf, NX), _empty(Bn, N, nf)) if nf
              else (None, None))
    rc = lib.rtt_host_riccati_bwd(
        nf, Bn, N, *[_p(t) for t in ins + sws], _p(f["Qxx_N"]),
        _p(f["lx_N"]), _p(K), _p(k), _p(Pm), _p(p), _p(Mx), _p(mx))
    assert rc == 0
    want = backward_sweep.bwd_plain(*ins, f["Qxx_N"], f["lx_N"], *sws)
    for name, got, ref in zip(("K", "k", "P", "p", "Mx", "mx"),
                              (K, k, Pm, p, Mx, mx), want):
        if ref is None:
            assert got is None, name
        else:
            _rel_close(got, ref, name=name)


def _lqr_fields(nf, seed, Bn=2, N=3):
    """Well-conditioned LQR data at the slice's widths (nx 36, nu 12)."""
    rng = np.random.default_rng(seed)

    def r(*sh):
        return 0.3 * rng.standard_normal((Bn,) + sh)

    def spd(X, n):
        return X @ np.swapaxes(X, -1, -2) + 2.0 * np.eye(n)

    f = dict(A=r(N, NX, NX) / 3 + np.eye(NX), B=r(N, NX, NU), xres=r(N, NX),
             Qxx=spd(r(N, NX, NX), NX), Qxu=0.1 * r(N, NX, NU),
             Quu=spd(r(N, NU, NU), NU), lx=r(N, NX), lu=r(N, NU),
             Qxx_N=spd(r(NX, NX), NX), lx_N=r(NX))
    if nf:
        sw = ((rng.uniform(size=(Bn, N, nf)) < 0.5)
              * (rng.uniform(size=(Bn, N, 1)) < 0.7)).astype(float)
        f.update(Phix=r(N, nf, NX) * sw[..., None],
                 Phiu=r(N, nf, NU) * sw[..., None], Pc=r(N, nf) * sw, sw=sw)
    return {k: torch.as_tensor(v).contiguous() for k, v in f.items()}

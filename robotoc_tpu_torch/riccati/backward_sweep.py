"""Riccati backward sweep over a fleet of scenarios: kernel K5.

Port of robotoc_tpu/riccati/pallas_scan.py. The JAX package runs the
whole backward sweep in one Pallas TPU kernel (`_bwd_kernel`,
pallas_scan.py:37, launch :146) whose sequential grid axis walks the
horizon; here it is the hand-written CUDA kernel csrc/riccati_bwd.cu (body
in csrc/riccati_stage.cuh), one thread block per scenario looping over the
N steps in reverse. `bwd` launches it for CUDA tensors and runs `bwd_plain`
for CPU tensors; `bwd.launches` counts the launches.

Bound on an H100: the sweep reads about 3,700 and writes about 1,800
values per step at nx 36, nu 12 (56 MB in f32 for B 128, N 20, 17 us at
3.35 TB/s), but it is latency-bound: B independent chains of N dependent
steps, each a handful of dependent 36 x 36 products and a 12 x 12
inversion, so only B blocks are ever resident. The design keeps every
intermediate of a step in shared memory and touches device memory only to
read a step's blocks and write its gains.

The forward rollout stays plain tensor code (a loop over N of batched
matvecs), as the JAX package left it to XLA (pallas_scan.py:222-233).
Numerics follow the Pallas step: Quu and the switching Schur block are
inverted by unpivoted Gauss-Jordan WITHOUT symmetrisation, P is
symmetrised every step.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..core.structs import LQRData, LQRPolicy
from ..ops.linalg import gauss_jordan_inverse
from . import lqr

# dims the CUDA library is instantiated for: nx, nu, and nf in {0, 12}
KERNEL_DIMS = (36, 12, (0, 12))


def _t(x):
    return x.transpose(-1, -2)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def bwd_plain(A, B, xres, Qxx, Qxu, Quu, lx, lu, QxxN, lxN, Phix=None,
              Phiu=None, Pc=None, sw=None):
    """Backward sweep over (..., N, ...) step arrays, K5's arithmetic.
    Returns (K, k, P, p, Mx, mx) for steps 0..N-1 (Mx, mx None without
    switching rows)."""
    con = Phix is not None
    N = A.shape[-3]
    P_next = 0.5 * (QxxN + _t(QxxN))
    p_next = lxN
    outs = []
    for i in reversed(range(N)):
        Ai, Bi = A[..., i, :, :], B[..., i, :, :]
        AtP = _t(Ai) @ P_next
        F = Qxx[..., i, :, :] + AtP @ Ai
        H = Qxu[..., i, :, :] + AtP @ Bi
        G = Quu[..., i, :, :] + (_t(Bi) @ P_next) @ Bi
        Pxr_p = _mv(P_next, xres[..., i, :]) + p_next
        gu = lu[..., i, :] + _mv(_t(Bi), Pxr_p)
        Ginv = gauss_jordan_inverse(G)
        K = -(Ginv @ _t(H))
        k = -_mv(Ginv, gu)
        lxt = lx[..., i, :] + _mv(_t(Ai), Pxr_p)
        Mx = mx = None
        if con:
            Phx, Phu = Phix[..., i, :, :], Phiu[..., i, :, :]
            s = sw[..., i, :]
            GiPT = Ginv @ _t(Phu)
            S = ((Phu @ GiPT) * (s.unsqueeze(-1) * s.unsqueeze(-2))
                 + torch.diag_embed(1.0 - s))
            Sinv = gauss_jordan_inverse(S)
            Mx = Sinv @ ((Phu @ K + Phx) * s.unsqueeze(-1))
            mx = _mv(Sinv, (_mv(Phu, k) + Pc[..., i, :]) * s)
            K = K - GiPT @ Mx
            k = k - _mv(GiPT, mx)
            P = F + H @ K + _t(Phx) @ Mx
            p = lxt + _mv(H, k) + _mv(_t(Phx), mx)
        else:
            P = F + H @ K
            p = lxt + _mv(H, k)
        P = 0.5 * (P + _t(P))
        outs.append((K, k, P, p, Mx, mx))
        P_next, p_next = P, p
    d = A.dim() - 3
    stack = lambda j: torch.stack([o[j] for o in outs[::-1]], dim=d)  # noqa
    return (stack(0), stack(1), stack(2), stack(3),
            stack(4) if con else None, stack(5) if con else None)


def _lib():
    lib = kernels.library("riccati_bwd")
    if not getattr(lib, "_rtt_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rtt_riccati_bwd.argtypes = [I] * 4 + [P] * 20 + [I, I, P]
        lib.rtt_riccati_bwd.restype = I
        lib._rtt_typed = True
    return lib


def bwd(A, B, xres, Qxx, Qxu, Quu, lx, lu, QxxN, lxN, Phix=None, Phiu=None,
        Pc=None, sw=None):
    """K5 on a (Bn, N, ...) fleet -> (K, k, P, p, Mx, mx)."""
    if A.device.type == "cpu":
        return bwd_plain(A, B, xres, Qxx, Qxu, Quu, lx, lu, QxxN, lxN, Phix,
                         Phiu, Pc, sw)
    if A.dim() != 4:
        raise ValueError(f"bwd: A must be (B, N, nx, nx), got {A.shape}")
    Bn, N, nx, nu = A.shape[0], A.shape[1], A.shape[-1], B.shape[-1]
    con = Phix is not None
    nf = Phix.shape[-2] if con else 0
    ins = [A, B, xres, Qxx, Qxu, Quu, lx, lu, QxxN, lxN]
    shapes = [(Bn, N, nx, nx), (Bn, N, nx, nu), (Bn, N, nx),
              (Bn, N, nx, nx), (Bn, N, nx, nu), (Bn, N, nu, nu),
              (Bn, N, nx), (Bn, N, nu), (Bn, nx, nx), (Bn, nx)]
    if con:
        ins += [Phix, Phiu, Pc, sw]
        shapes += [(Bn, N, nf, nx), (Bn, N, nf, nu), (Bn, N, nf),
                   (Bn, N, nf)]
    kernels.check_args("bwd", ins, shapes)

    def empty(*shape):
        return torch.empty(shape, dtype=A.dtype, device=A.device)

    K, k = empty(Bn, N, nu, nx), empty(Bn, N, nu)
    P, p = empty(Bn, N, nx, nx), empty(Bn, N, nx)
    Mx, mx = (empty(Bn, N, nf, nx), empty(Bn, N, nf)) if con else (None,
                                                                   None)
    ptr = kernels.ptr
    rc = _lib().rtt_riccati_bwd(
        kernels.DTYPE_CODE[A.dtype], nx, nu, nf, *[ptr(t) for t in ins[:8]],
        ptr(Phix), ptr(Phiu), ptr(Pc), ptr(sw), ptr(QxxN), ptr(lxN), ptr(K),
        ptr(k), ptr(P), ptr(p), ptr(Mx), ptr(mx), Bn, N, kernels.stream(A))
    if rc == -1:
        raise ValueError(f"bwd: no kernel for nx={nx}, nu={nu}, nf={nf} / "
                         f"{A.dtype}; built for {KERNEL_DIMS}")
    if rc != 0:
        raise RuntimeError(f"bwd: CUDA launch failed (cudaError {rc})")
    bwd.launches += 1
    return K, k, P, p, Mx, mx


bwd.launches = 0


def solve(data: LQRData, dx0, use_kernels: bool = True):
    """Fleet LQR solve: fields (B, N, ...), dx0 (B, nx). Backward sweep by
    K5 (or its plain version with use_kernels=False), forward rollout and
    costates in plain tensor code. Returns (dx (B, N+1, nx), du (B, N, nu),
    dlmd (B, N+1, nx), LQRPolicy)."""
    con = data.Phix is not None
    fields = [data.A, data.B, data.xres, data.Qxx, data.Qxu, data.Quu,
              data.lx, data.lu, data.Qxx_N, data.lx_N]
    sw_fields = ([data.Phix, data.Phiu, data.Pc, data.sw] if con
                 else [None] * 4)
    fn = bwd if use_kernels else bwd_plain
    K, k, P, p, Mx, mx = fn(*[x.contiguous() for x in fields],
                            *[x.contiguous() if x is not None else None
                              for x in sw_fields])
    PN = 0.5 * (data.Qxx_N + _t(data.Qxx_N))
    P_all = torch.cat([P, PN.unsqueeze(-3)], dim=-3)
    p_all = torch.cat([p, data.lx_N.unsqueeze(-2)], dim=-2)
    dx, du, dlmd = lqr.forward(data, K, k, P_all, p_all, dx0)
    return dx, du, dlmd, LQRPolicy(K=K, k=k, P=P_all, p=p_all, Mx=Mx, mx=mx)

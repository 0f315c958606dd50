"""Per-stage condensing over a flat batch of stages: four kernels.

Port of robotoc_tpu/ops/pallas_condense.py. The JAX package evaluates the
contact-space elimination of every stage in four Pallas TPU kernels; here
each is a hand-written CUDA kernel (csrc/condense.cu, bodies in
csrc/condense_stage.cuh) with a plain PyTorch version beside it:

  K1  `k1`  <- _k1_kernel (pallas_condense.py:145, launch :331)
        contact KKT inverse by unpivoted Gauss-Jordan -> inv11, inv12,
        Sinv, G = Psi [Tw1; Tw2], c0 = Psi [r1; e2] (first nv rows negated)
  Kc  `kc`  <- _kc_kernel (:173, launch :348)
        cone Gauss-Newton blocks sum_r d_r dg_r (x) dg_r
  K2  `k2`  <- _k2_kernel (:200, launch :377)
        condensed quadratic Qxx, Qxu, Quu and gradient gtil
  K3  `k3`  <- _k3_kernel (:255, launch :399)
        LQR blocks A, Bm, xres, lx, lu

All four are bound by device-memory bytes on an H100 (see csrc/condense.cu
for the count); each reads each input once and writes each output once,
K1 and Kc a warp per stage, K2 a block of four warps per stage, K3 a
thread per 16-byte column chunk of a stage.

Every tensor is batch-first (S, ...), S = B * N stages flattened, which is
what the custom-vmap rule of the Pallas entry did. A wrapper (`k1`, `kc`,
`k2`, `k3`) runs its plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises; `<wrapper>.launches` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..dynamics.contact_dynamics import kkt_block
from .linalg import gauss_jordan_inverse

IN_NAMES = ("M", "J", "inactive", "Tw1", "Tw2", "r1", "e2",
            "Wq", "Wv", "Wu", "Wa", "Wf", "Hq_d", "Hv_d", "Hu_d", "Ha_d",
            "dgdq", "dgdf", "d_cone", "gw", "gy",
            "Aqq", "Aqv", "xres_q", "Fv_res", "sA", "lam2", "lmdgmm")
OUT_NAMES = ("inv11", "inv12", "Sinv", "G", "c0", "A", "Bm", "xres",
             "Qxx", "Qxu", "Quu", "lx", "lu", "coneHqf", "Hff_c")

# dims the CUDA library is instantiated for: (nv, nu, nf) and Kc's cone
# row counts (ANYmal's four 5-row pyramids, the iCub's two 17-row wrench
# cones)
KERNEL_DIMS = (18, 12, 12, (20, 34))


def _t(x):
    return x.transpose(-1, -2)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def k1_plain(M, J, inactive, Tw1, Tw2, r1, e2):
    nv = M.shape[-1]
    Psi = gauss_jordan_inverse(kkt_block(M, J, inactive))
    i11 = Psi[..., :nv, :nv]
    Sv = -Psi[..., nv:, nv:]
    inv11 = 0.5 * (i11 + _t(i11))
    inv12 = 0.5 * (Psi[..., :nv, nv:] + _t(Psi[..., nv:, :nv]))
    Sinv = 0.5 * (Sv + _t(Sv))
    X = Psi @ torch.cat([Tw1, Tw2], dim=-2)
    G = torch.cat([-X[..., :nv, :], X[..., nv:, :]], dim=-2)
    x0 = _mv(Psi, torch.cat([r1, e2], dim=-1))
    c0 = torch.cat([-x0[..., :nv], x0[..., nv:]], dim=-1)
    return inv11, inv12, Sinv, G, c0


def kc_plain(dgdq, dgdf, d_cone):
    dq = d_cone.unsqueeze(-1) * dgdq
    return _t(dq) @ dgdq, _t(dq) @ dgdf, _t(d_cone.unsqueeze(-1) * dgdf) @ dgdf


def k2_plain(G, c0, Hq, Hv, Hu, Ha, Hf, coneHqf, gw, gy):
    nv = Ha.shape[-1]
    nx = 2 * nv
    Ga, Gf = G[..., :nv, :], G[..., nv:, :]
    HyG = torch.cat([Ha @ Ga, Hf @ Gf], dim=-2)
    CwyG = coneHqf @ Gf                                   # (nv, w)
    Cxp = torch.cat([CwyG[..., :nx], torch.zeros_like(CwyG[..., :nx])],
                    dim=-2)
    z = torch.zeros_like(Hq)
    bd = torch.cat([torch.cat([Hq, z], dim=-1), torch.cat([z, Hv], dim=-1)],
                   dim=-2)
    Qxx = _t(G[..., :nx]) @ HyG[..., :nx] + Cxp + _t(Cxp) + bd
    Qxu = _t(G[..., :nx]) @ HyG[..., nx:] + torch.cat(
        [CwyG[..., nx:], torch.zeros_like(CwyG[..., nx:])], dim=-2)
    Quu = _t(G[..., nx:]) @ HyG[..., nx:] + Hu
    c0a, c0f = c0[..., :nv], c0[..., nv:]
    hy0 = torch.cat([_mv(Ha, c0a), _mv(Hf, c0f)], dim=-1) + gy
    Cc0 = torch.cat([_mv(coneHqf, c0f),
                     gw.new_zeros(gw.shape[:-1] + (gw.shape[-1] - nv,))],
                    dim=-1)
    gtil = gw + Cc0 + _mv(_t(G), hy0)
    return Qxx, Qxu, Quu, gtil


def k3_plain(G, c0, gtil, Aqq, Aqv, xres_q, Fv_res, sA, lam2, lmdgmm):
    nv = Aqq.shape[-1]
    nx = 2 * nv
    Ga = G[..., :nv, :]
    s = sA[..., None, None]
    eye = torch.eye(nv, dtype=G.dtype, device=G.device)
    A = torch.cat([torch.cat([Aqq, Aqv], dim=-1),
                   torch.cat([s * Ga[..., :nv], eye + s * Ga[..., nv:nx]],
                             dim=-1)], dim=-2)
    Gu = s * Ga[..., nx:]
    Bm = torch.cat([torch.zeros_like(Gu), Gu], dim=-2)
    xres = torch.cat([xres_q, Fv_res + sA.unsqueeze(-1) * c0[..., :nv]],
                     dim=-1)
    lx = gtil[..., :nx] + _mv(_t(A), lam2) - lmdgmm
    lu = gtil[..., nx:] + _mv(_t(Bm), lam2)
    return A, Bm, xres, lx, lu


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = kernels.library("condense")
    if not getattr(lib, "_rtt_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, n_int, n_ptr in (("rtt_condense_k1", 4, 12),
                                 ("rtt_condense_kc", 4, 6),
                                 ("rtt_condense_k2", 4, 14),
                                 ("rtt_condense_k3", 4, 15)):
            f = getattr(lib, fn)
            f.argtypes = [I] * n_int + [P] * n_ptr + [L, P]
            f.restype = I
        lib._rtt_typed = True
    return lib


def _launch(name, fn, dims, ins, outs):
    """Call C function `fn`(dtype, *dims, pointers..., S, stream) and raise
    on what it returns: -1 for dims/dtype it was not built for, else a
    cudaGetLastError() code."""
    ref = ins[0]
    rc = fn(kernels.DTYPE_CODE[ref.dtype], *dims,
            *[kernels.ptr(t) for t in ins + outs],
            ctypes.c_longlong(ref.shape[0]), kernels.stream(ref))
    if rc == -1:
        raise ValueError(f"{name}: no kernel for dims {dims} / {ref.dtype}; "
                         f"built for {KERNEL_DIMS}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _empty(ref, *shape):
    return torch.empty(shape, dtype=ref.dtype, device=ref.device)


def k1(M, J, inactive, Tw1, Tw2, r1, e2):
    """K1 on S stages -> (inv11, inv12, Sinv, G, c0)."""
    if M.device.type == "cpu":
        return k1_plain(M, J, inactive, Tw1, Tw2, r1, e2)
    S, nv, nf, w = M.shape[0], M.shape[-1], J.shape[-2], Tw1.shape[-1]
    ins = [M, J, inactive, Tw1, Tw2, r1, e2]
    kernels.check_args("k1", ins, [(S, nv, nv), (S, nf, nv), (S, nf),
                                   (S, nv, w), (S, nf, w), (S, nv), (S, nf)])
    outs = [_empty(M, S, nv, nv), _empty(M, S, nv, nf), _empty(M, S, nf, nf),
            _empty(M, S, nv + nf, w), _empty(M, S, nv + nf)]
    _launch("k1", _lib().rtt_condense_k1, (nv, nf, w), ins, outs)
    k1.launches += 1
    return tuple(outs)


def kc(dgdq, dgdf, d_cone):
    """Kc on S stages -> (coneHqq, coneHqf, coneHff)."""
    if dgdq.device.type == "cpu":
        return kc_plain(dgdq, dgdf, d_cone)
    S, nc, nv, nf = dgdq.shape[0], dgdq.shape[1], dgdq.shape[2], \
        dgdf.shape[2]
    ins = [dgdq, dgdf, d_cone]
    kernels.check_args("kc", ins, [(S, nc, nv), (S, nc, nf), (S, nc)])
    outs = [_empty(dgdq, S, nv, nv), _empty(dgdq, S, nv, nf),
            _empty(dgdq, S, nf, nf)]
    _launch("kc", _lib().rtt_condense_kc, (nv, nf, nc), ins, outs)
    kc.launches += 1
    return tuple(outs)


def k2(G, c0, Hq, Hv, Hu, Ha, Hf, coneHqf, gw, gy):
    """K2 on S stages -> (Qxx, Qxu, Quu, gtil)."""
    if G.device.type == "cpu":
        return k2_plain(G, c0, Hq, Hv, Hu, Ha, Hf, coneHqf, gw, gy)
    S, nv, nu, nf = G.shape[0], Hq.shape[-1], Hu.shape[-1], Hf.shape[-1]
    ny, w, nx = nv + nf, 2 * nv + nu, 2 * nv
    ins = [G, c0, Hq, Hv, Hu, Ha, Hf, coneHqf, gw, gy]
    kernels.check_args("k2", ins, [(S, ny, w), (S, ny), (S, nv, nv),
                                   (S, nv, nv), (S, nu, nu), (S, nv, nv),
                                   (S, nf, nf), (S, nv, nf), (S, w), (S, ny)])
    outs = [_empty(G, S, nx, nx), _empty(G, S, nx, nu), _empty(G, S, nu, nu),
            _empty(G, S, w)]
    _launch("k2", _lib().rtt_condense_k2, (nv, nu, nf), ins, outs)
    k2.launches += 1
    return tuple(outs)


def k3(G, c0, gtil, Aqq, Aqv, xres_q, Fv_res, sA, lam2, lmdgmm):
    """K3 on S stages -> (A, Bm, xres, lx, lu)."""
    if G.device.type == "cpu":
        return k3_plain(G, c0, gtil, Aqq, Aqv, xres_q, Fv_res, sA, lam2,
                        lmdgmm)
    S, ny, w, nv = G.shape[0], G.shape[1], G.shape[2], Aqq.shape[-1]
    nx, nf = 2 * nv, ny - nv
    nu = w - nx
    ins = [G, c0, gtil, Aqq, Aqv, xres_q, Fv_res, sA, lam2, lmdgmm]
    kernels.check_args("k3", ins, [(S, ny, w), (S, ny), (S, w), (S, nv, nv),
                                   (S, nv, nv), (S, nv), (S, nv), (S,),
                                   (S, nx), (S, nx)])
    outs = [_empty(G, S, nx, nx), _empty(G, S, nx, nu), _empty(G, S, nx),
            _empty(G, S, nx), _empty(G, S, nu)]
    _launch("k3", _lib().rtt_condense_k3, (nv, nu, nf), ins, outs)
    k3.launches += 1
    return tuple(outs)


WRAPPERS = (k1, kc, k2, k3)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


# ---------------------------------------------------------------------------
# The condense pipeline (counterpart of pallas_condense._condense_flat)
# ---------------------------------------------------------------------------

def condense(pre: dict, use_kernels: bool = True) -> dict:
    """Condense S stages. `pre` maps IN_NAMES to batch-first tensors;
    returns OUT_NAMES -> tensors. use_kernels=False forces the plain
    versions wherever the tensors live; True goes through the wrappers."""
    x = {n: pre[n].contiguous() for n in IN_NAMES}
    f1, fc_, f2, f3 = ((k1, kc, k2, k3) if use_kernels else
                       (k1_plain, kc_plain, k2_plain, k3_plain))
    inv11, inv12, Sinv, G, c0 = f1(x["M"], x["J"], x["inactive"], x["Tw1"],
                                   x["Tw2"], x["r1"], x["e2"])
    Hqq_c, Hqf_c, Hff_c = fc_(x["dgdq"], x["dgdf"], x["d_cone"])
    # diagonal-plane adds between Kc and K2 (plain tensor ops, as the JAX
    # package left them to XLA at pallas_condense.py:361-371)
    Hq = x["Wq"] + torch.diag_embed(x["Hq_d"]) + Hqq_c
    Hv = x["Wv"] + torch.diag_embed(x["Hv_d"])
    Hu = x["Wu"] + torch.diag_embed(x["Hu_d"])
    Ha = x["Wa"] + torch.diag_embed(x["Ha_d"])
    Hf = x["Wf"] + Hff_c
    Qxx, Qxu, Quu, gtil = f2(G, c0, Hq, Hv, Hu, Ha, Hf, Hqf_c, x["gw"],
                             x["gy"])
    A, Bm, xres, lx, lu = f3(G, c0, gtil, x["Aqq"], x["Aqv"], x["xres_q"],
                             x["Fv_res"], x["sA"], x["lam2"], x["lmdgmm"])
    return dict(inv11=inv11, inv12=inv12, Sinv=Sinv, G=G, c0=c0, A=A, Bm=Bm,
                xres=xres, Qxx=Qxx, Qxu=Qxu, Quu=Quu, lx=lx, lu=lu,
                coneHqf=Hqf_c, Hff_c=Hf)

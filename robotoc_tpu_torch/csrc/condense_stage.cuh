// Per-stage bodies of the four condense kernels (K1, Kc, K2, K3).
//
// Each `run` computes ONE stage from row-major per-stage blocks, with a
// workspace of WS scalars (shared memory on the card, a host buffer in
// csrc/host_shim.cpp). They replace the Pallas kernels of robotoc_tpu
// ops/pallas_condense.py and keep their numerics: unpivoted Gauss-Jordan,
// the same symmetrisations, the same order of additions. Dims:
// NV (tangent), NU (actuated), NF (contact force rows), NC (cone rows),
// W = 2 NV + NU, NY = NV + NF, NX = 2 NV.
#pragma once

#include "stage_algebra.cuh"

namespace rtt {

// K1 (_k1_kernel): contact KKT block [[M, J^T], [J, -diag(inactive)]],
// its inverse Psi, the symmetrised blocks inv11, inv12, Sinv, and
// G = Psi [Tw1; Tw2], c0 = Psi [r1; e2] with the first NV rows negated.
template <typename T, int NV, int NF, int W>
struct K1Stage {
  static constexpr int NY = NV + NF;
  static constexpr int WS = NY * NY + NY * W + NY;

  static RTT_HD void run(const T* M, const T* J, const T* inact,
                         const T* Tw1, const T* Tw2, const T* r1,
                         const T* e2, T* inv11, T* inv12, T* Sinv, T* G,
                         T* c0, T* ws, int tid, int nt) {
    T* Psi = ws;
    T* Tw = Psi + NY * NY;
    T* e = Tw + NY * W;
    for (int x = tid; x < NY * NY; x += nt) {
      const int i = x / NY, j = x % NY;
      T val;
      if (i < NV)
        val = (j < NV) ? M[i * NV + j] : J[(j - NV) * NV + i];
      else
        val = (j < NV) ? J[(i - NV) * NV + j]
                       : (i == j ? -inact[i - NV] : T(0));
      Psi[x] = val;
    }
    copy(Tw, Tw1, NV * W, tid, nt);
    copy(Tw + NV * W, Tw2, NF * W, tid, nt);
    copy(e, r1, NV, tid, nt);
    copy(e + NV, e2, NF, tid, nt);
    block_sync();
    gauss_jordan<T, NY>(Psi, NY, tid, nt);
    for (int x = tid; x < NV * NV; x += nt) {
      const int i = x / NV, j = x % NV;
      inv11[x] = T(0.5) * (Psi[i * NY + j] + Psi[j * NY + i]);
    }
    for (int x = tid; x < NV * NF; x += nt) {
      const int i = x / NF, j = x % NF;
      inv12[x] = T(0.5) * (Psi[i * NY + NV + j] + Psi[(NV + j) * NY + i]);
    }
    for (int x = tid; x < NF * NF; x += nt) {
      const int i = x / NF, j = x % NF;
      Sinv[x] = T(0.5) * (-Psi[(NV + i) * NY + NV + j]
                          + -Psi[(NV + j) * NY + NV + i]);
    }
    for (int x = tid; x < NY * W; x += nt) {
      const int i = x / W, j = x % W;
      T acc = T(0);
      for (int k = 0; k < NY; ++k) acc += Psi[i * NY + k] * Tw[k * W + j];
      G[x] = (i < NV) ? -acc : acc;
    }
    for (int i = tid; i < NY; i += nt) {
      T acc = T(0);
      for (int k = 0; k < NY; ++k) acc += Psi[i * NY + k] * e[k];
      c0[i] = (i < NV) ? -acc : acc;
    }
  }
};

// Kc (_kc_kernel): cone Gauss-Newton blocks sum_r d_r dg_r (x) dg_r.
template <typename T, int NV, int NF, int NC>
struct KcStage {
  static constexpr int WS = NC * NV + NC * NF + NC;

  static RTT_HD void run(const T* dgdq, const T* dgdf, const T* dcone,
                         T* Hqq, T* Hqf, T* Hff, T* ws, int tid, int nt) {
    T* gq = ws;
    T* gf = gq + NC * NV;
    T* d = gf + NC * NF;
    copy(gq, dgdq, NC * NV, tid, nt);
    copy(gf, dgdf, NC * NF, tid, nt);
    copy(d, dcone, NC, tid, nt);
    block_sync();
    for (int x = tid; x < NV * NV; x += nt) {
      const int i = x / NV, j = x % NV;
      T acc = T(0);
      for (int r = 0; r < NC; ++r)
        acc += (d[r] * gq[r * NV + i]) * gq[r * NV + j];
      Hqq[x] = acc;
    }
    for (int x = tid; x < NV * NF; x += nt) {
      const int i = x / NF, j = x % NF;
      T acc = T(0);
      for (int r = 0; r < NC; ++r)
        acc += (d[r] * gq[r * NV + i]) * gf[r * NF + j];
      Hqf[x] = acc;
    }
    for (int x = tid; x < NF * NF; x += nt) {
      const int i = x / NF, j = x % NF;
      T acc = T(0);
      for (int r = 0; r < NC; ++r)
        acc += (d[r] * gf[r * NF + i]) * gf[r * NF + j];
      Hff[x] = acc;
    }
  }
};

// K2 (_k2_kernel): condensed quadratic over w = (dq, dv, du):
//   Htil = blockdiag(Hq, Hv, Hu) + Cxp + Cxp^T + G^T Hy G,
//   Hy = blockdiag(Ha, Hf), Cxp = [coneHqf Gf; 0],
//   gtil = gw + [coneHqf c0f; 0] + G^T (Hy c0 + gy).
template <typename T, int NV, int NU, int NF>
struct K2Stage {
  static constexpr int W = 2 * NV + NU, NY = NV + NF, NX = 2 * NV;
  static constexpr int WS = 2 * NY * W + NV * W + NV * NV + NF * NF
                            + NV * NF + 3 * NY + NV;

  static RTT_HD void run(const T* Gg, const T* c0g, const T* Hq,
                         const T* Hv, const T* Hu, const T* Hag,
                         const T* Hfg, const T* cHqfg, const T* gw,
                         const T* gyg, T* Qxx, T* Qxu, T* Quu, T* gtil,
                         T* ws, int tid, int nt) {
    T* G = ws;
    T* HyG = G + NY * W;
    T* CwyG = HyG + NY * W;
    T* Ha = CwyG + NV * W;
    T* Hf = Ha + NV * NV;
    T* cHqf = Hf + NF * NF;
    T* c0 = cHqf + NV * NF;
    T* gy = c0 + NY;
    T* hy0 = gy + NY;
    T* Cc0 = hy0 + NY;
    copy(G, Gg, NY * W, tid, nt);
    copy(c0, c0g, NY, tid, nt);
    copy(Ha, Hag, NV * NV, tid, nt);
    copy(Hf, Hfg, NF * NF, tid, nt);
    copy(cHqf, cHqfg, NV * NF, tid, nt);
    copy(gy, gyg, NY, tid, nt);
    block_sync();
    const T* Gf = G + NV * W;
    gemm<T, NV, W, NV, false, false>(HyG, W, Ha, NV, G, W, nullptr, 0,
                                     T(1), tid, nt);
    gemm<T, NF, W, NF, false, false>(HyG + NV * W, W, Hf, NF, Gf, W,
                                     nullptr, 0, T(1), tid, nt);
    gemm<T, NV, W, NF, false, false>(CwyG, W, cHqf, NF, Gf, W, nullptr, 0,
                                     T(1), tid, nt);
    gemv<T, NV, NV, false>(hy0, Ha, NV, c0, gy, T(1), tid, nt);
    gemv<T, NF, NF, false>(hy0 + NV, Hf, NF, c0 + NV, gy + NV, T(1), tid,
                           nt);
    gemv<T, NV, NF, false>(Cc0, cHqf, NF, c0 + NV, nullptr, T(1), tid, nt);
    block_sync();
    for (int x = tid; x < NX * NX; x += nt) {
      const int i = x / NX, j = x % NX;
      T acc = T(0);
      for (int k = 0; k < NY; ++k) acc += G[k * W + i] * HyG[k * W + j];
      const T cx = (i < NV) ? CwyG[i * W + j] : T(0);
      const T cxt = (j < NV) ? CwyG[j * W + i] : T(0);
      T bd = T(0);
      if (i < NV && j < NV) bd = Hq[i * NV + j];
      if (i >= NV && j >= NV) bd = Hv[(i - NV) * NV + (j - NV)];
      Qxx[x] = ((acc + cx) + cxt) + bd;
    }
    for (int x = tid; x < NX * NU; x += nt) {
      const int i = x / NU, j = x % NU;
      T acc = T(0);
      for (int k = 0; k < NY; ++k) acc += G[k * W + i] * HyG[k * W + NX + j];
      Qxu[x] = acc + ((i < NV) ? CwyG[i * W + NX + j] : T(0));
    }
    for (int x = tid; x < NU * NU; x += nt) {
      const int i = x / NU, j = x % NU;
      T acc = T(0);
      for (int k = 0; k < NY; ++k)
        acc += G[k * W + NX + i] * HyG[k * W + NX + j];
      Quu[x] = acc + Hu[x];
    }
    for (int j = tid; j < W; j += nt) {
      T acc = T(0);
      for (int k = 0; k < NY; ++k) acc += G[k * W + j] * hy0[k];
      gtil[j] = (gw[j] + ((j < NV) ? Cc0[j] : T(0))) + acc;
    }
  }
};

// K3 (_k3_kernel): LQR blocks from the condensed acceleration rows
//   A = [[Aqq, Aqv], [sA Gq, I + sA Gv]], Bm = [0; sA Gu],
//   xres = [xres_q; Fv_res + sA c0a],
//   lx = gtil_x + A^T lam2 - lmdgmm, lu = gtil_u + Bm^T lam2.
template <typename T, int NV, int NU, int NF>
struct K3Stage {
  static constexpr int W = 2 * NV + NU, NX = 2 * NV;
  static constexpr int WS = NX * NX + NX * NU + NX;

  static RTT_HD void run(const T* G, const T* c0, const T* gtil,
                         const T* Aqq, const T* Aqv, const T* xres_q,
                         const T* Fv_res, const T* sAp, const T* lam2g,
                         const T* lmdgmm, T* Ag, T* Bg, T* xres, T* lx,
                         T* lu, T* ws, int tid, int nt) {
    T* A = ws;
    T* Bm = A + NX * NX;
    T* lam2 = Bm + NX * NU;
    const T sA = sAp[0];
    for (int x = tid; x < NX * NX; x += nt) {
      const int i = x / NX, j = x % NX;
      T val;
      if (i < NV) {
        val = (j < NV) ? Aqq[i * NV + j] : Aqv[i * NV + (j - NV)];
      } else {
        const T g = sA * G[(i - NV) * W + j];
        val = (j < NV) ? g : ((i == j ? T(1) : T(0)) + g);
      }
      A[x] = val;
      Ag[x] = val;
    }
    for (int x = tid; x < NX * NU; x += nt) {
      const int i = x / NU, j = x % NU;
      const T val = (i < NV) ? T(0) : sA * G[(i - NV) * W + NX + j];
      Bm[x] = val;
      Bg[x] = val;
    }
    for (int i = tid; i < NX; i += nt)
      xres[i] = (i < NV) ? xres_q[i] : Fv_res[i - NV] + sA * c0[i - NV];
    copy(lam2, lam2g, NX, tid, nt);
    block_sync();
    for (int j = tid; j < NX; j += nt) {
      T acc = T(0);
      for (int i = 0; i < NX; ++i) acc += A[i * NX + j] * lam2[i];
      lx[j] = (gtil[j] + acc) - lmdgmm[j];
    }
    for (int j = tid; j < NU; j += nt) {
      T acc = T(0);
      for (int i = 0; i < NX; ++i) acc += Bm[i * NU + j] * lam2[i];
      lu[j] = gtil[NX + j] + acc;
    }
  }
};

}  // namespace rtt

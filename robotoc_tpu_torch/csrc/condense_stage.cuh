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

// n rounded up to whole 16-byte runs of float or double (4 entries)
constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// Kc (_kc_kernel): cone Gauss-Newton blocks sum_r d_r g_r g_r^T over the
// NC cone rows g_r = [dgdq_r | dgdf_r] (NX = NV + NF wide): the NV x NV,
// NV x NF and NF x NF blocks of the symmetric NX x NX sum. A team of nl
// lanes works on one stage (a warp on the card, one lane on the host),
// every barrier the team's:
//  * the stage's rows and d, contiguous in device memory, are staged in
//    its workspace by 16-byte cp.async copies;
//  * the upper triangle of the sum in TB x TB tiles, a tile per lane at a
//    time, the row factor d_r g_ri formed in registers; each entry and its
//    mirror are written into the workspace's copy of the three outputs by
//    the lane that computed it (the lower-left NF x NV block is no output);
//  * the outputs leave in 16-byte stores, neighbouring lanes on
//    neighbouring addresses.
template <typename T, int NV, int NF, int NC>
struct KcStage {
  static constexpr int NX = NV + NF, TB = 3;
  static_assert(NV % TB == 0 && NF % TB == 0, "tiles split q and f");
  static constexpr int NB = NX / TB, NQB = NV / TB;
  static constexpr int NTILE = NB * (NB + 1) / 2;   // upper triangle
  // workspace (scalars), every part 16-byte aligned in f32 and f64
  static constexpr int O_GQ = 0, O_GF = up4(NC * NV), O_D = O_GF + up4(NC * NF);
  static constexpr int O_HQQ = O_D + up4(NC), O_HQF = O_HQQ + up4(NV * NV);
  static constexpr int O_HFF = O_HQF + up4(NV * NF);
  static constexpr int WS = O_HFF + up4(NF * NF);

  // entry (i, j) of the sum, i <= j, and its mirror, into the outputs
  static RTT_HD void put(T* ws, int i, int j, T x) {
    if (j < NV) {
      ws[O_HQQ + i * NV + j] = x;
      ws[O_HQQ + j * NV + i] = x;
    } else if (i < NV) {
      ws[O_HQF + i * NF + (j - NV)] = x;
    } else {
      ws[O_HFF + (i - NV) * NF + (j - NV)] = x;
      ws[O_HFF + (j - NV) * NF + (i - NV)] = x;
    }
  }

  static RTT_HD void run(const T* dgdq, const T* dgdf, const T* dcone,
                         T* Hqq, T* Hqf, T* Hff, T* ws, int lane, int nl) {
    async_copy(ws + O_GQ, dgdq, NC * NV, lane, nl);
    async_copy(ws + O_GF, dgdf, NC * NF, lane, nl);
    async_copy(ws + O_D, dcone, NC, lane, nl);
    async_commit();
    async_wait_all();
    warp_sync();
    const T* d = ws + O_D;
    for (int t = lane; t < NTILE; t += nl) {
      int I = 0, rem = t;   // tile t of the upper triangle, row by row
      while (rem >= NB - I) {
        rem -= NB - I;
        ++I;
      }
      const int J = I + rem;
      const T* pa = I < NQB ? ws + O_GQ + TB * I : ws + O_GF + TB * (I - NQB);
      const T* pb = J < NQB ? ws + O_GQ + TB * J : ws + O_GF + TB * (J - NQB);
      const int sa = I < NQB ? NV : NF, sb = J < NQB ? NV : NF;
      T acc[TB][TB];
      for (int m = 0; m < TB; ++m)
        for (int n = 0; n < TB; ++n) acc[m][n] = T(0);
      for (int r = 0; r < NC; ++r) {
        const T dr = d[r];
        T a[TB], b[TB];
        for (int m = 0; m < TB; ++m) a[m] = dr * pa[r * sa + m];
        for (int n = 0; n < TB; ++n) b[n] = pb[r * sb + n];
        for (int m = 0; m < TB; ++m)
          for (int n = 0; n < TB; ++n) acc[m][n] += a[m] * b[n];
      }
      for (int m = 0; m < TB; ++m)
        for (int n = (I == J ? m : 0); n < TB; ++n)
          put(ws, TB * I + m, TB * J + n, acc[m][n]);
    }
    warp_sync();
    store_wide(Hqq, ws + O_HQQ, NV * NV, lane, nl);
    store_wide(Hqf, ws + O_HQF, NV * NF, lane, nl);
    store_wide(Hff, ws + O_HFF, NF * NF, lane, nl);
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

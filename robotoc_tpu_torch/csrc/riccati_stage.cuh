// Per-scenario body of the Riccati backward-sweep kernel (K5).
//
// Replaces robotoc_tpu riccati/pallas_scan.py:_bwd_kernel. There the TPU
// grid's sequential axis walked the horizon and the value function lived
// in VMEM scratch between grid steps; here one thread block owns one
// scenario and walks its N steps in reverse inside a loop, with (P, p)
// in shared memory. Each step follows the Pallas step exactly:
//   F = Qxx + A^T P A, H = Qxu + A^T P B, G = Quu + B^T P B,
//   Ginv by unpivoted Gauss-Jordan, K = -Ginv H^T, k = -Ginv gu,
//   and with NF > 0 the masked switching Schur branch (S, Sinv, Mx, mx).
#pragma once

#include "stage_algebra.cuh"

namespace rtt {

template <typename T, int NX, int NU, int NF>
struct RiccatiBwd {
  static constexpr int WS = 4 * NX * NX + 4 * NX * NU + NU * NU + 3 * NX
                            + 2 * NU + 3 * NF * NX + 2 * NF * NU + NF * NF
                            + 3 * NF;

  // Pointers address one scenario: per-step arrays hold N consecutive
  // blocks. Phix/Phiu/Pc/sw and Mx/mx are used only when NF > 0.
  static RTT_HD void run(int N, const T* A, const T* B, const T* xres,
                         const T* Qxx, const T* Qxu, const T* Quu,
                         const T* lx, const T* lu, const T* Phix,
                         const T* Phiu, const T* Pc, const T* sw,
                         const T* QxxN, const T* lxN, T* Ko, T* ko, T* Po,
                         T* po, T* Mxo, T* mxo, T* ws, int tid, int nt) {
    T* Pn = ws;                 // NX*NX value Hessian of step i+1
    T* pn = Pn + NX * NX;       // NX
    T* As = pn + NX;            // NX*NX
    T* Bs = As + NX * NX;       // NX*NU
    T* AtP = Bs + NX * NU;      // NX*NX
    T* F = AtP + NX * NX;       // NX*NX
    T* H = F + NX * NX;         // NX*NU
    T* BtP = H + NX * NU;       // NU*NX
    T* Gm = BtP + NU * NX;      // NU*NU, inverted in place
    T* Ks = Gm + NU * NU;       // NU*NX
    T* ks = Ks + NU * NX;       // NU
    T* Pxr = ks + NU;           // NX
    T* gu = Pxr + NX;           // NU
    T* lxt = gu + NU;           // NX
    T* Phx = lxt + NX;          // NF*NX
    T* Phu = Phx + NF * NX;     // NF*NU
    T* sws = Phu + NF * NU;     // NF
    T* GiPT = sws + NF;         // NU*NF   Ginv Phiu^T
    T* Sm = GiPT + NU * NF;     // NF*NF   Schur block, inverted in place
    T* Tx = Sm + NF * NF;       // NF*NX   (Phiu K + Phix) * sw
    T* tx = Tx + NF * NX;       // NF      (Phiu k + Pc) * sw
    T* Mxs = tx + NF;           // NF*NX
    T* mxs = Mxs + NF * NX;     // NF

    for (int x = tid; x < NX * NX; x += nt) {
      const int i = x / NX, j = x % NX;
      Pn[x] = T(0.5) * (QxxN[x] + QxxN[j * NX + i]);
    }
    copy(pn, lxN, NX, tid, nt);
    block_sync();

    for (int step = N - 1; step >= 0; --step) {
      const long long o = step;
      copy(As, A + o * NX * NX, NX * NX, tid, nt);
      copy(Bs, B + o * NX * NU, NX * NU, tid, nt);
      if constexpr (NF > 0) {
        copy(Phx, Phix + o * NF * NX, NF * NX, tid, nt);
        copy(Phu, Phiu + o * NF * NU, NF * NU, tid, nt);
        copy(sws, sw + o * NF, NF, tid, nt);
      }
      block_sync();
      gemm<T, NX, NX, NX, true, false>(AtP, NX, As, NX, Pn, NX, nullptr, 0,
                                       T(1), tid, nt);
      gemm<T, NU, NX, NX, true, false>(BtP, NX, Bs, NU, Pn, NX, nullptr, 0,
                                       T(1), tid, nt);
      gemv<T, NX, NX, false>(Pxr, Pn, NX, xres + o * NX, pn, T(1), tid, nt);
      block_sync();
      gemm<T, NX, NX, NX, false, false>(F, NX, AtP, NX, As, NX,
                                        Qxx + o * NX * NX, NX, T(1), tid, nt);
      gemm<T, NX, NU, NX, false, false>(H, NU, AtP, NX, Bs, NU,
                                        Qxu + o * NX * NU, NU, T(1), tid, nt);
      gemm<T, NU, NU, NX, false, false>(Gm, NU, BtP, NX, Bs, NU,
                                        Quu + o * NU * NU, NU, T(1), tid, nt);
      gemv<T, NU, NX, true>(gu, Bs, NU, Pxr, lu + o * NU, T(1), tid, nt);
      gemv<T, NX, NX, true>(lxt, As, NX, Pxr, lx + o * NX, T(1), tid, nt);
      block_sync();
      gauss_jordan<T, NU>(Gm, NU, tid, nt);
      gemm<T, NU, NX, NU, false, true>(Ks, NX, Gm, NU, H, NU, nullptr, 0,
                                       T(-1), tid, nt);
      gemv<T, NU, NU, false>(ks, Gm, NU, gu, nullptr, T(-1), tid, nt);
      block_sync();
      if constexpr (NF > 0) {
        gemm<T, NU, NF, NU, false, true>(GiPT, NF, Gm, NU, Phu, NU, nullptr,
                                         0, T(1), tid, nt);
        for (int x = tid; x < NF * NX; x += nt) {
          const int i = x / NX, j = x % NX;
          T acc = T(0);
          for (int k = 0; k < NU; ++k) acc += Phu[i * NU + k] * Ks[k * NX + j];
          Tx[x] = (acc + Phx[x]) * sws[i];
        }
        for (int i = tid; i < NF; i += nt) {
          T acc = T(0);
          for (int k = 0; k < NU; ++k) acc += Phu[i * NU + k] * ks[k];
          tx[i] = (acc + Pc[o * NF + i]) * sws[i];
        }
        block_sync();
        for (int x = tid; x < NF * NF; x += nt) {
          const int i = x / NF, j = x % NF;
          T acc = T(0);
          for (int k = 0; k < NU; ++k)
            acc += Phu[i * NU + k] * GiPT[k * NF + j];
          Sm[x] = acc * (sws[i] * sws[j])
                  + (i == j ? (T(1) - sws[i]) : T(0));
        }
        block_sync();
        gauss_jordan<T, NF>(Sm, NF, tid, nt);
        gemm<T, NF, NX, NF, false, false>(Mxs, NX, Sm, NF, Tx, NX, nullptr,
                                          0, T(1), tid, nt);
        gemv<T, NF, NF, false>(mxs, Sm, NF, tx, nullptr, T(1), tid, nt);
        block_sync();
        gemm<T, NU, NX, NF, false, false>(Ks, NX, GiPT, NF, Mxs, NX, Ks, NX,
                                          T(-1), tid, nt);
        gemv<T, NU, NF, false>(ks, GiPT, NF, mxs, ks, T(-1), tid, nt);
        block_sync();
        for (int x = tid; x < NX * NX; x += nt) {
          const int i = x / NX, j = x % NX;
          T hk = T(0), pm = T(0);
          for (int k = 0; k < NU; ++k) hk += H[i * NU + k] * Ks[k * NX + j];
          for (int k = 0; k < NF; ++k) pm += Phx[k * NX + i] * Mxs[k * NX + j];
          F[x] = (F[x] + hk) + pm;
        }
        for (int i = tid; i < NX; i += nt) {
          T hk = T(0), pm = T(0);
          for (int k = 0; k < NU; ++k) hk += H[i * NU + k] * ks[k];
          for (int k = 0; k < NF; ++k) pm += Phx[k * NX + i] * mxs[k];
          pn[i] = (lxt[i] + hk) + pm;
        }
        copy(Mxo + o * NF * NX, Mxs, NF * NX, tid, nt);
        copy(mxo + o * NF, mxs, NF, tid, nt);
      } else {
        gemm<T, NX, NX, NU, false, false>(F, NX, H, NU, Ks, NX, F, NX, T(1),
                                          tid, nt);
        gemv<T, NX, NU, false>(pn, H, NU, ks, lxt, T(1), tid, nt);
      }
      block_sync();
      for (int x = tid; x < NX * NX; x += nt) {
        const int i = x / NX, j = x % NX;
        const T val = T(0.5) * (F[x] + F[j * NX + i]);
        Pn[x] = val;
        Po[o * NX * NX + x] = val;
      }
      copy(po + o * NX, pn, NX, tid, nt);
      copy(Ko + o * NU * NX, Ks, NU * NX, tid, nt);
      copy(ko + o * NU, ks, NU, tid, nt);
      block_sync();
    }
  }
};

}  // namespace rtt

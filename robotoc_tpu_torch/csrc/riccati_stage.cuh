// Per-scenario body of the Riccati backward-sweep kernel (K5).
//
// Replaces robotoc_tpu riccati/pallas_scan.py:_bwd_kernel. There the TPU
// grid's sequential axis walked the horizon and the value function lived
// in VMEM scratch between grid steps; here one thread block owns one
// scenario and walks its N steps in reverse inside a loop, with (P, p)
// in shared memory. Each step follows the Pallas step:
//   F = Qxx + A^T P A, H = Qxu + A^T P B, G = Quu + B^T P B,
//   Ginv by unpivoted Gauss-Jordan, K = -Ginv H^T, k = -Ginv gu,
//   and with NF > 0 the masked switching Schur branch (S, Sinv, Mx, mx).
//
// Design, what bounds it and why: the steps of a scenario depend on each
// other, so the sweep's time is N times a step's latency, and a step is a
// chain of small dependent products. The step therefore touches device
// memory only off its critical path and keeps its barriers few:
//  * its inputs arrive before it starts: while step i computes, cp.async
//    brings step i - 1's blocks into the other of two shared-memory
//    buffers (A beside B as one 36 x 48 operand, Qxx beside Qxu), and the
//    step waits for its own buffer once, at its first barrier;
//  * the products are register-tiled (a thread computes a 2 x 2 tile of
//    the output: 4 shared loads per 4 multiply-adds), 512 threads a block:
//    X = [A B]^T P, then [F H] = X_A [A B] + [Qxx Qxu] and G = X_B B + Quu
//    in one phase, the gradients beside them;
//  * the 12 x 12 inversions (Quu's and the switching Schur block) run in
//    one warp, a row per lane and the pivot row by shuffles, with no
//    barrier inside; K and the Schur terms with all threads;
//  * P is symmetrised as it is formed (a thread forms P_ij and P_ji), and
//    each output is stored by the thread that computes it.
// Per step: 5 block barriers without switching rows, 9 with them (the
// redesign took them from about 30 and 58).
#pragma once

#include "stage_algebra.cuh"

namespace rtt {

template <typename T, int NX, int NU, int NF>
struct RiccatiBwd {
  static constexpr int NW = NX + NU;            // [A B], [Qxx Qxu] width
  static constexpr int LY = NW + 1;   // [F H]'s row stride: odd, so that
                                      // a column's reads hit distinct banks
  // the products' tiles (2 x 2 outputs a thread) and the threads each
  // phase's first product leaves to the next
  static constexpr int TX = (NW / 2) * (NX / 2), TY = (NX / 2) * (NW / 2);
  static constexpr int TK = (NU / 2) * (NX / 2), TG = (NU / 2) * (NU / 2);
  static RTT_HD constexpr int pad(int n) { return (n + 3) / 4 * 4; }
  // one step's inputs (a buffer; two of them alternate)
  static constexpr int B_AB = 0;                     // NX x NW
  static constexpr int B_Q = B_AB + pad(NX * NW);    // NX x NW
  static constexpr int B_QUU = B_Q + pad(NX * NW);   // NU x NU
  static constexpr int B_XR = B_QUU + pad(NU * NU);  // NX
  static constexpr int B_L = B_XR + pad(NX);         // NW: lx | lu
  static constexpr int B_PHX = B_L + pad(NW);        // NF x NX
  static constexpr int B_PHU = B_PHX + pad(NF * NX);  // NF x NU
  static constexpr int B_PC = B_PHU + pad(NF * NU);  // NF
  static constexpr int B_SW = B_PC + pad(NF);        // NF
  static constexpr int BUF = B_SW + pad(NF);
  // the step's work
  static constexpr int W_P = 2 * BUF;                // NX x NX, P of i+1
  static constexpr int W_PV = W_P + pad(NX * NX);    // NX
  static constexpr int W_X = W_PV + pad(NX);         // NW x NX
  static constexpr int W_Y = W_X + pad(NW * NX);     // NX x LY: F | H
  static constexpr int W_G = W_Y + pad(NX * LY);     // NU x NU, inverted
  static constexpr int W_PXR = W_G + pad(NU * NU);   // NX
  static constexpr int W_GL = W_PXR + pad(NX);       // NW: lxt | gu
  static constexpr int W_K = W_GL + pad(NW);         // NU x NX
  static constexpr int W_KV = W_K + pad(NU * NX);    // NU
  static constexpr int W_GIP = W_KV + pad(NU);       // NU x NF
  static constexpr int W_TX = W_GIP + pad(NU * NF);  // NF x NX
  static constexpr int W_TV = W_TX + pad(NF * NX);   // NF
  static constexpr int W_S = W_TV + pad(NF);         // NF x NF, inverted
  static constexpr int W_MX = W_S + pad(NF * NF);    // NF x NX
  static constexpr int W_MV = W_MX + pad(NF * NX);   // NF
  static constexpr int WS = W_MV + pad(NF);

  // the first thread of each of fetch's copies: the copies before it
  // (async_copies), so that each starts on the threads the others leave
  static constexpr int F_B = async_copies<T, NX, NX, NW, NX>();
  static constexpr int F_QXX = F_B + async_copies<T, NX, NU, NW, NU>();
  static constexpr int F_QXU = F_QXX + async_copies<T, NX, NX, NW, NX>();
  static constexpr int F_QUU = F_QXU + async_copies<T, NX, NU, NW, NU>();
  static constexpr int F_XR = F_QUU + async_copies<T, NU, NU, NU, NU>();
  static constexpr int F_LX = F_XR + async_copies<T, 1, NX, NX, NX>();
  static constexpr int F_LU = F_LX + async_copies<T, 1, NX, NW, NX>();
  static constexpr int F_PHX = F_LU + async_copies<T, 1, NU, NW, NU>();
  static constexpr int F_PHU = F_PHX + async_copies<T, NF, NX, NX, NX>();
  static constexpr int F_PC = F_PHU + async_copies<T, NF, NU, NU, NU>();
  static constexpr int F_SW = F_PC + async_copies<T, 1, NF, NF, NF>();

  // step o's blocks into buffer bf, without waiting
  static RTT_HD void fetch(T* bf, long long o, const T* A, const T* B,
                           const T* xres, const T* Qxx, const T* Qxu,
                           const T* Quu, const T* lx, const T* lu,
                           const T* Phix, const T* Phiu, const T* Pc,
                           const T* sw, int tid, int nt) {
    async_rows<T, NX, NX, NW, NX>(bf + B_AB, A + o * NX * NX, tid, nt);
    async_rows<T, NX, NU, NW, NU>(bf + B_AB + NX, B + o * NX * NU,
                                  rot(tid, F_B, nt), nt);
    async_rows<T, NX, NX, NW, NX>(bf + B_Q, Qxx + o * NX * NX,
                                  rot(tid, F_QXX, nt), nt);
    async_rows<T, NX, NU, NW, NU>(bf + B_Q + NX, Qxu + o * NX * NU,
                                  rot(tid, F_QXU, nt), nt);
    async_rows<T, NU, NU, NU, NU>(bf + B_QUU, Quu + o * NU * NU,
                                  rot(tid, F_QUU, nt), nt);
    async_rows<T, 1, NX, NX, NX>(bf + B_XR, xres + o * NX,
                                 rot(tid, F_XR, nt), nt);
    async_rows<T, 1, NX, NW, NX>(bf + B_L, lx + o * NX, rot(tid, F_LX, nt),
                                 nt);
    async_rows<T, 1, NU, NW, NU>(bf + B_L + NX, lu + o * NU,
                                 rot(tid, F_LU, nt), nt);
    if constexpr (NF > 0) {
      async_rows<T, NF, NX, NX, NX>(bf + B_PHX, Phix + o * NF * NX,
                                    rot(tid, F_PHX, nt), nt);
      async_rows<T, NF, NU, NU, NU>(bf + B_PHU, Phiu + o * NF * NU,
                                    rot(tid, F_PHU, nt), nt);
      async_rows<T, 1, NF, NF, NF>(bf + B_PC, Pc + o * NF, rot(tid, F_PC, nt),
                                   nt);
      async_rows<T, 1, NF, NF, NF>(bf + B_SW, sw + o * NF, rot(tid, F_SW, nt),
                                   nt);
    }
    async_commit();
  }

  // P = 0.5 (P' + P'^T) with P'_ij = F_ij + sum_k H_ik K_kj (+ Phix^T Mx
  // with switching rows), formed a pair (ij, ji) per thread into the next
  // step's P and the output; p = lxt + H k (+ Phix^T mx)
  static RTT_HD void value_update(T* ws, const T* bf, T* Po, T* po, int tid,
                                  int nt) {
    const T* Y = ws + W_Y;
    const T* K = ws + W_K;
    const T* Mx = ws + W_MX;
    const T* Phx = bf + B_PHX;
    T* P = ws + W_P;
    for (int e = tid; e < NX * NX + NX; e += nt) {
      if (e >= NX * NX) {
        const int i = e - NX * NX;
        T hk = T(0), pm = T(0);
        for (int k = 0; k < NU; ++k) hk += Y[i * LY + NX + k] * ws[W_KV + k];
        for (int k = 0; k < NF; ++k) pm += Phx[k * NX + i] * ws[W_MV + k];
        const T x = (ws[W_GL + i] + hk) + pm;
        ws[W_PV + i] = x;
        po[i] = x;
        continue;
      }
      const int i = e / NX, j = e % NX;
      if (j < i) continue;
      T hij = T(0), hji = T(0), pij = T(0), pji = T(0);
      for (int k = 0; k < NU; ++k) {
        hij += Y[i * LY + NX + k] * K[k * NX + j];
        hji += Y[j * LY + NX + k] * K[k * NX + i];
      }
      for (int k = 0; k < NF; ++k) {
        pij += Phx[k * NX + i] * Mx[k * NX + j];
        pji += Phx[k * NX + j] * Mx[k * NX + i];
      }
      const T val = T(0.5) * (((Y[i * LY + j] + hij) + pij)
                              + ((Y[j * LY + i] + hji) + pji));
      P[i * NX + j] = val;
      P[j * NX + i] = val;
      Po[i * NX + j] = val;
      Po[j * NX + i] = val;
    }
  }

  // Pointers address one scenario: per-step arrays hold N consecutive
  // blocks. Phix/Phiu/Pc/sw and Mx/mx are used only when NF > 0.
  static RTT_HD void run(int N, const T* A, const T* B, const T* xres,
                         const T* Qxx, const T* Qxu, const T* Quu,
                         const T* lx, const T* lu, const T* Phix,
                         const T* Phiu, const T* Pc, const T* sw,
                         const T* QxxN, const T* lxN, T* Ko, T* ko, T* Po,
                         T* po, T* Mxo, T* mxo, T* ws, int tid, int nt) {
    const int warp = tid / 32, lane = tid % 32, wl = nt < 32 ? nt : 32;
    T* P = ws + W_P;
    T* X = ws + W_X;
    T* Y = ws + W_Y;
    T* G = ws + W_G;
    T* K = ws + W_K;
    T* kv = ws + W_KV;
    fetch(ws, N - 1, A, B, xres, Qxx, Qxu, Quu, lx, lu, Phix, Phiu, Pc, sw,
          tid, nt);
    for (int x = tid; x < NX * NX; x += nt) {
      const int i = x / NX, j = x % NX;
      P[x] = T(0.5) * (QxxN[x] + QxxN[j * NX + i]);
    }
    copy(ws + W_PV, lxN, NX, tid, nt);
    for (int step = N - 1; step >= 0; --step) {
      const long long o = step;
      const T* bf = ws + BUF * ((N - 1 - step) & 1);
      async_wait_all();
      block_sync();
      if (step > 0)
        fetch(ws + BUF * ((N - step) & 1), o - 1, A, B, xres, Qxx, Qxu, Quu,
              lx, lu, Phix, Phiu, Pc, sw, tid, nt);
      // X = [A B]^T P; Pxr = P xres + p
      gemm_tiled<T, NW, NX, NX, 2, 2, true, false>(
          X, NX, bf + B_AB, NW, P, NX, nullptr, 0, T(1), tid, nt);
      gemv<T, NX, NX, false>(ws + W_PXR, P, NX, bf + B_XR, ws + W_PV, T(1),
                             rot(tid, TX, nt), nt);
      block_sync();
      // [F H] = X_A [A B] + [Qxx Qxu], G = X_B B + Quu,
      // [lxt gu] = [A B]^T Pxr + [lx lu]
      gemm_tiled<T, NX, NW, NX, 2, 2, false, false>(
          Y, LY, X, NX, bf + B_AB, NW, bf + B_Q, NW, T(1), tid, nt);
      gemm_tiled<T, NU, NU, NX, 2, 2, false, false>(
          G, NU, X + NX * NX, NX, bf + B_AB + NX, NW, bf + B_QUU, NU, T(1),
          rot(tid, TY, nt), nt);
      gemv<T, NW, NX, true>(ws + W_GL, bf + B_AB, NW, ws + W_PXR, bf + B_L,
                            T(1), rot(tid, TY + TG, nt), nt);
      block_sync();
      if (warp == 0) gauss_jordan_warp<T, NU>(G, NU, lane, wl);
      block_sync();
      // K = -Ginv H^T, k = -Ginv gu (and Ginv Phiu^T)
      gemm_tiled<T, NU, NX, NU, 2, 2, false, true>(
          K, NX, G, NU, Y + NX, LY, nullptr, 0, T(-1), tid, nt);
      gemv<T, NU, NU, false>(kv, G, NU, ws + W_GL + NX, nullptr, T(-1),
                             rot(tid, TK + TG, nt), nt);
      if constexpr (NF > 0) {
        gemm_tiled<T, NU, NF, NU, 2, 2, false, true>(
            ws + W_GIP, NF, G, NU, bf + B_PHU, NU, nullptr, 0, T(1),
            rot(tid, TK, nt), nt);
        block_sync();
        switching(ws, bf, Mxo + o * NF * NX, mxo + o * NF, tid, nt);
      }
      block_sync();
      copy(Ko + o * NU * NX, K, NU * NX, tid, nt);
      copy(ko + o * NU, kv, NU, tid, nt);
      value_update(ws, bf, Po + o * NX * NX, po + o * NX, tid, nt);
    }
    async_wait_all();
  }

  // the switching Schur branch, after K, k and Ginv Phiu^T:
  //   S = (Phiu Ginv Phiu^T) * sw sw^T + diag(1 - sw),
  //   Mx = Sinv (Phiu K + Phix) * sw, mx = Sinv (Phiu k + Pc) * sw,
  //   K -= Ginv Phiu^T Mx, k -= Ginv Phiu^T mx
  static RTT_HD void switching(T* ws, const T* bf, T* Mxo, T* mxo, int tid,
                               int nt) {
    const int warp = tid / 32, lane = tid % 32, wl = nt < 32 ? nt : 32;
    const T* Phx = bf + B_PHX;
    const T* Phu = bf + B_PHU;
    const T* sws = bf + B_SW;
    const T* K = ws + W_K;
    const T* GiPT = ws + W_GIP;
    T* Tx = ws + W_TX;
    T* S = ws + W_S;
    for (int x = tid; x < NF * NX + NF + NF * NF; x += nt) {
      if (x < NF * NX) {
        const int i = x / NX, j = x % NX;
        T acc = T(0);
        for (int k = 0; k < NU; ++k) acc += Phu[i * NU + k] * K[k * NX + j];
        Tx[x] = (acc + Phx[x]) * sws[i];
      } else if (x < NF * NX + NF) {
        const int i = x - NF * NX;
        T acc = T(0);
        for (int k = 0; k < NU; ++k) acc += Phu[i * NU + k] * ws[W_KV + k];
        ws[W_TV + i] = (acc + bf[B_PC + i]) * sws[i];
      } else {
        const int e = x - NF * NX - NF, i = e / NF, j = e % NF;
        T acc = T(0);
        for (int k = 0; k < NU; ++k) acc += Phu[i * NU + k] * GiPT[k * NF + j];
        S[e] = acc * (sws[i] * sws[j]) + (i == j ? (T(1) - sws[i]) : T(0));
      }
    }
    block_sync();
    if (warp == 0) gauss_jordan_warp<T, NF>(S, NF, lane, wl);
    block_sync();
    gemm_tiled<T, NF, NX, NF, 2, 2, false, false>(
        ws + W_MX, NX, S, NF, Tx, NX, nullptr, 0, T(1), tid, nt);
    gemv<T, NF, NF, false>(ws + W_MV, S, NF, ws + W_TV, nullptr, T(1),
                           rot(tid, TK, nt), nt);
    block_sync();
    copy(Mxo, ws + W_MX, NF * NX, tid, nt);
    copy(mxo, ws + W_MV, NF, tid, nt);
    gemm_tiled<T, NU, NX, NF, 2, 2, false, false>(
        ws + W_K, NX, GiPT, NF, ws + W_MX, NX, ws + W_K, NX, T(-1), tid, nt);
    gemv<T, NU, NF, false>(ws + W_KV, GiPT, NF, ws + W_MV, ws + W_KV, T(-1),
                           rot(tid, TK, nt), nt);
  }
};

}  // namespace rtt

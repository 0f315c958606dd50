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

// n rounded up to whole 16-byte runs of float or double (4 entries)
constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// K1 (_k1_kernel): contact KKT block [[M, J^T], [J, -diag(inactive)]],
// its inverse Psi, the symmetrised blocks inv11, inv12, Sinv, and
// G = Psi [Tw1; Tw2], c0 = Psi [r1; e2] with the first NV rows negated.
// A team of nl lanes works on one stage (a warp on the card, one lane on
// the host), every barrier the team's:
//  * Tw1, Tw2 (as the NY x W block Tw, rows padded to LG), r1 and e2 are
//    staged in the workspace by cp.async while the team inverts;
//  * on the card lane i < NY reads row i of the KKT block from device
//    memory into registers and the warp inverts it (gauss_jordan_rows:
//    a warp barrier a pivot, the pivot row broadcast in 16-byte loads);
//    the host builds the block in the workspace and runs gauss_jordan;
//  * Psi's rows go to the workspace; lane i forms row i of G in register
//    chunks of GC columns, Tw's rows read as 16-byte broadcasts, and its
//    entry of c0; on the card G's rows are written over Tw's columns the
//    warp has read, and leave in 16-byte stores, lanes on neighbouring
//    addresses;
//  * inv11, inv12 and Sinv are formed from the workspace's Psi, V entries
//    a 16-byte store.
template <typename T, int NV, int NF, int W>
struct K1Stage {
  static constexpr int NY = NV + NF, V = 16 / sizeof(T);
  // Tw's row stride: one 16-byte run past W, so that lanes writing their
  // G rows in 16-byte stores hit distinct banks; Psi's, NY + 1 (the same
  // for its scalar rows)
  static constexpr int LG = W + V, LP = NY + 1, GC = W / 2;
  static_assert(W % (2 * V) == 0 && GC % V == 0, "whole 16-byte runs");
  // workspace (scalars), every part 16-byte aligned in f32 and f64
  static constexpr int O_TW = 0, O_E = up4(NY * LG);
  static constexpr int O_PSI = O_E + up4(NY), O_PV = O_PSI + up4(NY * LP);
  static constexpr int WS = O_PV + 2 * up4(NY);

  // entry (i, j) of the KKT block
  static RTT_HD T kkt(const T* M, const T* J, const T* inact, int i, int j) {
    if (i < NV) return j < NV ? M[i * NV + j] : J[(j - NV) * NV + i];
    return j < NV ? J[(i - NV) * NV + j] : (i == j ? -inact[i - NV] : T(0));
  }

  // Psi into the workspace (row stride LP)
  static RTT_HD void invert(const T* M, const T* J, const T* inact, T* ws,
                            int lane, int nl) {
    T* Psi = ws + O_PSI;
#if defined(__CUDA_ARCH__)
    (void)nl;
    T row[NY];
    RTT_UNROLL
    for (int j = 0; j < NY; ++j)
      row[j] = lane < NY ? kkt(M, J, inact, lane, j) : T(0);
    gauss_jordan_rows<T, NY>(row, ws + O_PV, lane);
    if (lane < NY) {
      RTT_UNROLL
      for (int j = 0; j < NY; ++j) Psi[lane * LP + j] = row[j];
    }
#else
    for (int x = lane; x < NY * NY; x += nl)
      Psi[(x / NY) * LP + x % NY] = kkt(M, J, inact, x / NY, x % NY);
    gauss_jordan<T, NY>(Psi, LP, lane, nl);
#endif
  }

  static RTT_HD void run(const T* M, const T* J, const T* inact,
                         const T* Tw1, const T* Tw2, const T* r1,
                         const T* e2, T* inv11, T* inv12, T* Sinv, T* G,
                         T* c0, T* ws, int lane, int nl) {
    T* Tw = ws + O_TW;
    const T* e = ws + O_E;
    const T* Psi = ws + O_PSI;
    async_rows<T, NV, W, LG, W>(Tw, Tw1, lane, nl);
    async_rows<T, NF, W, LG, W>(Tw + NV * LG, Tw2, lane, nl);
    async_copy(ws + O_E, r1, NV, lane, nl);
    async_copy(ws + O_E + NV, e2, NF, lane, nl);
    async_commit();
    invert(M, J, inact, ws, lane, nl);
    async_wait_all();
    warp_sync();
    store_each(inv11, NV * NV, [&](int x) {
      const int i = x / NV, j = x % NV;
      return T(0.5) * (Psi[i * LP + j] + Psi[j * LP + i]);
    }, lane, nl);
    store_each(inv12, NV * NF, [&](int x) {
      const int i = x / NF, j = x % NF;
      return T(0.5) * (Psi[i * LP + NV + j] + Psi[(NV + j) * LP + i]);
    }, lane, nl);
    store_each(Sinv, NF * NF, [&](int x) {
      const int i = NV + x / NF, j = NV + x % NF;
      return T(0.5) * (-Psi[i * LP + j] + -Psi[j * LP + i]);
    }, lane, nl);
    for (int i0 = 0; i0 < NY; i0 += nl) {   // once on the card
      const int i = i0 + lane;
      const bool on = i < NY;
      const T* p = Psi + (on ? i : 0) * LP;   // row i (row 0: no output)
      RTT_UNROLL
      for (int c = 0; c < W; c += GC) {
        T acc[GC];
        RTT_UNROLL
        for (int j = 0; j < GC; ++j) acc[j] = T(0);
        RTT_UNROLL
        for (int k = 0; k < NY; ++k) {
          const T pk = p[k];
          RTT_UNROLL
          for (int q = 0; q < GC; q += V) {
            T b[V];
            load_vec<T, V>(b, Tw + k * LG + c + q);
            RTT_UNROLL
            for (int u = 0; u < V; ++u) acc[q + u] += pk * b[u];
          }
        }
        RTT_UNROLL
        for (int j = 0; j < GC; ++j) acc[j] = i < NV ? -acc[j] : acc[j];
        warp_sync();   // the warp has read Tw's columns c .. c + GC - 1
        if (on) {
#if defined(__CUDA_ARCH__)
          store_vec<T, GC>(Tw + i * LG + c, acc);
#else
          for (int j = 0; j < GC; ++j) G[i * W + c + j] = acc[j];
#endif
        }
      }
      T acc = T(0);
      RTT_UNROLL
      for (int k = 0; k < NY; ++k) acc += p[k] * e[k];
      if (on) c0[i] = i < NV ? -acc : acc;
    }
#if defined(__CUDA_ARCH__)
    warp_sync();
    store_rows<T, NY, W, LG>(G, Tw, lane, nl);
#endif
  }
};

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
// A team of nt threads works on one stage (NT, a block of four warps, on
// the card; one thread on the host), four barriers of the team a stage:
//  * every input is staged in the workspace by cp.async in two groups: the
//    first products' (G, Ha, Hf, coneHqf, c0, gy) and the last additions'
//    (Hq, Hv, Hu, gw), which land while the first products run;
//  * HyG = [Ha Ga; Hf Gf] and CwyG = coneHqf Gf in AM x AN register tiles,
//    a tile a thread (gemm_rows: G's rows in 16-byte loads); hy0 = Hy c0 +
//    gy and coneHqf c0f on threads whose tile is short or that have none;
//  * the W x W product G^T HyG in TM x TN register tiles, a tile a thread
//    (tile_tn: both operands' rows in 16-byte loads), without its
//    lower-left NU x NX block, which is no output; G^T hy0 beside it;
//  * on the card the tiles are staged over G, Ha, Hf and coneHqf once the
//    team has read them, and Qxx, Qxu and Quu leave in one pass of 16-byte
//    stores, threads on neighbouring addresses, the cone and
//    block-diagonal terms added on the way out in the JAX kernel's order
//    ((acc + cx) + cxt) + bd; the host writes each entry as it forms it.
// What bounds it on the card (chip_smoke.py's kernels phase, PERF.md): not
// the bytes but a stage's chain of loads, products and barriers, eight
// stages an SM at a time (its registers allow eight blocks).
template <typename T, int NV, int NU, int NF>
struct K2Stage {
  static constexpr int W = 2 * NV + NU, NY = NV + NF, NX = 2 * NV;
  static constexpr int AM = 3, AN = 8, TM = 4, TN = 4, NT = 128;
  static_assert(NV % AM == 0 && NF % AM == 0 && W % AN == 0, "HyG tiles");
  static_assert(NX % TM == 0 && W % TM == 0 && W % TN == 0 && TN == 4,
                "G^T HyG tiles: 4-entry runs of one output");
  // tiles of HyG's upper and lower parts (CwyG's as the upper's)
  static constexpr int TA = (NV / AM) * (W / AN), TF = (NF / AM) * (W / AN);
  // G^T HyG's tiles: every column tile of the NX rows of Qxx | Qxu, the
  // column tiles right of the first NX / TN of the NU rows of Quu
  static constexpr int NTJ = W / TN, NTX = (NX / TM) * NTJ;
  static constexpr int NTU = NTJ - NX / TN;
  static constexpr int NTILE = NTX + (NU / TM) * NTU;
  static_assert(2 * TA + TF <= NT && NTILE <= NT, "a tile a thread");
  // workspace (scalars), every part 16-byte aligned in f32 and f64
  static constexpr int O_G = 0, O_HA = up4(NY * W);
  static constexpr int O_HF = O_HA + up4(NV * NV);
  static constexpr int O_CHQF = O_HF + up4(NF * NF);
  static constexpr int O_C0 = O_CHQF + up4(NV * NF);
  static constexpr int O_GY = O_C0 + up4(NY);
  static constexpr int O_HQ = O_GY + up4(NY), O_HV = O_HQ + up4(NV * NV);
  static constexpr int O_HU = O_HV + up4(NV * NV), O_GW = O_HU + up4(NU * NU);
  static constexpr int O_HYG = O_GW + up4(W), O_CWY = O_HYG + up4(NY * W);
  static constexpr int O_HY0 = O_CWY + up4(NV * W);
  static constexpr int O_CC0 = O_HY0 + up4(NY);
  static constexpr int WS = O_CC0 + up4(NV);
  // on the card: the product's entries staged over G .. coneHqf as Qxx,
  // Qxu and Quu laid end to end
  static constexpr int S_XU = NX * NX, S_UU = S_XU + NX * NU;
  static constexpr int S_END = S_UU + NU * NU;
  static_assert(S_END <= O_C0 && S_XU % 4 == 0 && S_UU % 4 == 0,
                "the staging fits over G .. coneHqf");

  // the first row and column of G^T HyG's tile t
  static RTT_HD void tile_at(int t, int& i0, int& j0) {
    if (t < NTX) {
      i0 = (t / NTJ) * TM;
      j0 = (t % NTJ) * TN;
    } else {
      t -= NTX;
      i0 = NX + (t / NTU) * TM;
      j0 = (NTJ - NTU + t % NTU) * TN;
    }
  }

  // the offset of entry (i, j) of the W x W square in Qxx | Qxu | Quu laid
  // end to end (-1: the lower-left block, no output), and the entry at
  // offset x there finished from the product's entry acc
  static RTT_HD int place(int i, int j) {
    if (i < NX) return j < NX ? i * NX + j : S_XU + i * NU + (j - NX);
    return j < NX ? -1 : S_UU + (i - NX) * NU + (j - NX);
  }
  static RTT_HD T finish(int x, T acc, const T* CwyG, const T* Hq,
                         const T* Hv, const T* Hu) {
    if (x < S_XU) {
      const int i = x / NX, j = x % NX;
      const T cx = (i < NV) ? CwyG[i * W + j] : T(0);
      const T cxt = (j < NV) ? CwyG[j * W + i] : T(0);
      T bd = T(0);
      if (i < NV && j < NV) bd = Hq[i * NV + j];
      if (i >= NV && j >= NV) bd = Hv[(i - NV) * NV + (j - NV)];
      return ((acc + cx) + cxt) + bd;
    }
    if (x < S_UU) {
      const int i = (x - S_XU) / NU, j = (x - S_XU) % NU;
      return acc + ((i < NV) ? CwyG[i * W + NX + j] : T(0));
    }
    return acc + Hu[x - S_UU];
  }
  static RTT_HD T gtil_at(int j, const T* G, const T* hy0, const T* gw,
                          const T* Cc0) {
    T acc = T(0);
    RTT_UNROLL
    for (int k = 0; k < NY; ++k) acc += G[k * W + j] * hy0[k];
    return (gw[j] + ((j < NV) ? Cc0[j] : T(0))) + acc;
  }

  static RTT_HD void run(const T* Gg, const T* c0g, const T* Hqg,
                         const T* Hvg, const T* Hug, const T* Hag,
                         const T* Hfg, const T* cHqfg, const T* gwg,
                         const T* gyg, T* Qxx, T* Qxu, T* Quu, T* gtil,
                         T* ws, int tid, int nt) {
    const T* G = ws + O_G;
    const T* Gf = G + NV * W;
    const T* Ha = ws + O_HA;
    const T* Hf = ws + O_HF;
    const T* cHqf = ws + O_CHQF;
    const T* c0 = ws + O_C0;
    const T* Hq = ws + O_HQ;
    const T* Hv = ws + O_HV;
    const T* Hu = ws + O_HU;
    const T* gw = ws + O_GW;
    T* HyG = ws + O_HYG;
    T* CwyG = ws + O_CWY;
    T* hy0 = ws + O_HY0;
    T* Cc0 = ws + O_CC0;
    async_copy(ws + O_G, Gg, NY * W, tid, nt);
    async_copy(ws + O_HA, Hag, NV * NV, tid, nt);
    async_copy(ws + O_HF, Hfg, NF * NF, tid, nt);
    async_copy(ws + O_CHQF, cHqfg, NV * NF, tid, nt);
    async_copy(ws + O_C0, c0g, NY, tid, nt);
    async_copy(ws + O_GY, gyg, NY, tid, nt);
    async_commit();
    async_copy(ws + O_HQ, Hqg, NV * NV, tid, nt);
    async_copy(ws + O_HV, Hvg, NV * NV, tid, nt);
    async_copy(ws + O_HU, Hug, NU * NU, tid, nt);
    async_copy(ws + O_GW, gwg, W, tid, nt);
    async_commit();
    async_wait_prior();
    block_sync();
    gemm_rows<T, NV, W, NV, AM, AN>(HyG, W, Ha, NV, G, W, tid, nt);
    gemm_rows<T, NF, W, NF, AM, AN>(HyG + NV * W, W, Hf, NF, Gf, W,
                                    rot(tid, TA, nt), nt);
    gemm_rows<T, NV, W, NF, AM, AN>(CwyG, W, cHqf, NF, Gf, W,
                                    rot(tid, TA + TF, nt), nt);
    // hy0 on the threads past the tiles, coneHqf c0f on those of CwyG's
    // (NF deep, shorter than HyG's upper NV-deep tiles)
    constexpr int TV = 2 * TA + TF;
    gemv<T, NV, NV, false>(hy0, Ha, NV, c0, ws + O_GY, T(1), rot(tid, TV, nt),
                           nt);
    gemv<T, NF, NF, false>(hy0 + NV, Hf, NF, c0 + NV, ws + O_GY + NV, T(1),
                           rot(tid, TV + NV, nt), nt);
    gemv<T, NV, NF, false>(Cc0, cHqf, NF, c0 + NV, nullptr, T(1),
                           rot(tid, TA + TF, nt), nt);
    async_wait_all();   // the last additions' inputs
    block_sync();
#if defined(__CUDA_ARCH__)
    // a tile and at most one entry of G^T hy0 a thread (nt == NT), held in
    // registers until the team has read G
    static_assert(W <= NT, "an entry of gtil a thread");
    int i0 = 0, j0 = 0;
    tile_at(tid, i0, j0);
    T acc[TM][TN];
    if (tid < NTILE) tile_tn<T, NY, TM, TN>(acc, G + i0, W, HyG + j0, W);
    const int jg = rot(tid, NTILE, nt);
    T g = T(0);
    if (jg < W) g = gtil_at(jg, G, hy0, gw, Cc0);
    block_sync();   // G read: the staging goes over it
    T* St = ws + O_G;
    if (tid < NTILE) {
      RTT_UNROLL
      for (int m = 0; m < TM; ++m) {
        const int x = place(i0 + m, j0);
        if (x >= 0) store_vec<T, TN>(St + x, acc[m]);
      }
    }
    if (jg < W) gtil[jg] = g;
    block_sync();
    // Qxx | Qxu | Quu in one pass, 4 entries a thread and 16-byte stores
    // where the run allows (4 floats, or 2 x 2 doubles)
    for (int e = tid; e < S_END / 4; e += nt) {
      const int x = 4 * e;
      T v[4];
      RTT_UNROLL
      for (int u = 0; u < 4; ++u)
        v[u] = finish(x + u, St[x + u], CwyG, Hq, Hv, Hu);
      T* dst = x < S_XU ? Qxx + x : (x < S_UU ? Qxu + (x - S_XU)
                                             : Quu + (x - S_UU));
      store_vec<T, 4>(dst, v);
    }
#else
    for (int t = tid; t < NTILE; t += nt) {
      int i0, j0;
      tile_at(t, i0, j0);
      T acc[TM][TN];
      tile_tn<T, NY, TM, TN>(acc, G + i0, W, HyG + j0, W);
      for (int m = 0; m < TM; ++m)
        for (int n = 0; n < TN; ++n) {
          const int x = place(i0 + m, j0 + n);
          if (x < 0) continue;
          const T val = finish(x, acc[m][n], CwyG, Hq, Hv, Hu);
          if (x < S_XU) Qxx[x] = val;
          else if (x < S_UU) Qxu[x - S_XU] = val;
          else Quu[x - S_UU] = val;
        }
    }
    for (int j = tid; j < W; j += nt) gtil[j] = gtil_at(j, G, hy0, gw, Cc0);
#endif
  }
};

// K3 (_k3_kernel): LQR blocks from the condensed acceleration rows
//   A = [[Aqq, Aqv], [sA Gq, I + sA Gv]], Bm = [0; sA Gu],
//   xres = [xres_q; Fv_res + sA c0a],
//   lx = gtil_x + A^T lam2 - lmdgmm, lu = gtil_u + Bm^T lam2.
// Row i of [A | Bm] (W = NX + NU columns) is [Aqq_i, Aqv_i | 0] for
// i < NV and sA G_{i-NV} + [e_i | 0] for i >= NV, so a chunk of V = 16 /
// sizeof(T) columns needs nothing of the others: `chunk` streams its NX
// rows from device memory RB at a time (every load of a batch before its
// first store), writes its V entries of each row of A or Bm in one
// 16-byte store and sums them times lam2[i] in registers, i in order from
// 0 (the plain version's order), for its entries of lx or lu. G, lam2,
// gtil and lmdgmm come in 16-byte loads; Aqq and Aqv in pairs (their f32
// rows are 72 bytes apart). `xres_at` is one entry of xres. On the card a
// thread runs one chunk of one stage and its share of xres: no shared
// memory, no barrier, nothing re-read; the host runs a stage's chunks in
// turn (`run`).
template <typename T, int NV, int NU, int NF>
struct K3Stage {
  static constexpr int W = 2 * NV + NU, NX = 2 * NV, NY = NV + NF;
  static constexpr int V = 16 / sizeof(T), NCH = W / V, RB = 12;
  static_assert(NX % V == 0 && NU % V == 0 && NV % 2 == 0 && NX % RB == 0 &&
                    RB % V == 0,
                "whole 16-byte chunks, pairs and batches");

  // x[0..2) = p[0..2): one 8-byte (f32) or 16-byte (f64) load on the card
  static RTT_HD void load_pair(T* x, const T* p) {
#if defined(__CUDA_ARCH__)
    if constexpr (sizeof(T) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      x[0] = v.x, x[1] = v.y;
    } else {
      const double2 v = *reinterpret_cast<const double2*>(p);
      x[0] = v.x, x[1] = v.y;
    }
#else
    x[0] = p[0], x[1] = p[1];
#endif
  }

  static RTT_HD T xres_at(const T* __restrict__ c0,
                          const T* __restrict__ xres_q,
                          const T* __restrict__ Fv_res, T sA, int i) {
    return (i < NV) ? xres_q[i] : Fv_res[i - NV] + sA * c0[i - NV];
  }

  // columns ch V .. ch V + V - 1 of [A | Bm], and their lx or lu entries
  static RTT_HD void chunk(const T* __restrict__ G,
                           const T* __restrict__ gtil,
                           const T* __restrict__ Aqq,
                           const T* __restrict__ Aqv, T sA,
                           const T* __restrict__ lam2,
                           const T* __restrict__ lmdgmm, T* __restrict__ A,
                           T* __restrict__ Bm, T* __restrict__ lx,
                           T* __restrict__ lu, int ch) {
    const int c = ch * V;
    const bool in_a = c < NX;
    T acc[V];
    RTT_UNROLL
    for (int u = 0; u < V; ++u) acc[u] = T(0);
    RTT_UNROLL
    for (int i0 = 0; i0 < NX; i0 += RB) {
      T row[RB][V], lam[RB];
      load_vec<T, RB>(lam, lam2 + i0);
      RTT_UNROLL
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + r;
        if (i >= NV) {
          load_vec<T, V>(row[r], G + (i - NV) * W + c);
        } else if (in_a) {
          RTT_UNROLL
          for (int u = 0; u < V; u += 2) {
            const int j = c + u;
            load_pair(row[r] + u, j < NV ? Aqq + i * NV + j
                                         : Aqv + i * NV + (j - NV));
          }
        } else {
          RTT_UNROLL
          for (int u = 0; u < V; ++u) row[r][u] = T(0);
        }
      }
      RTT_UNROLL
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + r;
        if (i >= NV) {
          RTT_UNROLL
          for (int u = 0; u < V; ++u) {
            const int j = c + u;
            const T g = sA * row[r][u];
            row[r][u] = (in_a && j >= NV) ? (i == j ? T(1) : T(0)) + g : g;
          }
        }
        store_vec<T, V>(in_a ? A + i * NX + c : Bm + i * NU + (c - NX),
                        row[r]);
        RTT_UNROLL
        for (int u = 0; u < V; ++u) acc[u] += row[r][u] * lam[r];
      }
    }
    T g[V], out[V];
    load_vec<T, V>(g, gtil + c);
    if (in_a) {
      T m[V];
      load_vec<T, V>(m, lmdgmm + c);
      RTT_UNROLL
      for (int u = 0; u < V; ++u) out[u] = (g[u] + acc[u]) - m[u];
      store_vec<T, V>(lx + c, out);
    } else {
      RTT_UNROLL
      for (int u = 0; u < V; ++u) out[u] = g[u] + acc[u];
      store_vec<T, V>(lu + (c - NX), out);
    }
  }

  // one stage, its chunks in turn (the host's loop; lane, nl as a team)
  static RTT_HD void run(const T* G, const T* c0, const T* gtil,
                         const T* Aqq, const T* Aqv, const T* xres_q,
                         const T* Fv_res, const T* sAp, const T* lam2,
                         const T* lmdgmm, T* A, T* Bm, T* xres, T* lx,
                         T* lu, int lane, int nl) {
    const T sA = sAp[0];
    for (int i = lane; i < NX; i += nl)
      xres[i] = xres_at(c0, xres_q, Fv_res, sA, i);
    for (int ch = lane; ch < NCH; ch += nl)
      chunk(G, gtil, Aqq, Aqv, sA, lam2, lmdgmm, A, Bm, lx, lu, ch);
  }
};

}  // namespace rtt

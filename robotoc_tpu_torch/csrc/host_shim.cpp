// Host build of the kernels' per-stage arithmetic (g++, no CUDA, no torch
// headers). Each function runs the same __host__ __device__ bodies the
// CUDA kernels run, with one "thread" (tid = 0, nt = 1) per stage, so the
// CPU tests can hold the kernels' arithmetic against the plain PyTorch
// versions. Build: g++ -O2 -std=c++17 -shared -fPIC host_shim.cpp.
#include <vector>

#include "chain_stage.cuh"
#include "condense_stage.cuh"
#include "riccati_stage.cuh"

using rtt::K1Stage;
using rtt::K2Stage;
using rtt::K3Stage;
using rtt::KcStage;
using rtt::RiccatiBwd;

namespace {
constexpr int NV = 18, NU = 12, NF = 12, W = 2 * NV + NU;
constexpr int NY = NV + NF, NX = 2 * NV;

template <int N>
void gj(double* A) {
  rtt::gauss_jordan<double, N>(A, N, 0, 1);
}

template <bool TA, bool TB>
void gemm_537(double* C, const double* A, const double* B, const double* D,
              double alpha) {
  // op(A) 5x3, op(B) 3x7, C 5x7, in 1 x 7 tiles
  rtt::gemm_tiled<double, 5, 7, 3, 1, 7, TA, TB>(
      C, 7, A, TA ? 5 : 3, B, TB ? 3 : 7, D, 7, alpha, 0, 1);
}

template <int NFR>
void riccati(int Bn, int N, const double* A, const double* B,
             const double* xres, const double* Qxx, const double* Qxu,
             const double* Quu, const double* lx, const double* lu,
             const double* Phix, const double* Phiu, const double* Pc,
             const double* sw, const double* QxxN, const double* lxN,
             double* K, double* k, double* P, double* p, double* Mx,
             double* mx) {
  using R = RiccatiBwd<double, NX, NU, NFR>;
  std::vector<double> ws(R::WS);
  for (long long b = 0; b < Bn; ++b) {
    const long long s = b * N;
    R::run(N, A + s * NX * NX, B + s * NX * NU, xres + s * NX,
           Qxx + s * NX * NX, Qxu + s * NX * NU, Quu + s * NU * NU,
           lx + s * NX, lu + s * NU, NFR ? Phix + s * NFR * NX : nullptr,
           NFR ? Phiu + s * NFR * NU : nullptr, NFR ? Pc + s * NFR : nullptr,
           NFR ? sw + s * NFR : nullptr, QxxN + b * NX * NX, lxN + b * NX,
           K + s * NU * NX, k + s * NU, P + s * NX * NX, p + s * NX,
           NFR ? Mx + s * NFR * NX : nullptr, NFR ? mx + s * NFR : nullptr,
           ws.data(), 0, 1);
  }
}

// K6's body on S stages, one lane a stage
template <typename TREE, bool WC>
void chain(const double* consts, const int* topo, const double* const* ins,
           double* const* outs, long long S) {
  using K = rtt::ChainStage<double, TREE, WC>;
  std::vector<double> ws(K::WS);
  for (long long s = 0; s < S; ++s)
    K::run(consts, topo, ins, outs, s, ws.data(), 0, 1);
}

// 1 when TREE is (nv, nc, ctype) and its layout fits (-2 when it does
// not), 0 for another tree
template <typename TREE>
int chain_tree(int nv, int with_cost, int nc, int ctype,
               const double* consts, const int* topo,
               const double* const* ins, double* const* outs, long long S) {
  if (nv != TREE::NV || nc != TREE::NC || ctype != TREE::CT) return 0;
  if (!rtt::layout_fits<TREE>(topo)) return -2;
  if (with_cost)
    chain<TREE, true>(consts, topo, ins, outs, S);
  else
    chain<TREE, false>(consts, topo, ins, outs, S);
  return 1;
}

template <int NG>
void kc(long long S, const double* dgdq, const double* dgdf, const double* d,
        double* Hqq, double* Hqf, double* Hff) {
  using K = KcStage<double, NV, NF, NG>;
  std::vector<double> ws(K::WS);
  for (long long s = 0; s < S; ++s)
    K::run(dgdq + s * NG * NV, dgdf + s * NG * NF, d + s * NG,
           Hqq + s * NV * NV, Hqf + s * NV * NF, Hff + s * NF * NF,
           ws.data(), 0, 1);
}

}  // namespace

extern "C" {

int rtt_host_gauss_jordan(double* A, int n) {
  switch (n) {
    case 6: gj<6>(A); return 0;
    case 12: gj<12>(A); return 0;
    case 30: gj<30>(A); return 0;
    default: return -1;
  }
}

// C (5x7) = D + alpha op(A) op(B) with op(A) 5x3 and op(B) 3x7.
int rtt_host_gemm_537(int ta, int tb, double* C, const double* A,
                      const double* B, const double* D, double alpha) {
  if (!ta && !tb) gemm_537<false, false>(C, A, B, D, alpha);
  if (!ta && tb) gemm_537<false, true>(C, A, B, D, alpha);
  if (ta && !tb) gemm_537<true, false>(C, A, B, D, alpha);
  if (ta && tb) gemm_537<true, true>(C, A, B, D, alpha);
  return 0;
}

// y (5) = d + alpha op(A) x with op(A) 5x3.
int rtt_host_gemv_53(int ta, double* y, const double* A, const double* x,
                     const double* d, double alpha) {
  if (ta)
    rtt::gemv<double, 5, 3, true>(y, A, 5, x, d, alpha, 0, 1);
  else
    rtt::gemv<double, 5, 3, false>(y, A, 3, x, d, alpha, 0, 1);
  return 0;
}

// C (6 x 16) = A (6 x 5) B (5 x 16) by gemm_rows in 3 x 8 tiles.
int rtt_host_gemm_rows(double* C, const double* A, const double* B) {
  rtt::gemm_rows<double, 6, 16, 5, 3, 8>(C, 16, A, 5, B, 16, 0, 1);
  return 0;
}

// C (4 x 8) = A[:, 2:6]^T B[:, 2:10] by tile_tn, A 5 x 6, B 5 x 10.
int rtt_host_tile_tn(double* C, const double* A, const double* B) {
  double acc[4][8];
  rtt::tile_tn<double, 5, 4, 8>(acc, A + 2, 6, B + 2, 10);
  for (int m = 0; m < 4; ++m)
    for (int n = 0; n < 8; ++n) C[m * 8 + n] = acc[m][n];
  return 0;
}

// dst (3 x 4, contiguous) = the first 4 columns of src's 3 rows of 6 by
// store_rows.
int rtt_host_store_rows(double* dst, const double* src) {
  rtt::store_rows<double, 3, 4, 6>(dst, src, 0, 1);
  return 0;
}

int rtt_host_k1(long long S, const double* M, const double* J,
                const double* inact, const double* Tw1, const double* Tw2,
                const double* r1, const double* e2, double* inv11,
                double* inv12, double* Sinv, double* G, double* c0) {
  using K = K1Stage<double, NV, NF, W>;
  std::vector<double> ws(K::WS);
  for (long long s = 0; s < S; ++s)
    K::run(M + s * NV * NV, J + s * NF * NV, inact + s * NF,
           Tw1 + s * NV * W, Tw2 + s * NF * W, r1 + s * NV, e2 + s * NF,
           inv11 + s * NV * NV, inv12 + s * NV * NF, Sinv + s * NF * NF,
           G + s * NY * W, c0 + s * NY, ws.data(), 0, 1);
  return 0;
}

// Kc on S stages with ng cone rows (20: ANYmal's point feet, 34: the iCub
// soles).
int rtt_host_kc(int ng, long long S, const double* dgdq, const double* dgdf,
                const double* d, double* Hqq, double* Hqf, double* Hff) {
  if (ng == 20)
    kc<20>(S, dgdq, dgdf, d, Hqq, Hqf, Hff);
  else if (ng == 34)
    kc<34>(S, dgdq, dgdf, d, Hqq, Hqf, Hff);
  else
    return -1;
  return 0;
}

int rtt_host_k2(long long S, const double* G, const double* c0,
                const double* Hq, const double* Hv, const double* Hu,
                const double* Ha, const double* Hf, const double* cHqf,
                const double* gw, const double* gy, double* Qxx, double* Qxu,
                double* Quu, double* gtil) {
  using K = K2Stage<double, NV, NU, NF>;
  std::vector<double> ws(K::WS);
  for (long long s = 0; s < S; ++s)
    K::run(G + s * NY * W, c0 + s * NY, Hq + s * NV * NV, Hv + s * NV * NV,
           Hu + s * NU * NU, Ha + s * NV * NV, Hf + s * NF * NF,
           cHqf + s * NV * NF, gw + s * W, gy + s * NY, Qxx + s * NX * NX,
           Qxu + s * NX * NU, Quu + s * NU * NU, gtil + s * W, ws.data(), 0,
           1);
  return 0;
}

int rtt_host_k3(long long S, const double* G, const double* c0,
                const double* gtil, const double* Aqq, const double* Aqv,
                const double* xres_q, const double* Fv_res, const double* sA,
                const double* lam2, const double* lmdgmm, double* A,
                double* Bm, double* xres, double* lx, double* lu) {
  using K = K3Stage<double, NV, NU, NF>;
  for (long long s = 0; s < S; ++s)
    K::run(G + s * NY * W, c0 + s * NY, gtil + s * W, Aqq + s * NV * NV,
           Aqv + s * NV * NV, xres_q + s * NV, Fv_res + s * NV, sA + s,
           lam2 + s * NX, lmdgmm + s * NX, A + s * NX * NX, Bm + s * NX * NU,
           xres + s * NX, lx + s * NX, lu + s * NU, 0, 1);
  return 0;
}

int rtt_host_riccati_bwd(int nf, int Bn, int N, const double* A,
                         const double* B, const double* xres,
                         const double* Qxx, const double* Qxu,
                         const double* Quu, const double* lx, const double* lu,
                         const double* Phix, const double* Phiu,
                         const double* Pc, const double* sw,
                         const double* QxxN, const double* lxN, double* K,
                         double* k, double* P, double* p, double* Mx,
                         double* mx) {
  if (nf == 0)
    riccati<0>(Bn, N, A, B, xres, Qxx, Qxu, Quu, lx, lu, Phix, Phiu, Pc, sw,
               QxxN, lxN, K, k, P, p, Mx, mx);
  else if (nf == NF)
    riccati<NF>(Bn, N, A, B, xres, Qxx, Qxu, Quu, lx, lu, Phix, Phiu, Pc,
                sw, QxxN, lxN, K, k, P, p, Mx, mx);
  else
    return -1;
  return 0;
}

// K6 on S stages for the trees of csrc/chain_stage.cuh (nv 18: the 4 point
// feet of ANYmal or the A1, nc 4, ctype 3, or the iCub lower half's 2 soles, nc 2, ctype
// 6; nv 35: the full iCub's 2 soles); ins/outs in the order of
// ops/chain.py. Returns 0, -1 for another tree, -2 for a chain layout
// past the tree's workspace.
int rtt_host_chain(int nv, int with_cost, int nc, int ctype,
                   const double* consts, const int* topo,
                   const double* const* ins, double* const* outs,
                   long long S) {
  int rc = chain_tree<rtt::AnymalFeet>(nv, with_cost, nc, ctype, consts,
                                       topo, ins, outs, S);
  if (!rc)
    rc = chain_tree<rtt::IcubLegSoles>(nv, with_cost, nc, ctype, consts,
                                       topo, ins, outs, S);
  if (!rc)
    rc = chain_tree<rtt::IcubSoles>(nv, with_cost, nc, ctype, consts, topo,
                                    ins, outs, S);
  return rc == 1 ? 0 : (rc == 0 ? -1 : rc);
}

}  // extern "C"

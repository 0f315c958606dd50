// Riccati backward-sweep kernel K5 for Hopper (sm_90a), plain C interface.
//
// Replaces robotoc_tpu riccati/pallas_scan.py:_bwd_kernel (launch :146).
//
// Design: one 512-thread block per scenario walks its N steps in reverse
// (csrc/riccati_stage.cuh). The Pallas grid's sequential time axis and
// the VMEM scratch that carried (P, p) between grid steps become a loop
// inside the block with (P, p) in shared memory; the 128-lane fleet
// chunking was a VMEM-size artefact and is gone. Inputs are the solver's
// (B, N, ...) batch-first tensors. Each step's blocks arrive by cp.async
// into one of two shared-memory buffers while the step before computes;
// the products are register-tiled; the 12 x 12 inversions run in one
// warp; a step has 5 block barriers (9 with switching rows). Shared
// memory: the two input buffers and the step's work, 60 KB in f32 and
// 119 KB in f64 with switching rows.
//
// Bound on the card: the sweep reads about 3,700 and writes about 1,800
// values per step (nx 36, nu 12), 81 MB in f32 for B = 128, N = 24 with
// switching rows: 24 us at 3.35 TB/s. Its steps are a dependent chain:
// one SM's share of the f32 peak (67 TFLOP/s / 132) does a step's 0.39 M
// operations in 0.8 us, so the serial floor of 24 steps is 18 us, under
// the bytes bound. On "NVIDIA H100 80GB HBM3, 700.00 W" (device time,
// f32): 0.283 ms at 128 x 24 with switching rows (12 us a step), 0.154
// ms at 128 x 20 without, 2.2 times faster than the block-per-scenario
// kernel with untiled products it replaced. What holds it above both
// bounds: each step is a chain of small dependent products and two
// 12 x 12 inversions (latency, not throughput, on one SM), and B = 128
// scenarios fill at most 128 of the 132 SMs.
//
// C interface: rtt_riccati_bwd(dtype, nx, nu, nf, pointers..., B, N,
// stream) returns 0, -1 for an unsupported dtype/dims, else the
// cudaGetLastError() code after the launch. dtype 0 = float, 1 = double.
// With nf == 0 the Phix/Phiu/Pc/sw and Mx/mx pointers are ignored.
#include <cuda_runtime.h>

#include "riccati_stage.cuh"

extern __shared__ __align__(16) unsigned char rtt_smem[];

namespace {

constexpr int kThreads = 512;

template <typename T, int NX, int NU, int NF>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(int N, const T* __restrict__ A, const T* __restrict__ B,
           const T* __restrict__ xres, const T* __restrict__ Qxx,
           const T* __restrict__ Qxu, const T* __restrict__ Quu,
           const T* __restrict__ lx, const T* __restrict__ lu,
           const T* __restrict__ Phix, const T* __restrict__ Phiu,
           const T* __restrict__ Pc, const T* __restrict__ sw,
           const T* __restrict__ QxxN, const T* __restrict__ lxN,
           T* __restrict__ K, T* __restrict__ k, T* __restrict__ P,
           T* __restrict__ p, T* __restrict__ Mx, T* __restrict__ mx) {
  const long long b = blockIdx.x;
  const long long s = b * N;
  T* ws = reinterpret_cast<T*>(rtt_smem);
  rtt::RiccatiBwd<T, NX, NU, NF>::run(
      N, A + s * NX * NX, B + s * NX * NU, xres + s * NX, Qxx + s * NX * NX,
      Qxu + s * NX * NU, Quu + s * NU * NU, lx + s * NX, lu + s * NU,
      NF ? Phix + s * NF * NX : nullptr, NF ? Phiu + s * NF * NU : nullptr,
      NF ? Pc + s * NF : nullptr, NF ? sw + s * NF : nullptr,
      QxxN + b * NX * NX, lxN + b * NX, K + s * NU * NX, k + s * NU,
      P + s * NX * NX, p + s * NX, NF ? Mx + s * NF * NX : nullptr,
      NF ? mx + s * NF : nullptr, ws, threadIdx.x, blockDim.x);
}

template <typename T, int NF>
int launch(int Bn, int N, const void* A, const void* B, const void* xres,
           const void* Qxx, const void* Qxu, const void* Quu, const void* lx,
           const void* lu, const void* Phix, const void* Phiu,
           const void* Pc, const void* sw, const void* QxxN,
           const void* lxN, void* K, void* k, void* P, void* p, void* Mx,
           void* mx, void* stream) {
  constexpr int NX = 36, NU = 12;
  auto kernel = bwd_kernel<T, NX, NU, NF>;
  const size_t bytes = sizeof(T) * rtt::RiccatiBwd<T, NX, NU, NF>::WS;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  using CT = const T*;
  kernel<<<Bn, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      N, CT(A), CT(B), CT(xres), CT(Qxx), CT(Qxu), CT(Quu), CT(lx), CT(lu),
      CT(Phix), CT(Phiu), CT(Pc), CT(sw), CT(QxxN), CT(lxN),
      static_cast<T*>(K), static_cast<T*>(k), static_cast<T*>(P),
      static_cast<T*>(p), static_cast<T*>(Mx), static_cast<T*>(mx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtt_riccati_bwd(int dtype, int nx, int nu, int nf,
                               const void* A, const void* B,
                               const void* xres, const void* Qxx,
                               const void* Qxu, const void* Quu,
                               const void* lx, const void* lu,
                               const void* Phix, const void* Phiu,
                               const void* Pc, const void* sw,
                               const void* QxxN, const void* lxN, void* K,
                               void* k, void* P, void* p, void* Mx, void* mx,
                               int Bn, int N, void* stream) {
  if (nx != 36 || nu != 12 || (nf != 0 && nf != 12)) return -1;
#define RTT_BWD_ARGS                                                       \
  Bn, N, A, B, xres, Qxx, Qxu, Quu, lx, lu, Phix, Phiu, Pc, sw, QxxN, lxN, \
      K, k, P, p, Mx, mx, stream
  if (dtype == 0)
    return nf ? launch<float, 12>(RTT_BWD_ARGS)
              : launch<float, 0>(RTT_BWD_ARGS);
  if (dtype == 1)
    return nf ? launch<double, 12>(RTT_BWD_ARGS)
              : launch<double, 0>(RTT_BWD_ARGS);
#undef RTT_BWD_ARGS
  return -1;
}

// Condense kernels K1, Kc, K2, K3 for Hopper (sm_90a), plain C interface.
//
// Replace robotoc_tpu ops/pallas_condense.py: _k1_kernel (launch :331),
// _kc_kernel (:348), _k2_kernel (:377), _k3_kernel (:399).
//
// Design: one thread block per stage, the stage's blocks in shared memory,
// threads over the entries of each output (csrc/condense_stage.cuh). The
// Pallas kernels put 128 stages across the TPU lanes and padded the stage
// count with identity KKT blocks; here nothing is padded. Inputs and
// outputs are batch-first row-major (S, d1, d2) tensors, so a block reads
// and writes contiguous runs and neighbouring threads touch neighbouring
// addresses.
//
// Bound on the card: at the ANYmal widths (nv 18, nu 12, nf 12, 20 cone
// rows) every kernel moves 13-51 MB per launch for 2560 stages and does
// a few hundred kFLOP per stage, so all four are bound by device-memory
// bytes (3.35 TB/s) rather than by the FP32/FP64 rate; the design reads
// each input once and writes each output once. The iCub lower half has
// the same nv, nu and nf with two 6-D surface contacts, so K1, K2 and K3
// serve it as they are; its 2 x 17 wrench-cone rows need a second Kc
// instance (the cone row count is Kc's template parameter): ~1.7 K values
// per stage, ~25 MB for 3584 stages, still bytes-bound.
//
// C interface: rtt_condense_k*(dtype, dims..., pointers..., S, stream)
// returns 0 on success, -1 for an unsupported dtype/dims pair, else the
// cudaGetLastError() code after the launch. dtype 0 = float, 1 = double.
#include <cuda_runtime.h>

#include "condense_stage.cuh"

extern __shared__ __align__(16) unsigned char rtt_smem[];

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ T* smem() {
  return reinterpret_cast<T*>(rtt_smem);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int NV, int NF, int W>
__global__ void __launch_bounds__(kThreads)
k1_kernel(const T* __restrict__ M, const T* __restrict__ J,
          const T* __restrict__ inact, const T* __restrict__ Tw1,
          const T* __restrict__ Tw2, const T* __restrict__ r1,
          const T* __restrict__ e2, T* __restrict__ inv11,
          T* __restrict__ inv12, T* __restrict__ Sinv, T* __restrict__ G,
          T* __restrict__ c0) {
  constexpr int NY = NV + NF;
  const long long s = blockIdx.x;
  rtt::K1Stage<T, NV, NF, W>::run(
      M + s * NV * NV, J + s * NF * NV, inact + s * NF, Tw1 + s * NV * W,
      Tw2 + s * NF * W, r1 + s * NV, e2 + s * NF, inv11 + s * NV * NV,
      inv12 + s * NV * NF, Sinv + s * NF * NF, G + s * NY * W, c0 + s * NY,
      smem<T>(), threadIdx.x, blockDim.x);
}

template <typename T, int NV, int NF, int NC>
__global__ void __launch_bounds__(kThreads)
kc_kernel(const T* __restrict__ dgdq, const T* __restrict__ dgdf,
          const T* __restrict__ d, T* __restrict__ Hqq, T* __restrict__ Hqf,
          T* __restrict__ Hff) {
  const long long s = blockIdx.x;
  rtt::KcStage<T, NV, NF, NC>::run(
      dgdq + s * NC * NV, dgdf + s * NC * NF, d + s * NC, Hqq + s * NV * NV,
      Hqf + s * NV * NF, Hff + s * NF * NF, smem<T>(), threadIdx.x,
      blockDim.x);
}

template <typename T, int NV, int NU, int NF>
__global__ void __launch_bounds__(kThreads)
k2_kernel(const T* __restrict__ G, const T* __restrict__ c0,
          const T* __restrict__ Hq, const T* __restrict__ Hv,
          const T* __restrict__ Hu, const T* __restrict__ Ha,
          const T* __restrict__ Hf, const T* __restrict__ cHqf,
          const T* __restrict__ gw, const T* __restrict__ gy,
          T* __restrict__ Qxx, T* __restrict__ Qxu, T* __restrict__ Quu,
          T* __restrict__ gtil) {
  constexpr int W = 2 * NV + NU, NY = NV + NF, NX = 2 * NV;
  const long long s = blockIdx.x;
  rtt::K2Stage<T, NV, NU, NF>::run(
      G + s * NY * W, c0 + s * NY, Hq + s * NV * NV, Hv + s * NV * NV,
      Hu + s * NU * NU, Ha + s * NV * NV, Hf + s * NF * NF,
      cHqf + s * NV * NF, gw + s * W, gy + s * NY, Qxx + s * NX * NX,
      Qxu + s * NX * NU, Quu + s * NU * NU, gtil + s * W, smem<T>(),
      threadIdx.x, blockDim.x);
}

template <typename T, int NV, int NU, int NF>
__global__ void __launch_bounds__(kThreads)
k3_kernel(const T* __restrict__ G, const T* __restrict__ c0,
          const T* __restrict__ gtil, const T* __restrict__ Aqq,
          const T* __restrict__ Aqv, const T* __restrict__ xres_q,
          const T* __restrict__ Fv_res, const T* __restrict__ sA,
          const T* __restrict__ lam2, const T* __restrict__ lmdgmm,
          T* __restrict__ A, T* __restrict__ Bm, T* __restrict__ xres,
          T* __restrict__ lx, T* __restrict__ lu) {
  constexpr int W = 2 * NV + NU, NY = NV + NF, NX = 2 * NV;
  const long long s = blockIdx.x;
  rtt::K3Stage<T, NV, NU, NF>::run(
      G + s * NY * W, c0 + s * NY, gtil + s * W, Aqq + s * NV * NV,
      Aqv + s * NV * NV, xres_q + s * NV, Fv_res + s * NV, sA + s,
      lam2 + s * NX, lmdgmm + s * NX, A + s * NX * NX, Bm + s * NX * NU,
      xres + s * NX, lx + s * NX, lu + s * NU, smem<T>(), threadIdx.x,
      blockDim.x);
}

// Launch `kernel` over S blocks with WS scalars of dynamic shared memory.
template <typename T, int WS, typename K, typename... Args>
int launch(K kernel, long long S, void* stream, Args... args) {
  const size_t bytes = sizeof(T) * WS;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(S), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out(void* p) {
  return static_cast<T*>(p);
}

template <typename T>
int k1_typed(const void* M, const void* J, const void* inact,
             const void* Tw1, const void* Tw2, const void* r1,
             const void* e2, void* inv11, void* inv12, void* Sinv, void* G,
             void* c0, long long S, void* stream) {
  using K = rtt::K1Stage<T, 18, 12, 48>;
  return launch<T, K::WS>(k1_kernel<T, 18, 12, 48>, S, stream, in<T>(M),
                          in<T>(J), in<T>(inact), in<T>(Tw1), in<T>(Tw2),
                          in<T>(r1), in<T>(e2), out<T>(inv11),
                          out<T>(inv12), out<T>(Sinv), out<T>(G),
                          out<T>(c0));
}

template <typename T, int NG>
int kc_typed(const void* dgdq, const void* dgdf, const void* d, void* Hqq,
             void* Hqf, void* Hff, long long S, void* stream) {
  using K = rtt::KcStage<T, 18, 12, NG>;
  return launch<T, K::WS>(kc_kernel<T, 18, 12, NG>, S, stream, in<T>(dgdq),
                          in<T>(dgdf), in<T>(d), out<T>(Hqq), out<T>(Hqf),
                          out<T>(Hff));
}

template <int NG>
int kc_dtype(int dtype, const void* dgdq, const void* dgdf, const void* d,
             void* Hqq, void* Hqf, void* Hff, long long S, void* stream) {
  if (dtype == 0)
    return kc_typed<float, NG>(dgdq, dgdf, d, Hqq, Hqf, Hff, S, stream);
  if (dtype == 1)
    return kc_typed<double, NG>(dgdq, dgdf, d, Hqq, Hqf, Hff, S, stream);
  return -1;
}

template <typename T>
int k2_typed(const void* G, const void* c0, const void* Hq, const void* Hv,
             const void* Hu, const void* Ha, const void* Hf,
             const void* cHqf, const void* gw, const void* gy, void* Qxx,
             void* Qxu, void* Quu, void* gtil, long long S, void* stream) {
  using K = rtt::K2Stage<T, 18, 12, 12>;
  return launch<T, K::WS>(k2_kernel<T, 18, 12, 12>, S, stream, in<T>(G),
                          in<T>(c0), in<T>(Hq), in<T>(Hv), in<T>(Hu),
                          in<T>(Ha), in<T>(Hf), in<T>(cHqf), in<T>(gw),
                          in<T>(gy), out<T>(Qxx), out<T>(Qxu), out<T>(Quu),
                          out<T>(gtil));
}

template <typename T>
int k3_typed(const void* G, const void* c0, const void* gtil,
             const void* Aqq, const void* Aqv, const void* xres_q,
             const void* Fv_res, const void* sA, const void* lam2,
             const void* lmdgmm, void* A, void* Bm, void* xres, void* lx,
             void* lu, long long S, void* stream) {
  using K = rtt::K3Stage<T, 18, 12, 12>;
  return launch<T, K::WS>(k3_kernel<T, 18, 12, 12>, S, stream, in<T>(G),
                          in<T>(c0), in<T>(gtil), in<T>(Aqq), in<T>(Aqv),
                          in<T>(xres_q), in<T>(Fv_res), in<T>(sA),
                          in<T>(lam2), in<T>(lmdgmm), out<T>(A), out<T>(Bm),
                          out<T>(xres), out<T>(lx), out<T>(lu));
}

}  // namespace

extern "C" {

int rtt_condense_k1(int dtype, int nv, int nf, int w, const void* M,
                    const void* J, const void* inact, const void* Tw1,
                    const void* Tw2, const void* r1, const void* e2,
                    void* inv11, void* inv12, void* Sinv, void* G, void* c0,
                    long long S, void* stream) {
  if (nv != 18 || nf != 12 || w != 48) return -1;
  if (dtype == 0)
    return k1_typed<float>(M, J, inact, Tw1, Tw2, r1, e2, inv11, inv12,
                           Sinv, G, c0, S, stream);
  if (dtype == 1)
    return k1_typed<double>(M, J, inact, Tw1, Tw2, r1, e2, inv11, inv12,
                            Sinv, G, c0, S, stream);
  return -1;
}

// nc: cone rows, 20 (four point feet) or 34 (two surface soles)
int rtt_condense_kc(int dtype, int nv, int nf, int nc, const void* dgdq,
                    const void* dgdf, const void* d, void* Hqq, void* Hqf,
                    void* Hff, long long S, void* stream) {
  if (nv != 18 || nf != 12) return -1;
  if (nc == 20)
    return kc_dtype<20>(dtype, dgdq, dgdf, d, Hqq, Hqf, Hff, S, stream);
  if (nc == 34)
    return kc_dtype<34>(dtype, dgdq, dgdf, d, Hqq, Hqf, Hff, S, stream);
  return -1;
}

int rtt_condense_k2(int dtype, int nv, int nu, int nf, const void* G,
                    const void* c0, const void* Hq, const void* Hv,
                    const void* Hu, const void* Ha, const void* Hf,
                    const void* cHqf, const void* gw, const void* gy,
                    void* Qxx, void* Qxu, void* Quu, void* gtil, long long S,
                    void* stream) {
  if (nv != 18 || nu != 12 || nf != 12) return -1;
  if (dtype == 0)
    return k2_typed<float>(G, c0, Hq, Hv, Hu, Ha, Hf, cHqf, gw, gy, Qxx, Qxu,
                           Quu, gtil, S, stream);
  if (dtype == 1)
    return k2_typed<double>(G, c0, Hq, Hv, Hu, Ha, Hf, cHqf, gw, gy, Qxx,
                            Qxu, Quu, gtil, S, stream);
  return -1;
}

int rtt_condense_k3(int dtype, int nv, int nu, int nf, const void* G,
                    const void* c0, const void* gtil, const void* Aqq,
                    const void* Aqv, const void* xres_q, const void* Fv_res,
                    const void* sA, const void* lam2, const void* lmdgmm,
                    void* A, void* Bm, void* xres, void* lx, void* lu,
                    long long S, void* stream) {
  if (nv != 18 || nu != 12 || nf != 12) return -1;
  if (dtype == 0)
    return k3_typed<float>(G, c0, gtil, Aqq, Aqv, xres_q, Fv_res, sA, lam2,
                           lmdgmm, A, Bm, xres, lx, lu, S, stream);
  if (dtype == 1)
    return k3_typed<double>(G, c0, gtil, Aqq, Aqv, xres_q, Fv_res, sA, lam2,
                            lmdgmm, A, Bm, xres, lx, lu, S, stream);
  return -1;
}

}  // extern "C"

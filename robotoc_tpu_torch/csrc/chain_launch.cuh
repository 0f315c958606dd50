// The chain kernel K6's launcher, shared by the libraries that
// instantiate it (csrc/chain.cu: ANYmal or the A1, and the iCub lower
// half; csrc/chain_icub.cu: the full iCub, built by its own nvcc beside it):
// a warp per stage, kWarps stages a block, each warp's workspace its own
// slice of dynamic shared memory (csrc/chain_stage.cuh).
#pragma once

#include <cuda_runtime.h>

#include "chain_stage.cuh"

extern __shared__ __align__(16) unsigned char rtt_smem[];

namespace {

constexpr int kWarps = 4;                 // stages per block
constexpr int kThreads = 32 * kWarps;

template <typename T>
struct Ptrs {
  const T* in[21];
  T* out[22];
};

// f32 held to 128 registers (4 blocks, 16 warps an SM), f64 to 255
template <typename T, typename TREE, bool WC>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
chain_kernel(const T* __restrict__ consts, const int* __restrict__ topo,
             Ptrs<T> p, long long S) {
  using Stage = rtt::ChainStage<T, TREE, WC>;
  const int warp = threadIdx.x / 32;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= S) return;   // the whole warp: its barriers are its own
  Stage::run(consts, topo, p.in, p.out, s,
             reinterpret_cast<T*>(rtt_smem) + Stage::WS * warp,
             threadIdx.x % 32, 32);
}

template <typename T, typename TREE, bool WC>
int launch(const void* consts, const void* topo, const void* const* ins,
           void* const* outs, long long S, void* stream) {
  using Stage = rtt::ChainStage<T, TREE, WC>;
  if (S == 0) return 0;
  Ptrs<T> p;
  for (int i = 0; i < Stage::N_IN; ++i) p.in[i] = static_cast<const T*>(ins[i]);
  for (int i = 0; i < Stage::N_OUT; ++i) p.out[i] = static_cast<T*>(outs[i]);
  auto kernel = chain_kernel<T, TREE, WC>;
  const size_t bytes = sizeof(T) * Stage::WS * kWarps;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((S + kWarps - 1) / kWarps);
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const int*>(topo), p, S);
  return static_cast<int>(cudaGetLastError());
}

// -2 when the model's chain layout (chains of up to max_len joints on
// n_levels levels) does not fit TREE's workspace
template <typename TREE>
int dispatch(int dtype, int with_cost, int max_len, int n_levels,
             const void* consts, const void* topo, const void* const* ins,
             void* const* outs, long long S, void* stream) {
  if (!rtt::layout_fits<TREE>(max_len, n_levels)) return -2;
  if (dtype == 0)
    return with_cost
               ? launch<float, TREE, true>(consts, topo, ins, outs, S, stream)
               : launch<float, TREE, false>(consts, topo, ins, outs, S,
                                            stream);
  if (dtype == 1)
    return with_cost
               ? launch<double, TREE, true>(consts, topo, ins, outs, S,
                                            stream)
               : launch<double, TREE, false>(consts, topo, ins, outs, S,
                                             stream);
  return -1;
}

template <typename TREE>
bool is(int nv, int nj, int nc, int ctype) {
  return nv == TREE::NV && nj == TREE::NJ && nc == TREE::NC
         && ctype == TREE::CT;
}

}  // namespace

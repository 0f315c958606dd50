// Kinematic-chain kernel K6 for Hopper (sm_90a), plain C interface.
//
// Replaces robotoc_tpu ops/pallas_chain.py:_chain_kernel (launch :1110,
// entry make_chain :1121 / get_chain :1186): its point-contact branch for
// ANYmal's four feet and its surface-contact branch for the iCub lower
// half's two soles. Built for (NV, NJ, NC, contact type) = (18, 13, 4,
// point) and (18, 13, 2, surface), each in float and double, with and
// without the cost fold.
//
// Design: one thread block per stage (the fleet's B x S stages flattened,
// as the Pallas entry's custom-vmap rule did), 64 threads of which the
// first 3 nv = 54 each own one tangent column (dq | dv | da) and carry it
// as a value/tangent pair through the level-ordered forward sweep, the
// contact, cone and task rows and the RNEA backward sweep
// (csrc/chain_stage.cuh). Every column recomputes the values beside its
// tangent; column 0 alone stores them in shared memory, where the other
// columns read their parents' values. The columns' tangent state lives
// there too, 50 KB in f32 and 100 KB in f64 with the cost fold, above
// 48 KB by cudaFuncSetAttribute as for K5. Structural zeros (a
// placement's dv/da tangent, a velocity's da tangent) are not stored, but
// the dv/da columns still multiply their zero placement tangents through.
// The Pallas kernel's 128-lane tiling and its pre-broadcast constants are
// gone; the model constants and topology are two small device arrays
// every block reads.
//
// Bound on the card: per stage the kernel reads about 0.2 K values
// (configuration, velocity, acceleration, forces, references) and writes
// about 3.0 K (the 18 x 18 and 12 x 18 Jacobian blocks dominate), some
// 13 KB in f32, about 40 MB for 3072 stages: 12 us at 3.35 TB/s. The
// function needs about 50 K operations per stage (values once, structural
// zeros skipped; counted by csrc/chain_flops.cpp), 2.3 us for 3072 stages
// at the f32 peak, so bytes bound it. The kernel as written does about
// 23 times that arithmetic (the recomputed values and the zero tangents),
// and it is latency-bound besides: a stage's 54 columns fill under two
// warps and the levels are barriers. Making it fast (values once per
// level, the zero tangents skipped, several stages per block) is queued
// in ROADMAP.md under K6.
//
// The surface branch adds per contact 6 Baumgarte rows (3 for a point) and
// 17 cone rows (5); its cone rows take no tangents (the wrench cone acts on
// the local wrench), and its SE(3)-log residual is the so3 log and
// left-Jacobian inverse the cost fold already runs. At the walk's shapes
// (3584 stages, f32, cost fold) it moves about 14 KB per stage, ~52 MB:
// 16 us at 3.35 TB/s; bytes bound it as they bound the point branch.
//
// C interface: rtt_chain(dtype, with_cost, nv, nj, nc, ctype, consts,
// topo, ins, outs, S, stream); ins/outs are host arrays of device pointers
// in the order of ops/chain.py, ctype is 3 (point) or 6 (surface). Returns
// 0, -1 for an unsupported dtype/dims/contact type, else the
// cudaGetLastError() code after the launch. dtype 0 = float, 1 = double.
#include <cuda_runtime.h>

#include "chain_stage.cuh"

extern __shared__ __align__(16) unsigned char rtt_smem[];

namespace {

constexpr int kThreads = 64;
constexpr int NV = 18, NJ = 13;   // ANYmal and the iCub lower half

template <typename T>
struct Ptrs {
  const T* in[21];
  T* out[22];
};

template <typename T, int NC, int CT, bool WC>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const T* __restrict__ consts, const int* __restrict__ topo,
             Ptrs<T> p) {
  rtt::ChainStage<T, NV, NJ, NC, WC, CT>::run(
      consts, topo, p.in, p.out, blockIdx.x, reinterpret_cast<T*>(rtt_smem),
      threadIdx.x, blockDim.x);
}

template <typename T, int NC, int CT, bool WC>
int launch(const void* consts, const void* topo, const void* const* ins,
           void* const* outs, long long S, void* stream) {
  using Stage = rtt::ChainStage<T, NV, NJ, NC, WC, CT>;
  if (S == 0) return 0;
  Ptrs<T> p;
  for (int i = 0; i < Stage::N_IN; ++i) p.in[i] = static_cast<const T*>(ins[i]);
  for (int i = 0; i < Stage::N_OUT; ++i) p.out[i] = static_cast<T*>(outs[i]);
  auto kernel = chain_kernel<T, NC, CT, WC>;
  const size_t bytes = sizeof(T) * Stage::WS;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(S), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const int*>(topo), p);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, int CT>
int dispatch(int dtype, int with_cost, const void* consts, const void* topo,
             const void* const* ins, void* const* outs, long long S,
             void* stream) {
  if (dtype == 0)
    return with_cost
               ? launch<float, NC, CT, true>(consts, topo, ins, outs, S, stream)
               : launch<float, NC, CT, false>(consts, topo, ins, outs, S,
                                              stream);
  if (dtype == 1)
    return with_cost
               ? launch<double, NC, CT, true>(consts, topo, ins, outs, S,
                                              stream)
               : launch<double, NC, CT, false>(consts, topo, ins, outs, S,
                                               stream);
  return -1;
}

}  // namespace

extern "C" int rtt_chain(int dtype, int with_cost, int nv, int nj, int nc,
                         int ctype, const void* consts, const void* topo,
                         const void* const* ins, void* const* outs,
                         long long S, void* stream) {
  if (nv != NV || nj != NJ) return -1;
  if (nc == 4 && ctype == rtt::kPoint)       // ANYmal, four point feet
    return dispatch<4, rtt::kPoint>(dtype, with_cost, consts, topo, ins, outs,
                                    S, stream);
  if (nc == 2 && ctype == rtt::kSurface)     // iCub lower half, two soles
    return dispatch<2, rtt::kSurface>(dtype, with_cost, consts, topo, ins,
                                      outs, S, stream);
  return -1;
}

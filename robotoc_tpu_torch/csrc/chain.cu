// Kinematic-chain kernel K6 for Hopper (sm_90a), plain C interface.
//
// Replaces robotoc_tpu ops/pallas_chain.py:_chain_kernel (launch :1110,
// entry make_chain :1121 / get_chain :1186): its point-contact branch for
// four feet (ANYmal's or the A1's) and its surface-contact branch for the
// iCub soles. Built for the trees of csrc/chain_stage.cuh (ChainTree):
// (NV, NJ, NC, contact type) = (18, 13, 4, point), ANYmal and the A1 (one
// instance: both are four chains of three joints on the base; the A1's
// feet sit on the chains in another order, contact_chain (1, 3, 0, 2)
// against ANYmal's (0, 2, 1, 3), which the layout table carries, and its
// link offsets are model constants); (18, 13, 2, surface), the
// iCub lower half; (35, 30, 2, surface), the full iCub, whose torso
// carries both arms (checked against the plain version only: no MPC path
// of the port runs it; csrc/chain_icub.cu, a library of its own so that
// its nvcc runs beside this one's); each in float and double, with and
// without the cost fold. The chain layout (which joints form a chain, where each
// chain hangs) is a table read from the model (ops/chain.chain_layout).
//
// Design: a warp per stage, kWarps stages per block (the fleet's B x S
// stages flattened, as the Pallas entry's custom-vmap rule did), every
// barrier the warp's own (__syncwarp; csrc/chain_stage.cuh): the values
// once, by one lane per chain, then the tangents, one column (dq | dv |
// da) per lane, as plain scalars and only where they are not structural
// zeros, then the cost fold's products over the lanes. A stage's workspace
// in shared memory holds its values, each lane's force tangents along the
// chains it has open and the cost fold's rows (ChainStage::WS, f32: 5.3 KB
// without the fold, 8.9 KB with it at ANYmal's widths; 7.2 and 10.4 KB at
// the iCub lower half's, 27.7 KB with the fold for the full iCub); the
// other tangents live in registers. f32 is held to 128
// registers a thread, so 16 warps share an SM. The Pallas kernel's
// 128-lane tiling and its pre-broadcast constants are gone; the model
// constants and topology are two small device arrays every warp reads
// through the cache.
//
// Bound on the card: per stage the kernel reads about 0.2 K values
// (configuration, velocity, acceleration, forces, references) and writes
// about 3.0 K (the 18 x 18 and 12 x 18 Jacobian blocks dominate), some
// 13 KB in f32, about 40 MB for 3072 stages: 12 us at 3.35 TB/s. Its
// body does about 53 K operations per stage besides those on structural
// zeros (counted by csrc/chain_flops.cpp), 2.4 us for 3072 stages at the
// f32 peak, so bytes bound it. On
// "NVIDIA H100 80GB HBM3, 700.00 W" (device time, f32, chip_smoke.py's
// kernels phase): 0.175 ms at the trot's 3072 stages with the cost fold,
// 14 times its bound, 2.4 times faster than the value/tangent-pair kernel
// it replaced; reading the chain layout from a table costs it under 8 %
// against a body built for star trees alone. What holds it
// there: a warp's time is its slowest lane's, and the base columns walk
// every chain while a leg column touches one; in the value pass one lane
// a chain works.
//
// The surface branch adds per contact 6 Baumgarte rows (3 for a point) and
// 17 cone rows (5); its cone rows take no tangents (the wrench cone acts on
// the local wrench), and its SE(3)-log residual is the so3 log and
// left-Jacobian inverse the cost fold already runs, split into values and
// tangents as the rest. At the walk's shapes (3584 stages, f32, cost fold)
// it moves about 14 KB per stage, ~52 MB: 16 us at 3.35 TB/s; bytes bound
// it as they bound the point branch. On the same card: 0.164-0.178 ms,
// 11 times its bound.
//
// C interface: rtt_chain(dtype, with_cost, nv, nj, nc, ctype, max_len,
// n_levels, consts, topo, ins, outs, S, stream); ins/outs are host arrays
// of device pointers in the order of ops/chain.py, ctype is 3 (point) or 6
// (surface), max_len and n_levels the model's longest chain and number of
// chain levels (ops/chain.chain_layout). Returns 0, -1 for an unsupported
// dtype/dims/contact type, -2 for a chain layout past the tree's workspace
// (ChainTree's capacities), else the cudaGetLastError() code after the
// launch. dtype 0 = float, 1 = double.
#include "chain_launch.cuh"

extern "C" int rtt_chain(int dtype, int with_cost, int nv, int nj, int nc,
                         int ctype, int max_len, int n_levels,
                         const void* consts, const void* topo,
                         const void* const* ins, void* const* outs,
                         long long S, void* stream) {
  if (is<rtt::AnymalFeet>(nv, nj, nc, ctype))
    return dispatch<rtt::AnymalFeet>(dtype, with_cost, max_len, n_levels,
                                     consts, topo, ins, outs, S, stream);
  if (is<rtt::IcubLegSoles>(nv, nj, nc, ctype))
    return dispatch<rtt::IcubLegSoles>(dtype, with_cost, max_len, n_levels,
                                       consts, topo, ins, outs, S, stream);
  return -1;
}

// The chain kernel K6 for the full iCub (nv 35, 30 joints: two legs and a
// torso whose last joint carries both arms; two soles, surface contacts),
// plain C interface: the body and design of csrc/chain.cu, in a library of
// its own so that its nvcc runs beside chain.cu's. No MPC path of the port
// runs it yet; it is held against the plain version (ops/chain.chain_plain)
// on seeded stages. It moves about 28 KB a stage in f32 (35 KB with the
// cost fold; the 35 x 35 Jacobian blocks dominate): bytes bound it, as
// they bound the other trees.
//
// C interface: rtt_chain(...) as in csrc/chain.cu, for (nv, nj, nc, ctype)
// = (35, 30, 2, 6) only.
#include "chain_launch.cuh"

extern "C" int rtt_chain(int dtype, int with_cost, int nv, int nj, int nc,
                         int ctype, int max_len, int n_levels,
                         const void* consts, const void* topo,
                         const void* const* ins, void* const* outs,
                         long long S, void* stream) {
  if (is<rtt::IcubSoles>(nv, nj, nc, ctype))
    return dispatch<rtt::IcubSoles>(dtype, with_cost, max_len, n_levels,
                                    consts, topo, ins, outs, S, stream);
  return -1;
}

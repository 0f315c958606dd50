// Operation count of the chain kernel K6, for its roofline bound (g++, no
// CUDA). Build: g++ -O2 -std=c++17 -shared -fPIC chain_flops.cpp.
//
// The kernel's own body (csrc/chain_stage.cuh) runs once per stage, one
// lane doing every lane's work, on a counting scalar, Flop, that carries a
// "structural zero" flag: literal zeros and the model constants that are
// exactly zero (axis components, identity entries) start it; a product
// with a structural zero and a sum of two are structural zeros, and cost
// nothing, as does a sum with one. Every other +, -, *, / and every sqrt,
// sin, cos, acos counts one operation. Data (configuration, velocities,
// forces, references, weights) is never a structural zero, whatever its
// value. The body computes each value once and propagates a tangent
// column only where it is not a structural zero, so the count is the
// arithmetic the kernel needs, without the multiplications by zero it
// does to keep its lanes in step. An operation is a tangent operation when
// an operand descends from a tangent seed (tan_seed, overloaded below),
// else a value operation.
#include <vector>

namespace fc {

struct Counts {
  bool on = false;
  long long value_ops = 0, tangent_ops = 0;
};
thread_local Counts g;   // one count per calling thread

struct Flop {
  double x = 0.0;
  bool zero = false, tan = false;
  Flop() = default;
  Flop(double v) : x(v), zero(v == 0.0) {}   // literals and model constants
  static Flop data(double v) { Flop f; f.x = v; return f; }
};

inline Flop counted(double x, bool zero, bool tan, bool work) {
  Flop r;
  r.x = x;
  r.zero = zero;
  r.tan = tan;
  if (g.on && work) {
    if (tan)
      ++g.tangent_ops;
    else
      ++g.value_ops;
  }
  return r;
}

inline Flop operator+(Flop a, Flop b) {
  return counted(a.x + b.x, a.zero && b.zero, a.tan || b.tan,
                 !a.zero && !b.zero);
}
inline Flop operator-(Flop a, Flop b) {
  return counted(a.x - b.x, a.zero && b.zero, a.tan || b.tan,
                 !a.zero && !b.zero);
}
inline Flop operator*(Flop a, Flop b) {
  return counted(a.x * b.x, a.zero || b.zero, a.tan || b.tan,
                 !a.zero && !b.zero);
}
inline Flop operator/(Flop a, Flop b) {
  return counted(a.x / b.x, a.zero, a.tan || b.tan, !a.zero);
}
inline Flop operator-(Flop a) {
  a.x = -a.x;
  return a;
}
inline Flop& operator+=(Flop& a, Flop b) { return a = a + b; }
inline Flop& operator-=(Flop& a, Flop b) { return a = a - b; }
inline bool operator<(Flop a, Flop b) { return a.x < b.x; }
inline bool operator>(Flop a, Flop b) { return a.x > b.x; }

inline Flop unary(double x, Flop a) { return counted(x, false, a.tan, true); }
inline Flop tan_seed(Flop x) {   // where the kernel's tangents start
  x.tan = true;
  return x;
}
}  // namespace fc

#include <math.h>

namespace fc {
inline Flop m_sqrt(Flop a) { return unary(sqrt(a.x), a); }
inline Flop m_sin(Flop a) { return unary(sin(a.x), a); }
inline Flop m_cos(Flop a) { return unary(cos(a.x), a); }
inline Flop m_acos(Flop a) { return unary(acos(a.x), a); }
}  // namespace fc

#include "chain_stage.cuh"

namespace {

template <typename TREE, bool WC>
void count(const double* consts, int n_consts, const int* topo,
           const double* const* ins, long long S, long long* out) {
  using K = rtt::ChainStage<fc::Flop, TREE, WC>;
  using fc::Flop;
  std::vector<Flop> c(consts, consts + n_consts);
  std::vector<std::vector<Flop>> in(K::N_IN), res(K::N_OUT);
  for (int i = 0; i < K::N_OUT; ++i) res[i].resize(K::out_size(i));
  std::vector<Flop> ws(K::WS, Flop::data(0.0));
  const Flop* in_p[21];
  Flop* out_p[22];
  for (long long s = 0; s < S; ++s) {
    for (int i = 0; i < K::N_IN; ++i) {
      in[i].resize(K::in_size(i));
      for (int k = 0; k < K::in_size(i); ++k)
        in[i][k] = Flop::data(ins[i][s * K::in_size(i) + k]);
      in_p[i] = in[i].data();
    }
    for (int i = 0; i < K::N_OUT; ++i) out_p[i] = res[i].data();
    fc::g.on = true;
    K::run(c.data(), topo, in_p, out_p, 0, ws.data(), 0, 1);
    fc::g.on = false;
  }
  out[0] = fc::g.value_ops;
  out[1] = fc::g.tangent_ops;
  fc::g = fc::Counts();
}

// 1 when TREE is (nv, nc, ctype) and its layout fits (-2 when it does
// not), 0 for another tree
template <typename TREE>
int count_tree(int nv, int with_cost, int nc, int ctype, const double* consts,
               int n_consts, const int* topo, const double* const* ins,
               long long S, long long* out) {
  if (nv != TREE::NV || nc != TREE::NC || ctype != TREE::CT) return 0;
  if (!rtt::layout_fits<TREE>(topo)) return -2;
  if (with_cost)
    count<TREE, true>(consts, n_consts, topo, ins, S, out);
  else
    count<TREE, false>(consts, n_consts, topo, ins, S, out);
  return 1;
}
}  // namespace

extern "C" {

// Operations of K6 over S stages for the trees of csrc/chain_stage.cuh
// (nv 18: the 4 point feet of ANYmal or the A1, nc 4, ctype 3, or the iCub
// lower half's 2 soles, nc 2, ctype 6; nv 35: the full iCub's 2 soles), inputs in the
// order of ops/chain.py, float64 on the host: out[0] value operations,
// out[1] tangent operations. Returns 0, -1 for another tree, -2 for a
// chain layout past the tree's workspace.
int rtt_chain_flops(int nv, int with_cost, int nc, int ctype,
                    const double* consts, int n_consts, const int* topo,
                    const double* const* ins, long long S, long long* out) {
  int rc = count_tree<rtt::AnymalFeet>(nv, with_cost, nc, ctype, consts,
                                       n_consts, topo, ins, S, out);
  if (!rc)
    rc = count_tree<rtt::IcubLegSoles>(nv, with_cost, nc, ctype, consts,
                                       n_consts, topo, ins, S, out);
  if (!rc)
    rc = count_tree<rtt::IcubSoles>(nv, with_cost, nc, ctype, consts,
                                    n_consts, topo, ins, S, out);
  return rc == 1 ? 0 : (rc == 0 ? -1 : rc);
}

}  // extern "C"

// Operation count of the chain kernel K6's function, for its roofline
// bound (g++, no CUDA). Build: g++ -O2 -std=c++17 -shared -fPIC
// chain_flops.cpp.
//
// The per-stage body of csrc/chain_stage.cuh runs on a counting scalar,
// Flop, that carries a "structural zero" flag: literal zeros and the model
// constants that are exactly zero (axis components, identity entries)
// start it; a product with a structural zero and a sum of two are
// structural zeros, and cost nothing, as does a sum with one. Every other
// +, -, *, / and every sqrt, sin, cos, acos counts one operation. Data
// (configuration, velocities, forces, references, weights) is never a
// structural zero, whatever its value.
//
// The kernel recomputes every value in each of its 3 nv tangent columns
// and multiplies zero tangents through; the count does not charge either:
//   * each stage runs once uncounted, to fill the workspace, then once per
//     column: thread t of 3 nv threads, one thread after another;
//   * an operation whose operands are all values counts only in thread
//     0's run, i.e. once per stage. Thread 0's run also holds its share of
//     the cooperative loops' value-only arithmetic (the cost fold's
//     gradient rows); the other threads' shares, about 750 operations per
//     stage, are not counted;
//   * an operation that reads a tangent counts in every thread's run, but
//     only where no operand is a structural zero: a placement's dv/da
//     tangent, a velocity's da tangent and a joint's tangent in a column
//     of another branch of the tree cost nothing.
// What this leaves counted twice: the Gauss-Jordan pivot reciprocal each
// thread computes (6 per stage and thread).
//
// With as_written the same runs count every operation of every thread,
// zeros and repeated values included: the arithmetic the kernel does.
#include <vector>

namespace fc {

struct Counts {
  bool on = false, values = false, as_written = false;
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
  if (g.on && (work || g.as_written)) {
    if (tan)
      ++g.tangent_ops;
    else if (g.values || g.as_written)
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
}  // namespace fc

#include <math.h>

namespace fc {
inline Flop m_sqrt(Flop a) { return unary(sqrt(a.x), a); }
inline Flop m_sin(Flop a) { return unary(sin(a.x), a); }
inline Flop m_cos(Flop a) { return unary(cos(a.x), a); }
inline Flop m_acos(Flop a) { return unary(acos(a.x), a); }
}  // namespace fc

#include "chain_stage.cuh"

namespace rtt {
// A dual's second member is a tangent: mark it so.
template <>
struct Dual<fc::Flop> {
  using F = fc::Flop;
  F v, d;
  static F tangent(F x) {
    x.tan = true;
    return x;
  }
  Dual() : v(0.0), d(tangent(F(0.0))) {}
  Dual(F v_, F d_ = F(0.0)) : v(v_), d(tangent(d_)) {}
  friend Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
  friend Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
  friend Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
  friend Dual operator*(Dual a, Dual b) {
    return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
  }
};
}  // namespace rtt

namespace {
constexpr int NV = 18, NJ = 13;   // ANYmal and the iCub lower half

template <int NC, int CT, bool WC>
void count(const double* consts, int n_consts, const int* topo,
           const double* const* ins, long long S, bool as_written,
           long long* out) {
  using K = rtt::ChainStage<fc::Flop, NV, NJ, NC, WC, CT>;
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
    fc::g.on = false;
    fc::g.as_written = as_written;
    K::run(c.data(), topo, in_p, out_p, 0, ws.data(), 0, 1);
    fc::g.on = true;
    for (int t = 0; t < K::NCOL; ++t) {
      fc::g.values = t == 0;
      K::run(c.data(), topo, in_p, out_p, 0, ws.data(), t, K::NCOL);
    }
    fc::g.on = false;
  }
  out[0] = fc::g.value_ops;
  out[1] = fc::g.tangent_ops;
  fc::g = fc::Counts();
}

template <int NC, int CT>
void count_wc(int with_cost, const double* consts, int n_consts,
              const int* topo, const double* const* ins, long long S,
              bool as_written, long long* out) {
  if (with_cost)
    count<NC, CT, true>(consts, n_consts, topo, ins, S, as_written, out);
  else
    count<NC, CT, false>(consts, n_consts, topo, ins, S, as_written, out);
}
}  // namespace

extern "C" {

// Operations of K6's function over S stages (nv 18, 13 joints: ANYmal's 4
// point feet, nc 4, ctype 3, or the iCub lower half's 2 soles, nc 2,
// ctype 6), inputs in the order of ops/chain.py, float64 on the host:
// out[0] value operations, out[1] tangent operations.
int rtt_chain_flops(int with_cost, int as_written, int nc, int ctype,
                    const double* consts, int n_consts, const int* topo,
                    const double* const* ins, long long S, long long* out) {
  if (nc == 4 && ctype == rtt::kPoint)
    count_wc<4, rtt::kPoint>(with_cost, consts, n_consts, topo, ins, S,
                             as_written != 0, out);
  else if (nc == 2 && ctype == rtt::kSurface)
    count_wc<2, rtt::kSurface>(with_cost, consts, n_consts, topo, ins, S,
                               as_written != 0, out);
  else
    return -1;
  return 0;
}

}  // extern "C"

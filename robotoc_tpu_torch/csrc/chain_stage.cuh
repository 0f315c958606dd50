// Per-stage body of the kinematic-chain kernel K6 (csrc/chain.cu).
//
// Replaces robotoc_tpu ops/pallas_chain.py:_chain_kernel. For one stage it
// evaluates inverse dynamics (RNEA), the Baumgarte contact residuals, the
// contact-cone rows and the task rows (contact-frame positions, CoM)
// together with their Jacobians over the 3 NV tangent columns
// (dq | dv | da), and, with WITH_COST, the Gauss-Newton blocks of the gait
// cost stack and the Lie state-equation base blocks. The contact stack is
// uniform, of type CT: point contacts (CT = 3: 3-D force, classical
// acceleration + position residual, 5-facet pyramid on the world force,
// pallas_chain.py:731-754) or surface contacts (CT = 6: 6-D wrench, spatial
// acceleration + SE(3)-log residual against (R_ref, p_ref), 17-row
// rectangular wrench cone on the local wrench, pallas_chain.py:798-839).
//
// The tree is a free base (joint 0) carrying revolute joints numbered depth
// first (velocity index 5 + joint), cut into chains: runs of consecutive
// joints, each the only child of the one before, that start at a child of
// the base or of a branch point and end at a leaf or a branch point. The
// layout is read from the model at run time (ops/chain.chain_layout, the
// table ChainModel reads): each chain's first joint, length, parent joint,
// level (chains between it and the base) and descendant chains, which
// follow it in order. ANYmal and the A1 are four chains of 3 on the base,
// the iCub lower half two of 6; the full iCub adds a torso chain whose last joint
// carries both arms, at level 1. TREE (ChainTree below) sets the
// workspace's capacities: the longest chain and the number of levels.
//
// Design: a team of `nl` lanes works on one stage (a warp on the card; on
// the host one lane, csrc/host_shim.cpp), and every barrier is the team's
// (warp_sync). The stage runs in three passes.
//  * Values, once: the base, then level by level one lane per chain
//    walking it root to leaf (placements, velocities, accelerations, net
//    joint forces), then level by level from the deepest one lane per
//    chain summing the forces leaf to root (a branch point adds the forces
//    its child chains pass up), with, at level 0, one lane per contact
//    (residual, cone and task rows, the SE(3) log's scalars), one for the
//    CoM and, with the fold, three for the cost's Lie residuals. They go to
//    the stage's workspace in shared memory.
//  * Tangents: one lane per column (lane, lane + nl, ...) propagates plain
//    T tangents, reading the values as constants, and only where they are
//    not structural zeros: a dq column carries placement, velocity and
//    acceleration tangents, a dv column velocity and acceleration, a da
//    column acceleration only (linear recurrences); a column of a joint
//    starts at that joint and moves its own chain and the chains below it
//    (its force tangents climb to the base through the chains above), a
//    base column walks every chain. A chain's walk starts from its parent
//    joint's tangents (the base's, or a branch point's kept in a
//    lane-private slot). The force tangents of a chain's joints wait for
//    its leaf-to-root sum in a lane-private slot of its level
//    ([level][joint][component][lane]: no bank conflicts); the sum runs
//    when the walk leaves the chain's subtree. Each output entry of the
//    dense Jacobian blocks is written once, zeros included, by the lane of
//    its column: neighbouring lanes write neighbouring columns of a row.
//  * The cost fold: its residual Jacobian rows (base columns through the
//    SE(3) log's tangent, joint columns the identity), then the
//    Gauss-Newton products spread over the lanes, and the 6 x 6
//    Gauss-Jordan a row per lane by shuffles.
// Bytes bound it on the card (about 13 KB of outputs a stage against the
// operations csrc/chain_flops.cpp counts in this body, csrc/chain.cu); it
// is held above the bytes bound by its warp's slowest lane: a base column
// walks every chain, a leg column one.
// The small-angle series of so3 log / se3 log's left-Jacobian inverse
// follow pallas_chain.py:266-347 (with the native acos, and sin theta
// taken as sqrt((1 - c)(1 + c)) so that float32 keeps its digits near the
// identity). The CPU tests hold this body against chain_plain.
#pragma once

#include "chain_math.cuh"

namespace rtt {

// Identity; csrc/chain_flops.cpp overloads it to mark where tangents start.
template <typename T>
RTT_HD T tan_seed(T x) {
  return x;
}

// ---- Lie logs, split into values (once) and tangents (per column) -------
// A log record: the rotation R 0-8, the translation p 9-11, w = log3(R)
// 12-14, the so3 scale and its derivative in tr R 15-16, the se3 k2 and
// its derivative in |w|^2 17-18.
constexpr int LG_R = 0, LG_P = 9, LG_W = 12, LG_S = 15, LG_SG = 16,
              LG_K2 = 17, LG_K2G = 18, LG_N = 19;

template <typename T>
RTT_HD void log3_val(const T* R, T* L) {
  for (int i = 0; i < 9; ++i) L[LG_R + i] = R[i];
  T theta, s, c;
  theta_s(R[0] + R[4] + R[8], theta, s, c);
  const T t2 = theta * theta;
  const bool small = t2 < T(1e-6);
  const T val = small ? T(0.5) + t2 / T(12) + T(7) * t2 * t2 / T(720)
                      : theta / (T(2) * s);
  L[LG_S] = val;
  L[LG_SG] = small ? -(T(1) / T(12) + T(7) * t2 / T(360))
                   : (theta * c - s) / (T(4) * s * s * s);
  L[LG_W] = val * (R[7] - R[5]);
  L[LG_W + 1] = val * (R[2] - R[6]);
  L[LG_W + 2] = val * (R[3] - R[1]);
}

template <typename T>
RTT_HD void log3_tan(const T* L, const T* dR, T* dw) {
  const T* R = L + LG_R;
  const T ds = L[LG_SG] * (dR[0] + dR[4] + dR[8]);
  const T s = L[LG_S];
  dw[0] = ds * (R[7] - R[5]) + s * (dR[7] - dR[5]);
  dw[1] = ds * (R[2] - R[6]) + s * (dR[2] - dR[6]);
  dw[2] = ds * (R[3] - R[1]) + s * (dR[3] - dR[1]);
}

// se3 log of (R, p): w = log3(R), v = V^{-1}(w) p
template <typename T>
RTT_HD void log6_val(const T* R, const T* p, T* L, T* v) {
  log3_val(R, L);
  for (int i = 0; i < 3; ++i) L[LG_P + i] = p[i];
  const T* w = L + LG_W;
  const T t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const T t2c = t2 > T(0) ? t2 : T(0);
  const T t = m_sqrt(t2c > T(1e-24) ? t2c : T(1e-24));
  const bool small = t2c < T(1e-6);
  const T s = m_sin(t), c = m_cos(t);
  T val, grad;
  if (small) {
    val = T(1) / T(12) + t2c / T(720) + t2c * t2c / T(30240);
    grad = T(1) / T(720) + t2c / T(15120);
  } else {
    const T N = T(1) + c, D = T(2) * t * s;
    const T dN = -s, dD = T(2) * s + T(2) * t * c;
    val = T(1) / t2c - N / D;
    grad = (-T(2) / (t * t * t) - (dN * D - N * dD) / (D * D)) / (T(2) * t);
  }
  L[LG_K2] = val;
  L[LG_K2G] = grad;
  T wxp[3], wxwxp[3];
  cross3(w, p, wxp);
  cross3(w, wxp, wxwxp);
  for (int i = 0; i < 3; ++i) v[i] = p[i] - T(0.5) * wxp[i] + val * wxwxp[i];
}

template <typename T>
RTT_HD void log6_tan(const T* L, const T* dR, const T* dp, T* dv, T* dw) {
  log3_tan(L, dR, dw);
  const T* w = L + LG_W;
  const T* p = L + LG_P;
  const T dk2 = L[LG_K2G] * (T(2) * (w[0] * dw[0] + w[1] * dw[1]
                                     + w[2] * dw[2]));
  T wxp[3], wxwxp[3], a[3], b[3], dwxp[3], c[3], e[3], dwxwxp[3];
  cross3(w, p, wxp);
  cross3(w, wxp, wxwxp);
  cross3(dw, p, a);
  cross3(w, dp, b);
  for (int i = 0; i < 3; ++i) dwxp[i] = a[i] + b[i];
  cross3(dw, wxp, c);
  cross3(w, dwxp, e);
  for (int i = 0; i < 3; ++i) dwxwxp[i] = c[i] + e[i];
  for (int i = 0; i < 3; ++i)
    dv[i] = dp[i] - T(0.5) * dwxp[i] + dk2 * wxwxp[i]
            + L[LG_K2] * dwxwxp[i];
}

// R hat(a): row r is row_r x a
template <typename T>
RTT_HD void r_hat(const T* R, const T* a, T* o) {
  for (int r = 0; r < 3; ++r) cross3(R + 3 * r, a, o + 3 * r);
}

// the right perturbation of a base pose along base tangent k (0-2 linear,
// 3-5 angular): dR = R hat(e_k), dp = R e_k
template <typename T>
RTT_HD void base_seed(const T* R, int k, T* dR, T* dp) {
  const T z = tan_seed(T(0));
  for (int i = 0; i < 9; ++i) dR[i] = z;
  for (int i = 0; i < 3; ++i) dp[i] = z;
  if (k < 3) {
    for (int r = 0; r < 3; ++r) dp[r] = tan_seed(R[3 * r + k]);
  } else {
    r_hat_e(R, k - 3, dR);
    for (int i = 0; i < 9; ++i) dR[i] = tan_seed(dR[i]);
  }
}

// the 5-facet pyramid C_m on the world force (point contacts), row r:
// (0, 0, -1), (1, 0, -c), (-1, 0, -c), (0, 1, -c), (0, -1, -c) with
// c = mu / sqrt 2
template <typename T>
RTT_HD void cone_point_row(T mu, int r, T* o) {
  const T cc = mu / m_sqrt(T(2));
  o[0] = r == 1 ? T(1) : (r == 2 ? T(-1) : T(0));
  o[1] = r == 3 ? T(1) : (r == 4 ? T(-1) : T(0));
  o[2] = r == 0 ? T(-1) : -cc;
}

// the 17-row rectangular wrench cone W(mu, X, Y) on the local wrench, row
// r: the unilateral row, four friction rows, four centre-of-pressure rows,
// then eight yaw rows (+-Y, +-X, -(X + Y) mu, +-mu, +-mu, -+1)
template <typename T>
RTT_HD void cone_surface_row(T mu, T X, T Y, int r, T* o) {
  for (int k = 0; k < 6; ++k) o[k] = T(0);
  if (r == 0) {
    o[2] = T(-1);
  } else if (r < 5) {           // (-+1, 0, -mu), (0, -+1, -mu)
    o[(r - 1) / 2] = r % 2 ? T(-1) : T(1);
    o[2] = -mu;
  } else if (r < 9) {           // (0, 0, -Y, -+1, 0, 0), (0, 0, -X, 0, -+1)
    o[2] = r < 7 ? -Y : -X;
    o[3 + (r - 5) / 2] = r % 2 ? T(-1) : T(1);
  } else {
    const int t = r - 9, u = t & 3;
    const T h = t < 4 ? T(1) : T(-1);
    o[0] = h * (u >> 1 ? Y : -Y);
    o[1] = h * (u & 1 ? X : -X);
    o[2] = -((X + Y) * mu);
    o[3] = u >> 1 ? -mu : mu;
    o[4] = u & 1 ? -mu : mu;
    o[5] = -h;
  }
}

// The trees K6 is built for: (NV, NJ, NC contacts of type CT) and the
// capacities of the chain layout's workspace, the longest chain (MAXLEN)
// and the number of chain levels (NLEV).
template <int NV_, int NJ_, int NC_, int CT_, int MAXLEN_, int NLEV_>
struct ChainTree {
  static constexpr int NV = NV_, NJ = NJ_, NC = NC_, CT = CT_;
  static constexpr int MAXLEN = MAXLEN_, NLEV = NLEV_;
};
// four legs: ANYmal and the A1
using AnymalFeet = ChainTree<18, 13, 4, kPoint, 3, 1>;
using IcubLegSoles = ChainTree<18, 13, 2, kSurface, 6, 1>;  // lower half
using IcubSoles = ChainTree<35, 30, 2, kSurface, 7, 2>;     // full iCub

// Whether a chain layout of chains of up to max_len joints on n_levels
// levels fits TREE's workspace: the launchers refuse one that does not.
template <typename TREE>
RTT_HD bool layout_fits(int max_len, int n_levels) {
  return max_len <= TREE::MAXLEN && n_levels <= TREE::NLEV;
}

// The same for the layout of a topology table in host memory
// (ops/chain.model_tables).
template <typename TREE>
bool layout_fits(const int* topo) {
  const ChainModel<double, TREE::NJ, TREE::NC> m{nullptr, topo};
  int max_len = 0;
  for (int ch = 0; ch < m.n_chains(); ++ch)
    max_len = m.ch_len(ch) > max_len ? m.ch_len(ch) : max_len;
  return layout_fits<TREE>(max_len, m.n_chain_levels());
}

template <typename T, typename TREE, bool WITH_COST>
struct ChainStage {
  static constexpr int NV = TREE::NV, NJ = TREE::NJ, NC = TREE::NC;
  static constexpr int CT = TREE::CT, MAXLEN = TREE::MAXLEN;
  static constexpr int NLEV = TREE::NLEV;
  static_assert(CT == kPoint || CT == kSurface, "contact type");
  using Model = ChainModel<T, NJ, NC>;
  static_assert(NV == 5 + NJ && NLEV >= 1,
                "a free base carrying revolute joints");
  static constexpr int NQ = NV + 1, NU = NV - 6, NCOL = 3 * NV;
  static constexpr int GC = CT == kPoint ? 5 : 17;   // cone rows a contact
  static constexpr int NF = CT * NC, NG = GC * NC, NT = 3 * NC + 3;
  static constexpr int NR = NV + 3 + NT;   // cost residual rows
  // inputs: q, v, a, f, fric, p_ref, R_ref, then the cost fold's
  static constexpr int I_COST = 7;
  static constexpr int N_IN = WITH_COST ? I_COST + 14 : I_COST;
  static constexpr int N_OUT = WITH_COST ? 22 : 13;
  // workspace of a stage (scalars). Per joint: world placement R 0-8,
  // p 9-11, velocity 12-17, acceleration 18-23 (no gravity), local
  // placement 24-35, net force 36-41 (after the backward sum, the force
  // the joint transmits to its parent), I v 42-47.
  static constexpr int J_R = 0, J_P = 9, J_V = 12, J_A = 18, J_RL = 24,
                       J_PL = 33, J_F = 36, J_IV = 42, JW = 48;
  // per contact: local frame velocity 0-5, world rotation 6-14, the
  // SE(3)-log record of the surface residual 15-33
  static constexpr int C_VF = 0, C_RW = 6, C_LG = 15, CW = C_LG + LG_N;
  static constexpr int O_J = 0, O_C = NJ * JW, O_T = O_C + NC * CW;
  // each lane's net force tangents of the chain open at each level,
  // [level][pos][k][lane], and the tangents (R, p, v, a: 24) of the last
  // joint of the chain open at each level but the deepest, [level][i][lane]
  // (32 lanes, a warp)
  static constexpr int TW = 24;
  static constexpr int O_DF = O_T + NT;
  static constexpr int O_TN = O_DF + NLEV * MAXLEN * 6 * 32;
  static constexpr int O_END = O_TN + (NLEV - 1) * TW * 32;
  // the cost fold: rot(q), rot(q_ref), rot(base-rotation ref), rot(q_next),
  // the log records of the q residual, the base-rotation residual and the
  // state equation, q_next - q (positions), then the stack's rows
  static constexpr int O_RQ = O_END, O_R0 = O_RQ + 9, O_RB = O_R0 + 9;
  static constexpr int O_RN = O_RB + 9, O_LQ = O_RN + 9, O_LB = O_LQ + LG_N;
  static constexpr int O_LS = O_LB + LG_N, O_DP = O_LS + LG_N;
  static constexpr int O_JR = O_DP + 3;                  // NR x NV
  static constexpr int O_RR = O_JR + NR * NV;           // NR residuals
  static constexpr int O_WR = O_RR + NR;                // NR weights
  static constexpr int O_JS = O_WR + NR;                // 6 x 12
  static constexpr int O_NU = O_JS + 72;                // 6
  static constexpr int O_A6 = O_NU + 6;                 // 6 x 6
  static constexpr int WS = WITH_COST ? O_A6 + 36 : O_END;

  static RTT_HD int in_size(int i) {
    const int s[21] = {NQ, NV, NV, NF, NC, 3 * NC, 9 * NC, NU, 1, NT, NT, 4,
                       NV, NV, NV, NU, NT, 3, NQ, NV, NQ};
    return s[i];
  }
  static RTT_HD int out_size(int i) {
    const int s[22] = {NV, NV * NV, NV * NV, NV * NV, NF, NF * NV, NF * NV,
                       NF * NV, NG, NG * NV, NG * NF, NT, NT * NV, 1, NV, NV,
                       NV, NU, NV * NV, 36, 36, NV};
    return s[i];
  }

  // local placement values of joint j
  static RTT_HD void local_val(const Model& m, int j, const T* q, T* Rl,
                               T* pl) {
    const T* XR = m.XR(j);
    const T* Xp = m.Xp(j);
    if (j == 0) {
      T Rq[9];
      quat_rot(q + 3, Rq);
      matmul3(XR, Rq, Rl);
      matvec3(XR, q, pl);
      for (int i = 0; i < 3; ++i) pl[i] += Xp[i];
      return;
    }
    const T* ax = m.axis(j);
    const T s = m_sin(q[j + 6]), c = m_cos(q[j + 6]), omc = T(1) - c;
    const T Rj[9] = {
        c + ax[0] * ax[0] * omc, -ax[2] * s + ax[0] * ax[1] * omc,
        ax[1] * s + ax[0] * ax[2] * omc,
        ax[2] * s + ax[1] * ax[0] * omc, c + ax[1] * ax[1] * omc,
        -ax[0] * s + ax[1] * ax[2] * omc,
        -ax[1] * s + ax[2] * ax[0] * omc, ax[0] * s + ax[2] * ax[1] * omc,
        c + ax[2] * ax[2] * omc};
    matmul3(XR, Rj, Rl);
    for (int i = 0; i < 3; ++i) pl[i] = Xp[i];
  }

  // ---- values ---------------------------------------------------------
  // net force of joint j (gravity, inertia, minus the contact forces it
  // carries) and I v, from its stored motion
  static RTT_HD void force_val(const Model& m, int j, const T* f, T* ws) {
    T* J = ws + O_J + JW * j;
    const T* grav = m.gravity();
    T at[6], mg[3], gl[3], Ia[6], x[6];
    for (int k = 0; k < 6; ++k) at[k] = J[J_A + k];
    for (int k = 0; k < 3; ++k) mg[k] = -grav[k];
    matTvec3(J + J_R, mg, gl);
    for (int k = 0; k < 3; ++k) at[k] = at[k] + gl[k];
    inertia_apply(m.mass(j), m.com(j), m.Io(j), at, Ia);
    inertia_apply(m.mass(j), m.com(j), m.Io(j), J + J_V, J + J_IV);
    force_cross(J + J_V, J + J_IV, x);
    for (int k = 0; k < 6; ++k) x[k] = Ia[k] + x[k];
    for (int c = 0; c < NC; ++c) {   // contact forces on this joint
      if (m.cpar(c) != j) continue;
      T fc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int k = 0; k < CT; ++k) fc[k] = f[CT * c + k];
      T fj[6];
      force_xfm(m.fR(c), m.fp(c), fc, fj);
      for (int k = 0; k < 6; ++k) x[k] = x[k] - fj[k];
    }
    for (int k = 0; k < 6; ++k) J[J_F + k] = x[k];
  }

  static RTT_HD void base_val(const Model& m, const T* q, const T* v,
                              const T* a, const T* f, T* ws) {
    T* J = ws + O_J;
    local_val(m, 0, q, J + J_RL, J + J_PL);
    for (int k = 0; k < 9; ++k) J[J_R + k] = J[J_RL + k];
    for (int k = 0; k < 3; ++k) J[J_P + k] = J[J_PL + k];
    T x[6];
    motion_cross(v, v, x);
    for (int k = 0; k < 6; ++k) {
      J[J_V + k] = v[k];
      J[J_A + k] = a[k] + x[k];
    }
    force_val(m, 0, f, ws);
  }

  static RTT_HD void chain_val(const Model& m, int ch, const T* q,
                               const T* v, const T* a, const T* f, T* ws) {
    const int first = m.ch_first(ch), len = m.ch_len(ch);
    for (int pos = 0; pos < len; ++pos) {
      const int j = first + pos;
      T* J = ws + O_J + JW * j;
      const T* P = ws + O_J + JW * (pos ? j - 1 : m.ch_parent(ch));
      const T* ax = m.axis(j);
      T* Rl = J + J_RL;
      T* pl = J + J_PL;
      local_val(m, j, q, Rl, pl);
      T vJ[3], x[6];
      for (int i = 0; i < 3; ++i) vJ[i] = ax[i] * v[j + 5];
      motion_xinv(Rl, pl, P + J_V, J + J_V);
      for (int k = 0; k < 3; ++k) J[J_V + 3 + k] = J[J_V + 3 + k] + vJ[k];
      motion_xinv(Rl, pl, P + J_A, J + J_A);
      const T mJ[6] = {T(0), T(0), T(0), vJ[0], vJ[1], vJ[2]};
      motion_cross(J + J_V, mJ, x);
      for (int k = 0; k < 6; ++k) {
        const T aJ = k < 3 ? T(0) : ax[k - 3] * a[j + 5];
        J[J_A + k] = J[J_A + k] + aJ + x[k];
      }
      matmul3(P + J_R, Rl, J + J_R);
      matvec3(P + J_R, pl, J + J_P);
      for (int k = 0; k < 3; ++k) J[J_P + k] = J[J_P + k] + P[J_P + k];
      force_val(m, j, f, ws);
    }
  }

  // F[0:6] += the forces the chains on joint j pass up to it
  static RTT_HD void gather_val(const Model& m, int j, const T* ws, T* F) {
    for (int ch = 0; ch < m.n_chains(); ++ch) {
      if (m.ch_parent(ch) != j) continue;
      const T* C = ws + O_J + JW * m.ch_first(ch);
      T X[6];
      force_xfm(C + J_RL, C + J_PL, C + J_F, X);
      for (int k = 0; k < 6; ++k) F[k] += X[k];
    }
  }

  // forces leaf to root along chain ch (its last joint first takes what
  // the chains on it pass up), and the chain's torques
  static RTT_HD void chain_back_val(const Model& m, int ch, T* ws,
                                    T* tau) {
    const int first = m.ch_first(ch), len = m.ch_len(ch);
    for (int pos = len - 1; pos >= 0; --pos) {
      const int j = first + pos;
      T* F = ws + O_J + JW * j + J_F;
      if (pos < len - 1) {
        const T* C = ws + O_J + JW * (j + 1);
        T X[6];
        force_xfm(C + J_RL, C + J_PL, C + J_F, X);
        for (int k = 0; k < 6; ++k) F[k] += X[k];
      } else {
        gather_val(m, j, ws, F);
      }
      const T* ax = m.axis(j);
      tau[j + 5] = ax[0] * F[3] + ax[1] * F[4] + ax[2] * F[5];
    }
  }

  static RTT_HD void base_back_val(const Model& m, T* ws, T* tau) {
    T* F = ws + O_J + J_F;
    gather_val(m, 0, ws, F);
    for (int k = 0; k < 6; ++k) tau[k] = F[k];
  }

  static RTT_HD void contact_val(const Model& m, int c, const T* const* in,
                                 T* const* out, T* ws) {
    const T* f = in[3];
    const T* fric = in[4];
    const T* pref = in[5];
    const T* Rref = in[6];
    const T* P = ws + O_J + JW * m.cpar(c);
    T* Cw = ws + O_C + CW * c;
    T* vf = Cw + C_VF;
    T* Rwc = Cw + C_RW;
    T af[6], pwc[3];
    motion_xinv(m.fR(c), m.fp(c), P + J_V, vf);
    motion_xinv(m.fR(c), m.fp(c), P + J_A, af);
    matmul3(P + J_R, m.fR(c), Rwc);
    matvec3(P + J_R, m.fp(c), pwc);
    for (int k = 0; k < 3; ++k) pwc[k] = pwc[k] + P[J_P + k];
    const T kv = m.kv(c), kp = m.kp(c);
    if constexpr (CT == kPoint) {
      T wxl[3], fW[3], row[3];
      cross3(vf + 3, vf, wxl);
      for (int k = 0; k < 3; ++k)
        out[4][3 * c + k] = af[k] + wxl[k] + kv * vf[k]
                            + kp * (pwc[k] - pref[3 * c + k]);
      matvec3(Rwc, f + 3 * c, fW);
      for (int r = 0; r < GC; ++r) {
        cone_point_row(fric[c], r, row);
        out[8][GC * c + r] = row[0] * fW[0] + row[1] * fW[1] + row[2] * fW[2];
      }
    } else {
      const T* Rr = Rref + 9 * c;
      T dpr[3], Rrel[9], prel[3], vl[3];
      for (int k = 0; k < 3; ++k) dpr[k] = pwc[k] - pref[3 * c + k];
      matTmul3(Rr, Rwc, Rrel);
      matTvec3(Rr, dpr, prel);
      T* L = Cw + C_LG;
      log6_val(Rrel, prel, L, vl);
      for (int k = 0; k < 6; ++k)
        out[4][6 * c + k] = af[k] + kv * vf[k]
                            + kp * (k < 3 ? vl[k] : L[LG_W + k - 3]);
      const T* rect = m.rect(c);
      T row[6];
      for (int r = 0; r < GC; ++r) {
        cone_surface_row(fric[c], rect[0], rect[1], r, row);
        T g = T(0);
        for (int k = 0; k < 6; ++k) g += row[k] * f[6 * c + k];
        out[8][GC * c + r] = g;
      }
    }
    for (int k = 0; k < 3; ++k) {
      out[11][3 * c + k] = pwc[k];
      ws[O_T + 3 * c + k] = pwc[k];
    }
  }

  static RTT_HD void com_val(const Model& m, T* const* out, T* ws) {
    T com[3] = {T(0), T(0), T(0)};
    for (int j = 0; j < NJ; ++j) {
      const T* J = ws + O_J + JW * j;
      T cj[3];
      matvec3(J + J_R, m.com(j), cj);
      for (int k = 0; k < 3; ++k) com[k] += m.mass(j) * (cj[k] + J[J_P + k]);
    }
    for (int k = 0; k < 3; ++k) {
      const T x = com[k] * (T(1) / m.total_mass());
      out[11][3 * NC + k] = x;
      ws[O_T + 3 * NC + k] = x;
    }
  }

  // dg/df of the cone rows (constant blocks), by all lanes
  static RTT_HD void dgdf_val(const Model& m, const T* fric, T* dgdf,
                              const T* ws, int lane, int nl) {
    for (int e = lane; e < NG * NF; e += nl) {
      const int r = e / NF, k = e % NF, c = r / GC, kk = k - CT * c;
      T x = T(0);
      if (kk >= 0 && kk < CT) {
        if constexpr (CT == kPoint) {
          const T* Rwc = ws + O_C + CW * c + C_RW;
          T row[3];
          cone_point_row(fric[c], r % GC, row);
          x = row[0] * Rwc[kk] + row[1] * Rwc[3 + kk] + row[2] * Rwc[6 + kk];
        } else {
          T row[6];
          cone_surface_row(fric[c], m.rect(c)[0], m.rect(c)[1], r % GC, row);
          x = row[kk];
        }
      }
      dgdf[e] = x;
    }
  }

  // ---- tangents of one column -------------------------------------------
  struct Tan {
    T R[9], p[3], v[6], a[6];
  };

  // the base's tangent in column (cls, k)
  static RTT_HD void base_tan(const T* ws, int cls, int k, Tan& t) {
    const T z = tan_seed(T(0));
    for (int i = 0; i < 9; ++i) t.R[i] = z;
    for (int i = 0; i < 3; ++i) t.p[i] = z;
    for (int i = 0; i < 6; ++i) t.v[i] = t.a[i] = z;
    if (k >= 6) return;
    if (cls == 0) base_seed(ws + O_J + J_RL, k, t.R, t.p);
    if (cls == 1) t.v[k] = tan_seed(T(1));
    if (cls == 2) t.a[k] = tan_seed(T(1));
  }

  // the net force tangent of joint j
  static RTT_HD void force_tan(const Model& m, int j, const T* ws, int cls,
                               const Tan& t, T* dF) {
    const T* J = ws + O_J + JW * j;
    T at[6];
    for (int k = 0; k < 6; ++k) at[k] = t.a[k];
    if (cls == 0) {
      const T* grav = m.gravity();
      T mg[3], gl[3];
      for (int k = 0; k < 3; ++k) mg[k] = -grav[k];
      matTvec3(t.R, mg, gl);
      for (int k = 0; k < 3; ++k) at[k] = at[k] + gl[k];
    }
    inertia_apply(m.mass(j), m.com(j), m.Io(j), at, dF);
    if (cls < 2) {
      T Idv[6], x[6], y[6];
      inertia_apply(m.mass(j), m.com(j), m.Io(j), t.v, Idv);
      force_cross(t.v, J + J_IV, x);
      force_cross(J + J_V, Idv, y);
      for (int k = 0; k < 6; ++k) dF[k] = dF[k] + (x[k] + y[k]);
    }
  }

  // joint j's tangent from its parent's (par) in column (cls, own); with
  // own, par is zero (a leg column starts at its joint) and is not read.
  // par may be t: each entry of par is read before t's is written.
  static RTT_HD void joint_tan(const Model& m, int j, int parent,
                               const T* ws, T qd, int cls, bool own,
                               const Tan& par, Tan& t) {
    const T z = tan_seed(T(0));
    const T* J = ws + O_J + JW * j;
    const T* P = ws + O_J + JW * parent;
    const T* Rl = J + J_RL;
    const T* pl = J + J_PL;
    const T* ax = m.axis(j);
    T dRl[9], x[6];
    const bool qown = own && cls == 0;
    if (qown) {
      r_hat(Rl, ax, dRl);
      for (int i = 0; i < 9; ++i) dRl[i] = tan_seed(dRl[i]);
    }
    if (qown) {
      matmul3(P + J_R, dRl, t.R);
      for (int i = 0; i < 3; ++i) t.p[i] = z;
    } else if (cls == 0) {
      T y[3];
      matvec3(par.R, pl, y);
      for (int i = 0; i < 3; ++i) t.p[i] = y[i] + par.p[i];
      matmul3(par.R, Rl, t.R);
    }
    const T mJ[6] = {T(0), T(0), T(0), ax[0] * qd, ax[1] * qd, ax[2] * qd};
    if (qown) {
      motion_xinv(dRl, pl, P + J_V, t.v);
      motion_xinv(dRl, pl, P + J_A, t.a);
    } else if (own) {
      for (int k = 0; k < 6; ++k) t.v[k] = t.a[k] = z;
      if (cls == 1)
        for (int k = 0; k < 3; ++k) t.v[3 + k] = tan_seed(ax[k]);
    } else {
      if (cls < 2) {
        motion_xinv(Rl, pl, par.v, t.v);
      } else {
        for (int k = 0; k < 6; ++k) t.v[k] = z;
      }
      motion_xinv(Rl, pl, par.a, t.a);
    }
    if (cls < 2) {
      motion_cross(t.v, mJ, x);
      for (int k = 0; k < 6; ++k) t.a[k] = t.a[k] + x[k];
      if (own && cls == 1) {
        const T sJ[6] = {T(0), T(0), T(0), tan_seed(ax[0]), tan_seed(ax[1]),
                         tan_seed(ax[2])};
        motion_cross(J + J_V, sJ, x);
        for (int k = 0; k < 6; ++k) t.a[k] = t.a[k] + x[k];
      }
    }
    if (own && cls == 2)
      for (int k = 0; k < 3; ++k) t.a[3 + k] = tan_seed(ax[k]);
  }

  // contact c's rows in column col (tangent t of its parent joint; all
  // zero when off), written to the outputs (and the cost's task rows)
  static RTT_HD void contact_tan(const Model& m, int c, const T* const* in,
                                 T* const* out, T* ws, int col, bool on,
                                 const Tan& t) {
    const int cls = col / NV, k0 = col % NV;
    const T* Cw = ws + O_C + CW * c;
    const T* vf = Cw + C_VF;
    const T z = tan_seed(T(0));
    T dC[CT], dg[GC], dp[3];
    for (int k = 0; k < CT; ++k) dC[k] = z;
    for (int r = 0; r < GC; ++r) dg[r] = z;
    for (int k = 0; k < 3; ++k) dp[k] = z;
    if (on) {
      const T* fR = m.fR(c);
      const T* fp = m.fp(c);
      T dvf[6], daf[6], dR[9];
      const T kv = m.kv(c), kp = m.kp(c);
      motion_xinv(fR, fp, t.a, daf);
      if (cls < 2) {
        motion_xinv(fR, fp, t.v, dvf);
      } else {
        for (int k = 0; k < 6; ++k) dvf[k] = z;
      }
      if (cls == 0) {
        matmul3(t.R, fR, dR);
        matvec3(t.R, fp, dp);
        for (int k = 0; k < 3; ++k) dp[k] = dp[k] + t.p[k];
      }
      if constexpr (CT == kPoint) {
        T a[3], b[3];
        cross3(dvf + 3, vf, a);
        cross3(vf + 3, dvf, b);
        for (int k = 0; k < 3; ++k)
          dC[k] = daf[k] + (a[k] + b[k]) + kv * dvf[k] + kp * dp[k];
        if (cls == 0) {
          T dfW[3], row[3];
          matvec3(dR, in[3] + 3 * c, dfW);
          for (int r = 0; r < GC; ++r) {
            cone_point_row(in[4][c], r, row);
            dg[r] = row[0] * dfW[0] + row[1] * dfW[1] + row[2] * dfW[2];
          }
        }
      } else {
        T dl[6] = {z, z, z, z, z, z};
        if (cls == 0) {
          const T* Rr = in[6] + 9 * c;
          T dRrel[9], dprel[3];
          matTmul3(Rr, dR, dRrel);
          matTvec3(Rr, dp, dprel);
          log6_tan(Cw + C_LG, dRrel, dprel, dl, dl + 3);
        }
        for (int k = 0; k < 6; ++k)
          dC[k] = daf[k] + kv * dvf[k] + kp * dl[k];
      }
    }
    for (int k = 0; k < CT; ++k) out[5 + cls][(CT * c + k) * NV + k0] = dC[k];
    if (cls == 0) {
      for (int r = 0; r < GC; ++r) out[9][(GC * c + r) * NV + k0] = dg[r];
      for (int k = 0; k < 3; ++k) {
        out[12][(3 * c + k) * NV + k0] = dp[k];
        if (WITH_COST) ws[O_JR + (NV + 3 + 3 * c + k) * NV + k0] = dp[k];
      }
    }
  }

  // lane's slot of component k of the force tangent of the joint at pos
  // of the chain open at level lev
  static RTT_HD int df(int lev, int pos, int k, int lane, int nl) {
    return O_DF + ((lev * MAXLEN + pos) * 6 + k) * nl + lane;
  }

  // lane's slot of entry i of the tangent of the last joint of the chain
  // open at level lev
  static RTT_HD int tn(int lev, int i, int lane, int nl) {
    return O_TN + (lev * TW + i) * nl + lane;
  }

  // Where a column acts: its owner chain oc (-1 for a base column) and the
  // position op of its joint there; the chains oc .. last it moves (oc and
  // the chains below it; every chain for a base column).
  struct Owner {
    int oc, op, last;
  };

  // Close the chains open at levels >= lev, the deepest first: each sums
  // its force tangents leaf to root (writing its joints' torque rows) and
  // passes the result to the chain above (its parent's slot) or, at level
  // 0, into acc, the base's. A chain the column neither moves nor lies
  // above is all zero.
  static RTT_HD void close_chains(const Model& m, T* ws, int cls, int k0,
                                  const Owner& o, int* open, int lev,
                                  T* acc, T* dtau, int lane, int nl) {
#pragma unroll
    for (int l = NLEV - 1; l >= 0; --l) {
      if (l < lev) break;
      const int ch = open[l];
      if (ch < 0) continue;
      open[l] = -1;
      const int first = m.ch_first(ch), len = m.ch_len(ch);
      const bool live = o.oc < 0 || (ch >= o.oc && ch <= o.last)
                        || (NLEV > 1 && o.oc > ch
                            && o.oc <= ch + m.ch_ndesc(ch));
      T Ft[6];
      for (int k = 0; k < 6; ++k) Ft[k] = ws[df(l, len - 1, k, lane, nl)];
#pragma unroll 1
      for (int pos = len - 1; pos >= 0; --pos) {
        const int j = first + pos;
        if (live && pos < len - 1) {
          T dF[6];
          for (int k = 0; k < 6; ++k) dF[k] = ws[df(l, pos, k, lane, nl)];
          pass_up(m, j + 1, ws, cls, ch == o.oc && o.op == pos + 1, dF, Ft);
        }
        const T* ax = m.axis(j);
        dtau[(j + 5) * NV + k0] =
            live ? ax[0] * Ft[3] + ax[1] * Ft[4] + ax[2] * Ft[5] : T(0);
      }
      if (!live) continue;
      const bool own = ch == o.oc && o.op == 0;
      if (l == 0) {
        pass_up(m, first, ws, cls, own, acc, Ft);
        for (int k = 0; k < 6; ++k) acc[k] = Ft[k];
      } else {   // into the last joint of the chain open one level up
        const int up = m.ch_len(open[l - 1]) - 1;
        T base[6];
        for (int k = 0; k < 6; ++k) base[k] = ws[df(l - 1, up, k, lane, nl)];
        pass_up(m, first, ws, cls, own, base, Ft);
        for (int k = 0; k < 6; ++k) ws[df(l - 1, up, k, lane, nl)] = Ft[k];
      }
    }
  }

  static RTT_HD void column(const Model& m, const T* const* in,
                            T* const* out, T* ws, int col, int lane,
                            int nl) {
    const int cls = col / NV, k0 = col % NV;
    const int nch = m.n_chains();
    Owner o;
    if (k0 < 6) {   // a base column
      o.oc = -1;
      o.op = 0;
      o.last = nch - 1;
    } else {        // joint k0 - 5's
      o.oc = m.joint_chain(k0 - 5);
      o.op = k0 - 5 - m.ch_first(o.oc);
      o.last = o.oc + m.ch_ndesc(o.oc);
    }
    T* dtau = out[1 + cls];
    const T z = tan_seed(T(0));
    Tan t;
    T acc[6], dcom[3] = {z, z, z};
    base_tan(ws, cls, k0, t);
    if (o.oc < 0) {   // a base column moves the base; a joint's does not
      force_tan(m, 0, ws, cls, t, acc);
      if (cls == 0) {
        T cj[3];
        matvec3(t.R, m.com(0), cj);
        for (int k = 0; k < 3; ++k) dcom[k] = m.mass(0) * (cj[k] + t.p[k]);
      }
    } else {
      for (int k = 0; k < 6; ++k) acc[k] = z;
    }
#pragma unroll 1
    for (int c = 0; c < NC; ++c)
      if (m.cpar(c) == 0) contact_tan(m, c, in, out, ws, col, o.oc < 0, t);
    int open[NLEV];
#pragma unroll
    for (int l = 0; l < NLEV; ++l) open[l] = -1;
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int lev = m.ch_level(ch), first = m.ch_first(ch);
      const int len = m.ch_len(ch);
      close_chains(m, ws, cls, k0, o, open, lev, acc, dtau, lane, nl);
      const bool moved = o.oc < 0 || (ch >= o.oc && ch <= o.last);
      if (moved && ch != o.oc) {   // start from the parent joint's tangent
        if (lev == 0) {
          base_tan(ws, cls, k0, t);
        } else {
          const int l = lev - 1;
          for (int e = 0; e < 9; ++e) t.R[e] = ws[tn(l, e, lane, nl)];
          for (int e = 0; e < 3; ++e) t.p[e] = ws[tn(l, 9 + e, lane, nl)];
          for (int e = 0; e < 6; ++e) {
            t.v[e] = ws[tn(l, 12 + e, lane, nl)];
            t.a[e] = ws[tn(l, 18 + e, lane, nl)];
          }
        }
      }
#pragma unroll 1
      for (int pos = 0; pos < len; ++pos) {
        const int j = first + pos;
        const bool on = moved && (ch != o.oc || pos >= o.op);
        T dF[6];
        if (on) {
          joint_tan(m, j, pos ? j - 1 : m.ch_parent(ch), ws, in[1][j + 5],
                    cls, ch == o.oc && pos == o.op, t, t);
          force_tan(m, j, ws, cls, t, dF);
          if (cls == 0) {
            T cj[3];
            matvec3(t.R, m.com(j), cj);
            for (int k = 0; k < 3; ++k)
              dcom[k] = dcom[k] + m.mass(j) * (cj[k] + t.p[k]);
          }
        } else {
          for (int k = 0; k < 6; ++k) dF[k] = z;
        }
        for (int k = 0; k < 6; ++k) ws[df(lev, pos, k, lane, nl)] = dF[k];
#pragma unroll 1
        for (int c = 0; c < NC; ++c)
          if (m.cpar(c) == j) contact_tan(m, c, in, out, ws, col, on, t);
      }
      if (NLEV > 1 && moved && m.ch_ndesc(ch) > 0 && lev < NLEV - 1) {
        for (int e = 0; e < 9; ++e) ws[tn(lev, e, lane, nl)] = t.R[e];
        for (int e = 0; e < 3; ++e) ws[tn(lev, 9 + e, lane, nl)] = t.p[e];
        for (int e = 0; e < 6; ++e) {
          ws[tn(lev, 12 + e, lane, nl)] = t.v[e];
          ws[tn(lev, 18 + e, lane, nl)] = t.a[e];
        }
      }
#pragma unroll
      for (int l = 0; l < NLEV; ++l)   // constant indices: registers
        if (l == lev) open[l] = ch;
    }
    close_chains(m, ws, cls, k0, o, open, 0, acc, dtau, lane, nl);
    for (int k = 0; k < 6; ++k) dtau[k * NV + k0] = acc[k];
    if (cls == 0) {
      for (int k = 0; k < 3; ++k) {
        const T x = dcom[k] * (T(1) / m.total_mass());
        out[12][(3 * NC + k) * NV + k0] = x;
        if (WITH_COST) ws[O_JR + (NV + 3 + 3 * NC + k) * NV + k0] = x;
      }
    }
  }

  // Ft <- base + X_j Ft (+ dX_j F_j in joint j's own dq column), the
  // force joint j passes to its parent added to the parent's own (base)
  static RTT_HD void pass_up(const Model& m, int j, const T* ws, int cls,
                             bool own, const T* base, T* Ft) {
    const T* J = ws + O_J + JW * j;
    T X[6];
    force_xfm(J + J_RL, J + J_PL, Ft, X);
    if (own && cls == 0) {
      T dRl[9], Y[6];
      r_hat(J + J_RL, m.axis(j), dRl);
      for (int i = 0; i < 9; ++i) dRl[i] = tan_seed(dRl[i]);
      force_xfm(dRl, J + J_PL, J + J_F, Y);
      for (int k = 0; k < 6; ++k) X[k] = X[k] + Y[k];
    }
    for (int k = 0; k < 6; ++k) Ft[k] = base[k] + X[k];
  }

  // ---- the cost fold ----------------------------------------------------
  // its Lie residuals' values, task t of 3
  static RTT_HD void cost_val(int task, const T* const* in, T* ws) {
    const T* q = in[0];
    const T* brq = in[I_COST + 4];
    const T* qr = in[I_COST + 11];
    const T* qn = in[I_COST + 13];
    T R1[9], R0[9], Rrel[9], dp[3], prel[3], vl[3];
    quat_rot(q + 3, R1);
    if (task == 0) {   // q (-) q_ref: base log6, then joint deltas
      quat_rot(qr + 3, R0);
      for (int k = 0; k < 9; ++k) {
        ws[O_RQ + k] = R1[k];
        ws[O_R0 + k] = R0[k];
      }
      matTmul3(R0, R1, Rrel);
      for (int k = 0; k < 3; ++k) dp[k] = q[k] - qr[k];
      matTvec3(R0, dp, prel);
      log6_val(Rrel, prel, ws + O_LQ, vl);
      T* rr = ws + O_RR;
      const T* wq = in[I_COST + 5];
      for (int k = 0; k < 3; ++k) {
        rr[k] = vl[k];
        rr[3 + k] = ws[O_LQ + LG_W + k];
      }
      for (int k = 6; k < NV; ++k) rr[k] = q[k + 1] - qr[k + 1];
      for (int r = 0; r < NV; ++r) ws[O_WR + r] = wq[r];
    } else if (task == 1) {   // base rotation log3(R_ref^T R_base)
      const T* wbr = in[I_COST + 10];
      T qb[4] = {brq[0], brq[1], brq[2], brq[3]};
      quat_rot(qb, R0);
      for (int k = 0; k < 9; ++k) ws[O_RB + k] = R0[k];
      matTmul3(R0, R1, Rrel);
      log3_val(Rrel, ws + O_LB);
      for (int k = 0; k < 3; ++k) {
        ws[O_RR + NV + k] = ws[O_LB + LG_W + k];
        ws[O_WR + NV + k] = wbr[k];
      }
    } else {   // state equation q_next (-) q
      quat_rot(qn + 3, R0);
      for (int k = 0; k < 9; ++k) ws[O_RN + k] = R0[k];
      for (int k = 0; k < 3; ++k) dp[k] = qn[k] - q[k];
      for (int k = 0; k < 3; ++k) ws[O_DP + k] = dp[k];
      matTmul3(R1, R0, Rrel);
      matTvec3(R1, dp, prel);
      log6_val(Rrel, prel, ws + O_LS, vl);
      for (int k = 0; k < 3; ++k) {
        ws[O_NU + k] = vl[k];
        ws[O_NU + 3 + k] = ws[O_LS + LG_W + k];
      }
    }
  }

  // its tangent columns: t < NV the residual rows' column t; NV + c the
  // state equation's column c (base tangents of q, then of q_next)
  static RTT_HD void cost_tan(int t, T* ws) {
    T dR[9], dp[3], dRrel[9], dprel[3], dv[3], dw[3];
    if (t < NV) {
      T* Jr = ws + O_JR;
      if (t < 6) {
        base_seed(ws + O_RQ, t, dR, dp);
        matTmul3(ws + O_R0, dR, dRrel);
        matTvec3(ws + O_R0, dp, dprel);
        log6_tan(ws + O_LQ, dRrel, dprel, dv, dw);
        matTmul3(ws + O_RB, dR, dRrel);
        T db[3];
        log3_tan(ws + O_LB, dRrel, db);
        for (int k = 0; k < 3; ++k) {
          Jr[k * NV + t] = dv[k];
          Jr[(3 + k) * NV + t] = dw[k];
          Jr[(NV + k) * NV + t] = db[k];
        }
      } else {
        for (int k = 0; k < 6; ++k) Jr[k * NV + t] = tan_seed(T(0));
        for (int k = 0; k < 3; ++k) Jr[(NV + k) * NV + t] = tan_seed(T(0));
      }
      for (int r = 6; r < NV; ++r)
        Jr[r * NV + t] = tan_seed(r == t ? T(1) : T(0));
      return;
    }
    const int c = t - NV;
    const T* R0 = ws + O_RQ;
    const T* R1 = ws + O_RN;
    if (c < 6) {   // perturb q: Rrel = R0^T R1, prel = R0^T (p1 - p0)
      base_seed(R0, c, dR, dp);
      T a[3], b[3];
      matTmul3(dR, R1, dRrel);
      matTvec3(dR, ws + O_DP, a);
      matTvec3(R0, dp, b);
      for (int k = 0; k < 3; ++k) dprel[k] = a[k] - b[k];
    } else {       // perturb q_next
      base_seed(R1, c - 6, dR, dp);
      matTmul3(R0, dR, dRrel);
      matTvec3(R0, dp, dprel);
    }
    log6_tan(ws + O_LS, dRrel, dprel, dv, dw);
    T* Js = ws + O_JS;
    for (int k = 0; k < 3; ++k) {
      Js[k * 12 + c] = dv[k];
      Js[(3 + k) * 12 + c] = dw[k];
    }
  }

  static RTT_HD void cost_out(const T* const* in, T* const* out, T* ws,
                              int lane, int nl) {
    const T* q = in[0];
    const T* v = in[1];
    const T* a = in[2];
    const T* const* ci = in + I_COST;
    const T* u = ci[0];
    const T dt = ci[1][0];
    const T* wv = ci[6];
    const T* wa = ci[7];
    const T* wu = ci[8];
    const T* vr = ci[12];
    const T* qn = ci[13];
    const T* Jr = ws + O_JR;
    const T* rr = ws + O_RR;
    const T* wr = ws + O_WR;
    const T* Js = ws + O_JS;
    const T* nu = ws + O_NU;
    T* A6 = ws + O_A6;
    for (int e = lane; e < 36; e += nl) A6[e] = Js[(e / 6) * 12 + 6 + e % 6];
    // Gauss-Newton blocks of the stack (all lanes, disjoint entries)
    for (int e = lane; e < NV * NV; e += nl) {
      const int i = e / NV, j = e % NV;
      T acc = T(0);
      for (int r = 0; r < NR; ++r) acc += wr[r] * Jr[r * NV + i] * Jr[r * NV + j];
      out[18][e] = dt * acc;
    }
    for (int i = lane; i < NV; i += nl) {
      T acc = T(0);
      for (int r = 0; r < NR; ++r) acc += Jr[r * NV + i] * (wr[r] * rr[r]);
      out[14][i] = dt * acc;
      out[15][i] = dt * wv[i] * (v[i] - vr[i]);
      out[16][i] = dt * wa[i] * a[i];
    }
    for (int i = lane; i < NU; i += nl) out[17][i] = dt * wu[i] * u[i];
    if (lane == 0) {
      T c = T(0);
      for (int r = 0; r < NR; ++r) c += wr[r] * rr[r] * rr[r];
      for (int i = 0; i < NV; ++i)
        c += wv[i] * (v[i] - vr[i]) * (v[i] - vr[i]) + wa[i] * a[i] * a[i];
      for (int i = 0; i < NU; ++i) c += wu[i] * u[i] * u[i];
      out[13][0] = T(0.5) * dt * c;
    }
    warp_sync();
    gauss_jordan_warp<T, 6>(A6, 6, lane, nl);
    for (int e = lane; e < 36; e += nl) {
      const int i = e / 6, j = e % 6;
      T acc = T(0);
      for (int k = 0; k < 6; ++k) acc += A6[i * 6 + k] * Js[k * 12 + j];
      out[19][e] = -acc;
      out[20][e] = A6[e];
    }
    for (int i = lane; i < NV; i += nl) {
      T x;
      if (i < 6) {
        x = T(0);
        for (int k = 0; k < 6; ++k)
          x += A6[i * 6 + k] * (nu[k] - dt * v[k]);
        x = -x;
      } else {
        x = q[i + 1] + dt * v[i] - qn[i + 1];
      }
      out[21][i] = x;
    }
  }

  // ---- the stage --------------------------------------------------------
  // Lane `lane` of a team of `nl` on stage s; ws is the stage's workspace.
  static RTT_HD void run(const T* consts, const int* topo,
                         const T* const* in_all, T* const* out_all,
                         long long s, T* ws, int lane, int nl) {
    const Model m{consts, topo};
    const T* in[21];
    T* out[22];
    for (int i = 0; i < N_IN; ++i) in[i] = in_all[i] + s * in_size(i);
    for (int i = 0; i < N_OUT; ++i) out[i] = out_all[i] + s * out_size(i);
    const T* q = in[0];
    const T* v = in[1];
    const T* a = in[2];
    const T* f = in[3];
    constexpr int NC0 = WITH_COST ? 4 : 1;
    // values: the base (and the cost's Lie residuals), then the chains
    for (int t = lane; t < NC0; t += nl) {
      if (t == 0) base_val(m, q, v, a, f, ws);
      else cost_val(t - 1, in, ws);
    }
    warp_sync();
    const int nch = m.n_chains(), nlev = m.n_chain_levels();
    for (int l = 0; l < nlev; ++l) {   // chains root to leaf, level by level
      for (int ch = lane; ch < nch; ch += nl)
        if (m.ch_level(ch) == l) chain_val(m, ch, q, v, a, f, ws);
      warp_sync();
    }
    for (int l = nlev - 1; l > 0; --l) {   // forces leaf to root
      for (int ch = lane; ch < nch; ch += nl)
        if (m.ch_level(ch) == l) chain_back_val(m, ch, ws, out[0]);
      warp_sync();
    }
    for (int t = lane; t < nch + NC + 1; t += nl) {
      if (t < nch) {
        if (m.ch_level(t) == 0) chain_back_val(m, t, ws, out[0]);
      } else if (t < nch + NC) {
        contact_val(m, t - nch, in, out, ws);
      } else {
        com_val(m, out, ws);
      }
    }
    warp_sync();
    if (lane == 0) base_back_val(m, ws, out[0]);
    dgdf_val(m, in[4], out[10], ws, lane, nl);
    if constexpr (WITH_COST) {
      const T* tref = in[I_COST + 2];
      const T* tact = in[I_COST + 3];
      const T* wtask = in[I_COST + 9];
      for (int k = lane; k < NT; k += nl) {
        ws[O_RR + NV + 3 + k] = ws[O_T + k] - tref[k];
        ws[O_WR + NV + 3 + k] = wtask[k] * tact[k];
      }
    }
    // tangents, a column per lane
    for (int col = lane; col < NCOL; col += nl)
      column(m, in, out, ws, col, lane, nl);
    if constexpr (WITH_COST) {
      for (int t = lane; t < NV + 12; t += nl) cost_tan(t, ws);
      warp_sync();
      cost_out(in, out, ws, lane, nl);
    }
  }
};

}  // namespace rtt

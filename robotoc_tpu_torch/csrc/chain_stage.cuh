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
// Design: every tangent column is owned by one "thread" (tid, tid + nt,
// ...) and propagated in forward mode with a value/tangent pair (Dual)
// through the same formulas the values take, so a value and its
// derivative never come from two codes. Each column recomputes the values
// it needs along with its tangent; the owner of column 0 stores them in
// the workspace, where the other columns read the parents' values. Tangent
// state is private to its column and lives in the workspace at
// [joint][component][column], so neighbouring threads touch neighbouring
// words. Structural zeros are not stored: a placement's tangents are kept
// for the NV q-columns only, a velocity's for the dq/dv columns only. The
// arithmetic still runs on them: a dv/da column multiplies zero placement
// tangents through. (csrc/chain_flops.cpp counts what the function needs,
// values once and zeros skipped, for the roofline bound.) Joints are
// processed level by level (the static levels of robot.chain_levels) with
// a block barrier between levels: forward from the root, backward for the RNEA
// force accumulation. Local joint placements are recomputed where needed
// with closed-form seeds: dR = R hat(e), dp = R e for the free base (the
// right perturbation of robot.integrate), dR = R hat(axis) for a revolute
// joint. The small-angle series of so3 log / se3 log's left-Jacobian
// inverse follow pallas_chain.py:266-347 (with the native acos, and
// sin theta taken as sqrt((1 - c)(1 + c)) so that float32 keeps its
// digits near the identity).
//
// On the host the same code runs with tid = 0, nt = 1 (csrc/host_shim.cpp).
#pragma once

#include <math.h>

#include "stage_algebra.cuh"

namespace rtt {

RTT_HD float m_sqrt(float x) { return sqrtf(x); }
RTT_HD double m_sqrt(double x) { return sqrt(x); }
RTT_HD float m_sin(float x) { return sinf(x); }
RTT_HD double m_sin(double x) { return sin(x); }
RTT_HD float m_cos(float x) { return cosf(x); }
RTT_HD double m_cos(double x) { return cos(x); }
RTT_HD float m_acos(float x) { return acosf(x); }
RTT_HD double m_acos(double x) { return acos(x); }

template <typename T>
RTT_HD T m_clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Forward-mode dual number: a value and one tangent.
template <typename T>
struct Dual {
  T v, d;
  RTT_HD Dual() : v(T(0)), d(T(0)) {}
  RTT_HD Dual(T v_, T d_ = T(0)) : v(v_), d(d_) {}
  friend RTT_HD Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
  friend RTT_HD Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
  friend RTT_HD Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
  friend RTT_HD Dual operator*(Dual a, Dual b) {
    return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
  }
};

// f(x) given f(x.v) and f'(x.v) (closed-form derivative from the caller)
template <typename T>
RTT_HD Dual<T> apply(Dual<T> x, T f, T fp) {
  return Dual<T>(f, fp * x.d);
}

// ---- 3-vectors, row-major 3x3 matrices, 6D spatial algebra -------------
template <typename A, typename B, typename O>
RTT_HD void cross3(const A* a, const B* b, O* o) {
  O r0 = a[1] * b[2] - a[2] * b[1];
  O r1 = a[2] * b[0] - a[0] * b[2];
  O r2 = a[0] * b[1] - a[1] * b[0];
  o[0] = r0; o[1] = r1; o[2] = r2;
}

template <typename A, typename B, typename O>
RTT_HD void matvec3(const A* R, const B* x, O* o) {
  O r[3];
  for (int i = 0; i < 3; ++i)
    r[i] = R[3 * i] * x[0] + R[3 * i + 1] * x[1] + R[3 * i + 2] * x[2];
  for (int i = 0; i < 3; ++i) o[i] = r[i];
}

template <typename A, typename B, typename O>
RTT_HD void matTvec3(const A* R, const B* x, O* o) {
  O r[3];
  for (int i = 0; i < 3; ++i)
    r[i] = R[i] * x[0] + R[3 + i] * x[1] + R[6 + i] * x[2];
  for (int i = 0; i < 3; ++i) o[i] = r[i];
}

template <typename A, typename B, typename O>
RTT_HD void matmul3(const A* X, const B* Y, O* o) {
  O r[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r[3 * i + j] = X[3 * i] * Y[j] + X[3 * i + 1] * Y[3 + j]
                     + X[3 * i + 2] * Y[6 + j];
  for (int i = 0; i < 9; ++i) o[i] = r[i];
}

template <typename A, typename B, typename O>
RTT_HD void matTmul3(const A* X, const B* Y, O* o) {   // X^T Y
  O r[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r[3 * i + j] = X[i] * Y[j] + X[3 + i] * Y[3 + j] + X[6 + i] * Y[6 + j];
  for (int i = 0; i < 9; ++i) o[i] = r[i];
}

// motion vector parent -> child frame (child placed at (R, p))
template <typename S>
RTT_HD void motion_xinv(const S* R, const S* p, const S* m, S* o) {
  S pw[3], l[3];
  cross3(p, m + 3, pw);
  for (int i = 0; i < 3; ++i) l[i] = m[i] - pw[i];
  S w[3] = {m[3], m[4], m[5]};
  matTvec3(R, l, o);
  matTvec3(R, w, o + 3);
}

template <typename S>
RTT_HD void motion_cross(const S* v, const S* m, S* o) {
  S a[3], b[3], c[3];
  cross3(v + 3, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m + 3, c);
  for (int i = 0; i < 3; ++i) { o[i] = a[i] + b[i]; o[3 + i] = c[i]; }
}

template <typename S>
RTT_HD void force_cross(const S* v, const S* f, S* o) {
  S a[3], b[3], c[3];
  cross3(v + 3, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f, c);
  for (int i = 0; i < 3; ++i) { o[i] = a[i]; o[3 + i] = b[i] + c[i]; }
}

// force child -> parent frame
template <typename S>
RTT_HD void force_xfm(const S* R, const S* p, const S* f, S* o) {
  S lf[3], wf[3], pl[3];
  matvec3(R, f, lf);
  matvec3(R, f + 3, wf);
  cross3(p, lf, pl);
  for (int i = 0; i < 3; ++i) { o[i] = lf[i]; o[3 + i] = wf[i] + pl[i]; }
}

// spatial inertia (mass m, com c, rotational inertia Io about the origin)
template <typename T, typename S>
RTT_HD void inertia_apply(T m, const T* c, const T* Io, const S* v, S* o) {
  T mc[3] = {m * c[0], m * c[1], m * c[2]};
  S a[3], b[3], n[3];
  cross3(mc, v + 3, a);
  cross3(mc, v, b);
  matvec3(Io, v + 3, n);
  for (int i = 0; i < 3; ++i) {
    o[i] = S(m) * v[i] - a[i];
    o[3 + i] = n[i] + b[i];
  }
}

template <typename T>
RTT_HD void quat_rot(const T* q, T* R) {   // (x, y, z, w) -> R
  const T x = q[0], y = q[1], z = q[2], w = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = T(1) - T(2) * (yy + zz); R[1] = T(2) * (xy - wz);
  R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz); R[4] = T(1) - T(2) * (xx + zz);
  R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy); R[7] = T(2) * (yz + wx);
  R[8] = T(1) - T(2) * (xx + yy);
}

// R hat(e_i) for the unit vector e_i
template <typename T>
RTT_HD void r_hat_e(const T* R, int i, T* o) {
  T e[3] = {T(0), T(0), T(0)};
  e[i] = T(1);
  for (int r = 0; r < 3; ++r) {
    const T* row = R + 3 * r;
    T h[3];
    cross3(e, row, h);      // row hat(e) = row x e = -(e x row)
    o[3 * r] = -h[0]; o[3 * r + 1] = -h[1]; o[3 * r + 2] = -h[2];
  }
}

// pose (R, p) of a floating-base configuration block q[0:7] as duals
// seeded with the right perturbation along base tangent k (0-2 linear,
// 3-5 angular; any other k: no tangent)
template <typename T>
RTT_HD void base_pose(const T* q, int k, Dual<T>* R, Dual<T>* p) {
  T Rv[9], dR[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  quat_rot(q + 3, Rv);
  T dp[3] = {T(0), T(0), T(0)};
  if (k >= 0 && k < 3) {
    for (int r = 0; r < 3; ++r) dp[r] = Rv[3 * r + k];
  } else if (k >= 3 && k < 6) {
    r_hat_e(Rv, k - 3, dR);
  }
  for (int i = 0; i < 9; ++i) R[i] = Dual<T>(Rv[i], dR[i]);
  for (int i = 0; i < 3; ++i) p[i] = Dual<T>(q[i], dp[i]);
}

// so3 log of a rotation dual: theta / (2 sin theta) vee(R - R^T)
template <typename T>
RTT_HD void theta_s(T tr, T& theta, T& s, T& c) {
  c = m_clip(T(0.5) * (tr - T(1)), T(-1) + T(1e-7), T(1) - T(1e-12));
  theta = m_acos(c);
  const T s2 = (T(1) - c) * (T(1) + c);
  s = m_sqrt(s2 > T(1e-24) ? s2 : T(1e-24));
}

template <typename T>
RTT_HD void so3_log(const Dual<T>* R, Dual<T>* w) {
  const Dual<T> tr = R[0] + R[4] + R[8];
  T theta, s, c;
  theta_s(tr.v, theta, s, c);
  const T t2 = theta * theta;
  const bool small = t2 < T(1e-6);
  const T val = small ? T(0.5) + t2 / T(12) + T(7) * t2 * t2 / T(720)
                      : theta / (T(2) * s);
  const T grad = small ? -(T(1) / T(12) + T(7) * t2 / T(360))
                       : (theta * c - s) / (T(4) * s * s * s);
  const Dual<T> scale = apply(tr, val, grad);
  w[0] = scale * (R[7] - R[5]);
  w[1] = scale * (R[2] - R[6]);
  w[2] = scale * (R[3] - R[1]);
}

// V^{-1}(w) p = p - hat(w) p / 2 + k2 hat(w)^2 p, the linear half of se3 log
template <typename T>
RTT_HD void se3_log_linear(const Dual<T>* w, const Dual<T>* p, Dual<T>* o) {
  const Dual<T> t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const T t2c = t2.v > T(0) ? t2.v : T(0);
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
  const Dual<T> k2 = apply(t2, val, grad);
  Dual<T> wxp[3], wxwxp[3];
  cross3(w, p, wxp);
  cross3(w, wxp, wxwxp);
  for (int i = 0; i < 3; ++i)
    o[i] = p[i] - Dual<T>(T(0.5)) * wxp[i] + k2 * wxwxp[i];
}

// ---- model tables (ops/chain.model_tables) ------------------------------
// consts: per joint [XR 9, Xp 3, axis 3, mass, com 3, Io 9], gravity 3,
// per contact [fR 9, fp 3, kp, kv, rect X, rect Y], total mass.
// topo: parents, jtypes, q_offs, v_offs (nj each), contact parents (nc),
// n_levels, level starts (n_levels + 1), joints in level order.
template <typename T, int NJ, int NC>
struct ChainModel {
  const T* c;
  const int* t;
  static constexpr int JW = 28, CW = 16;
  RTT_HD const T* XR(int j) const { return c + JW * j; }
  RTT_HD const T* Xp(int j) const { return c + JW * j + 9; }
  RTT_HD const T* axis(int j) const { return c + JW * j + 12; }
  RTT_HD T mass(int j) const { return c[JW * j + 15]; }
  RTT_HD const T* com(int j) const { return c + JW * j + 16; }
  RTT_HD const T* Io(int j) const { return c + JW * j + 19; }
  RTT_HD const T* gravity() const { return c + JW * NJ; }
  RTT_HD const T* fR(int k) const { return c + JW * NJ + 3 + CW * k; }
  RTT_HD const T* fp(int k) const { return c + JW * NJ + 3 + CW * k + 9; }
  RTT_HD T kp(int k) const { return c[JW * NJ + 3 + CW * k + 12]; }
  RTT_HD T kv(int k) const { return c[JW * NJ + 3 + CW * k + 13]; }
  RTT_HD const T* rect(int k) const { return c + JW * NJ + 3 + CW * k + 14; }
  RTT_HD T total_mass() const { return c[JW * NJ + 3 + CW * NC]; }
  RTT_HD int parent(int j) const { return t[j]; }
  RTT_HD int jtype(int j) const { return t[NJ + j]; }
  RTT_HD int qoff(int j) const { return t[2 * NJ + j]; }
  RTT_HD int voff(int j) const { return t[3 * NJ + j]; }
  RTT_HD int cpar(int k) const { return t[4 * NJ + k]; }
  RTT_HD int n_levels() const { return t[4 * NJ + NC]; }
  RTT_HD int level_start(int l) const { return t[4 * NJ + NC + 1 + l]; }
  RTT_HD int level_joint(int i) const {
    return t[4 * NJ + NC + 2 + n_levels() + i];
  }
};

constexpr int kFree = 0, kRevolute = 1;   // models/urdf.py joint types
constexpr int kPoint = 3, kSurface = 6;   // models/contacts.py types

template <typename T, int NV, int NJ, int NC, bool WITH_COST, int CT>
struct ChainStage {
  static_assert(CT == kPoint || CT == kSurface, "contact type");
  using D = Dual<T>;
  using Model = ChainModel<T, NJ, NC>;
  static constexpr int NQ = NV + 1, NU = NV - 6, NCOL = 3 * NV;
  static constexpr int GC = CT == kPoint ? 5 : 17;   // cone rows a contact
  static constexpr int NF = CT * NC, NG = GC * NC, NT = 3 * NC + 3;
  static constexpr int NR = NV + 3 + NT;   // cost residual rows
  // inputs: q, v, a, f, fric, p_ref, R_ref, then the cost fold's
  static constexpr int I_COST = 7;
  static constexpr int N_IN = WITH_COST ? I_COST + 14 : I_COST;
  static constexpr int N_OUT = WITH_COST ? 22 : 13;
  // workspace layout (scalars)
  static constexpr int O_VAL = 0;                       // NJ x 24 values
  static constexpr int O_TP = O_VAL + NJ * 24;          // NJ x 12 x NV
  static constexpr int O_TM = O_TP + NJ * 12 * NV;      // NJ x 12 x NCOL
  static constexpr int O_FV = O_TM + NJ * 12 * NCOL;    // NJ x 6
  static constexpr int O_JR = O_FV + NJ * 6;            // NR x NV
  static constexpr int O_RR = O_JR + NR * NV;           // NR residuals
  static constexpr int O_WR = O_RR + NR;                // NR weights
  static constexpr int O_JS = O_WR + NR;                // 6 x 12
  static constexpr int O_NU = O_JS + 72;                // 6
  static constexpr int O_A6 = O_NU + 6;                 // 6 x 6
  static constexpr int WS = WITH_COST ? O_A6 + 36 : O_JR;

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
    const int jt = m.jtype(j), qo = m.qoff(j);
    const T* XR = m.XR(j);
    const T* Xp = m.Xp(j);
    const T* ax = m.axis(j);
    if (jt == kFree) {
      T Rq[9];
      quat_rot(q + qo + 3, Rq);
      matmul3(XR, Rq, Rl);
      matvec3(XR, q + qo, pl);
      for (int i = 0; i < 3; ++i) pl[i] += Xp[i];
    } else if (jt == kRevolute) {
      const T s = m_sin(q[qo]), c = m_cos(q[qo]), omc = T(1) - c;
      const T Rj[9] = {
          c + ax[0] * ax[0] * omc, -ax[2] * s + ax[0] * ax[1] * omc,
          ax[1] * s + ax[0] * ax[2] * omc,
          ax[2] * s + ax[1] * ax[0] * omc, c + ax[1] * ax[1] * omc,
          -ax[0] * s + ax[1] * ax[2] * omc,
          -ax[1] * s + ax[2] * ax[0] * omc, ax[0] * s + ax[2] * ax[1] * omc,
          c + ax[2] * ax[2] * omc};
      matmul3(XR, Rj, Rl);
      for (int i = 0; i < 3; ++i) pl[i] = Xp[i];
    } else {
      for (int i = 0; i < 9; ++i) Rl[i] = XR[i];
      for (int i = 0; i < 3; ++i) pl[i] = Xp[i] + ax[i] * q[qo];
    }
  }

  // local placement of joint j as duals for tangent column col
  static RTT_HD void local_dual(const Model& m, int j, const T* q, int col,
                                D* Rl, D* pl) {
    T R[9], p[3], dR[9], dp[3];
    local_val(m, j, q, R, p);
    for (int i = 0; i < 9; ++i) dR[i] = T(0);
    for (int i = 0; i < 3; ++i) dp[i] = T(0);
    const int jt = m.jtype(j), k = col - m.voff(j);
    if (col < NV) {
      if (jt == kFree) {
        if (k >= 0 && k < 3) {
          for (int r = 0; r < 3; ++r) dp[r] = R[3 * r + k];
        } else if (k >= 3 && k < 6) {
          r_hat_e(R, k - 3, dR);
        }
      } else if (k == 0) {
        const T* ax = m.axis(j);
        if (jt == kRevolute) {
          // R hat(axis) = sum_i axis_i R hat(e_i)
          for (int i = 0; i < 3; ++i) {
            T h[9];
            r_hat_e(R, i, h);
            for (int e = 0; e < 9; ++e) dR[e] += ax[i] * h[e];
          }
        } else {
          for (int i = 0; i < 3; ++i) dp[i] = ax[i];
        }
      }
    }
    for (int i = 0; i < 9; ++i) Rl[i] = D(R[i], dR[i]);
    for (int i = 0; i < 3; ++i) pl[i] = D(p[i], dp[i]);
  }

  // joint motion S_j x for x = v (cls 1) or a (cls 2), tangent column col
  static RTT_HD void joint_motion(const Model& m, int j, const T* x, int cls,
                                  int col, D* o) {
    const int jt = m.jtype(j), vo = m.voff(j);
    const int k = col - cls * NV - vo;     // this column's seed offset
    if (jt == kFree) {
      for (int i = 0; i < 6; ++i) o[i] = D(x[vo + i], k == i ? T(1) : T(0));
      return;
    }
    const T* ax = m.axis(j);
    const T seed = k == 0 ? T(1) : T(0);
    const int lin = jt == kRevolute ? 3 : 0;
    for (int i = 0; i < 6; ++i) o[i] = D(T(0));
    for (int i = 0; i < 3; ++i) o[lin + i] = D(ax[i] * x[vo], ax[i] * seed);
  }

  // ---- workspace access (values shared, tangents per column) ----------
  struct Work {
    T* ws;
    int col;
    RTT_HD D place(int j, int k) const {   // k < 12: Rw 0-8, pw 9-11
      return D(ws[O_VAL + 24 * j + k],
               col < NV ? ws[O_TP + (12 * j + k) * NV + col] : T(0));
    }
    RTT_HD D motion(int j, int k) const {  // k < 12: v 0-5, a 6-11
      const bool zero = k < 6 && col >= 2 * NV;
      return D(ws[O_VAL + 24 * j + 12 + k],
               zero ? T(0) : ws[O_TM + (12 * j + k) * NCOL + col]);
    }
    RTT_HD void set_place(int j, int k, D x) const {
      if (col == 0) ws[O_VAL + 24 * j + k] = x.v;
      if (col < NV) ws[O_TP + (12 * j + k) * NV + col] = x.d;
    }
    RTT_HD void set_motion(int j, int k, D x) const {
      if (col == 0) ws[O_VAL + 24 * j + 12 + k] = x.v;
      if (!(k < 6 && col >= 2 * NV))
        ws[O_TM + (12 * j + k) * NCOL + col] = x.d;
    }
    RTT_HD T& force_tan(int j, int k) const {   // reuses the a-slot
      return ws[O_TM + (12 * j + 6 + k) * NCOL + col];
    }
  };

  // write a value row (column 0's owner) and its tangent column
  static RTT_HD void emit(const D& x, int row, int col, T* val, T* dq,
                          T* dv, T* da) {
    if (col == 0) val[row] = x.v;
    const int cls = col / NV, c = col % NV;
    T* dst = cls == 0 ? dq : (cls == 1 ? dv : da);
    if (dst) dst[row * NV + c] = x.d;
  }

  static RTT_HD void run(const T* consts, const int* topo,
                         const T* const* in_all, T* const* out_all,
                         long long s, T* ws, int tid, int nt) {
    const Model m{consts, topo};
    const T* in[21];
    T* out[22];
    for (int i = 0; i < N_IN; ++i) in[i] = in_all[i] + s * in_size(i);
    for (int i = 0; i < N_OUT; ++i) out[i] = out_all[i] + s * out_size(i);
    const T* q = in[0];
    const T* v = in[1];
    const T* a = in[2];
    const T* f = in[3];
    const int nlev = m.n_levels();

    // ---- forward sweep, level by level --------------------------------
    for (int l = 0; l < nlev; ++l) {
      for (int col = tid; col < NCOL; col += nt) {
        const Work w{ws, col};
        for (int i = m.level_start(l); i < m.level_start(l + 1); ++i) {
          const int j = m.level_joint(i), p = m.parent(j);
          D Rl[9], pl[3], vJ[6], aJ[6], vi[6], ai[6], Rw[9], pw[3], x[6];
          local_dual(m, j, q, col, Rl, pl);
          joint_motion(m, j, v, 1, col, vJ);
          joint_motion(m, j, a, 2, col, aJ);
          if (p < 0) {
            for (int k = 0; k < 6; ++k) vi[k] = vJ[k];
            motion_cross(vi, vJ, x);
            for (int k = 0; k < 6; ++k) ai[k] = aJ[k] + x[k];
            for (int k = 0; k < 9; ++k) Rw[k] = Rl[k];
            for (int k = 0; k < 3; ++k) pw[k] = pl[k];
          } else {
            D Rp[9], pp[3], vp[6], ap[6];
            for (int k = 0; k < 9; ++k) Rp[k] = w.place(p, k);
            for (int k = 0; k < 3; ++k) pp[k] = w.place(p, 9 + k);
            for (int k = 0; k < 6; ++k) {
              vp[k] = w.motion(p, k);
              ap[k] = w.motion(p, 6 + k);
            }
            motion_xinv(Rl, pl, vp, vi);
            for (int k = 0; k < 6; ++k) vi[k] = vi[k] + vJ[k];
            motion_xinv(Rl, pl, ap, ai);
            motion_cross(vi, vJ, x);
            for (int k = 0; k < 6; ++k) ai[k] = ai[k] + aJ[k] + x[k];
            matmul3(Rp, Rl, Rw);
            matvec3(Rp, pl, pw);
            for (int k = 0; k < 3; ++k) pw[k] = pw[k] + pp[k];
          }
          for (int k = 0; k < 9; ++k) w.set_place(j, k, Rw[k]);
          for (int k = 0; k < 3; ++k) w.set_place(j, 9 + k, pw[k]);
          for (int k = 0; k < 6; ++k) {
            w.set_motion(j, k, vi[k]);
            w.set_motion(j, 6 + k, ai[k]);
          }
        }
      }
      block_sync();
    }

    // ---- contacts: Baumgarte residual, cone rows, task rows -----------
    const T* fric = in[4];
    const T* pref = in[5];
    const T* Rref = in[6];
    T* Jr = ws + O_JR;
    for (int col = tid; col < NCOL; col += nt) {
      const Work w{ws, col};
      D com[3];
      for (int c = 0; c < NC; ++c) {
        const int p = m.cpar(c);
        D Rp[9], pp[3], vp[6], ap[6], vf[6], af[6], Rwc[9], pwc[3];
        for (int k = 0; k < 9; ++k) Rp[k] = w.place(p, k);
        for (int k = 0; k < 3; ++k) pp[k] = w.place(p, 9 + k);
        for (int k = 0; k < 6; ++k) {
          vp[k] = w.motion(p, k);
          ap[k] = w.motion(p, 6 + k);
        }
        D fRd[9], fpd[3];
        for (int k = 0; k < 9; ++k) fRd[k] = D(m.fR(c)[k]);
        for (int k = 0; k < 3; ++k) fpd[k] = D(m.fp(c)[k]);
        motion_xinv(fRd, fpd, vp, vf);
        motion_xinv(fRd, fpd, ap, af);
        matmul3(Rp, fRd, Rwc);
        matvec3(Rp, fpd, pwc);
        for (int k = 0; k < 3; ++k) pwc[k] = pwc[k] + pp[k];
        const D kv(m.kv(c)), kp(m.kp(c));
        if constexpr (CT == kPoint) {
          D wxl[3];
          cross3(vf + 3, vf, wxl);
          for (int k = 0; k < 3; ++k) {
            const D C = af[k] + wxl[k] + kv * vf[k]
                        + kp * (pwc[k] - D(pref[3 * c + k]));
            emit(C, 3 * c + k, col, out[4], out[5], out[6], out[7]);
          }
          // cone rows C_m (R_w f_local)
          const T cc = fric[c] / m_sqrt(T(2));
          const T Cm[15] = {T(0), T(0), T(-1), T(1), T(0), -cc, T(-1), T(0),
                            -cc, T(0), T(1), -cc, T(0), T(-1), -cc};
          D fl[3] = {D(f[3 * c]), D(f[3 * c + 1]), D(f[3 * c + 2])}, fW[3];
          matvec3(Rwc, fl, fW);
          for (int r = 0; r < 5; ++r) {
            const D g = D(Cm[3 * r]) * fW[0] + D(Cm[3 * r + 1]) * fW[1]
                        + D(Cm[3 * r + 2]) * fW[2];
            emit(g, 5 * c + r, col, out[8], out[9], nullptr, nullptr);
            if (col == 0) {
              for (int k = 0; k < NF; ++k) {
                const int kk = k - 3 * c;
                out[10][(5 * c + r) * NF + k] =
                    (kk >= 0 && kk < 3)
                        ? Cm[3 * r] * Rwc[kk].v + Cm[3 * r + 1] * Rwc[3 + kk].v
                              + Cm[3 * r + 2] * Rwc[6 + kk].v
                        : T(0);
              }
            }
          }
        } else {
          // relative placement M_ref^-1 M(q) in the reference frame, its
          // SE(3) log [V^-1(w) p_rel; w], w = log3(R_ref^T R_w)
          D Rr[9], dpr[3], Rrel[9], prel[3], wl[3], vl[3];
          for (int k = 0; k < 9; ++k) Rr[k] = D(Rref[9 * c + k]);
          for (int k = 0; k < 3; ++k) dpr[k] = pwc[k] - D(pref[3 * c + k]);
          matTmul3(Rr, Rwc, Rrel);
          matTvec3(Rr, dpr, prel);
          so3_log(Rrel, wl);
          se3_log_linear(wl, prel, vl);
          for (int k = 0; k < 6; ++k) {
            const D C = af[k] + kv * vf[k] + kp * (k < 3 ? vl[k] : wl[k - 3]);
            emit(C, 6 * c + k, col, out[4], out[5], out[6], out[7]);
          }
          // 17-row rectangular wrench cone W(mu, X, Y) on the local wrench:
          // no configuration dependence (zero dg/dq), dg/df = W
          const T mu = fric[c], X = m.rect(c)[0], Y = m.rect(c)[1];
          const T o = T(1), z = T(0), XYmu = (X + Y) * mu;
          const T W[17 * 6] = {
              z, z, -o, z, z, z,              -o, z, -mu, z, z, z,
              o, z, -mu, z, z, z,             z, -o, -mu, z, z, z,
              z, o, -mu, z, z, z,             z, z, -Y, -o, z, z,
              z, z, -Y, o, z, z,              z, z, -X, z, -o, z,
              z, z, -X, z, o, z,              -Y, -X, -XYmu, mu, mu, -o,
              -Y, X, -XYmu, mu, -mu, -o,      Y, -X, -XYmu, -mu, mu, -o,
              Y, X, -XYmu, -mu, -mu, -o,      Y, X, -XYmu, mu, mu, o,
              Y, -X, -XYmu, mu, -mu, o,       -Y, X, -XYmu, -mu, mu, o,
              -Y, -X, -XYmu, -mu, -mu, o};
          for (int r = 0; r < 17; ++r) {
            T g = T(0);
            for (int k = 0; k < 6; ++k) g += W[6 * r + k] * f[6 * c + k];
            emit(D(g), 17 * c + r, col, out[8], out[9], nullptr, nullptr);
            if (col == 0) {
              for (int k = 0; k < NF; ++k) {
                const int kk = k - 6 * c;
                out[10][(17 * c + r) * NF + k] =
                    (kk >= 0 && kk < 6) ? W[6 * r + kk] : T(0);
              }
            }
          }
        }
        for (int k = 0; k < 3; ++k) {
          emit(pwc[k], 3 * c + k, col, out[11], out[12], nullptr, nullptr);
          if (WITH_COST && col < NV) Jr[(NV + 3 + 3 * c + k) * NV + col] =
              pwc[k].d;
        }
      }
      // centre of mass
      for (int j = 0; j < NJ; ++j) {
        D Rj[9], pj[3], cj[3], comj[3];
        for (int k = 0; k < 9; ++k) Rj[k] = w.place(j, k);
        for (int k = 0; k < 3; ++k) {
          pj[k] = w.place(j, 9 + k);
          cj[k] = D(m.com(j)[k]);
        }
        matvec3(Rj, cj, comj);
        for (int k = 0; k < 3; ++k) {
          const D t = D(m.mass(j)) * (comj[k] + pj[k]);
          com[k] = j == 0 ? t : com[k] + t;
        }
      }
      for (int k = 0; k < 3; ++k) {
        const D x = com[k] * D(T(1) / m.total_mass());
        emit(x, 3 * NC + k, col, out[11], out[12], nullptr, nullptr);
        if (WITH_COST && col < NV) Jr[(NV + 3 + 3 * NC + k) * NV + col] = x.d;
      }
    }

    if constexpr (WITH_COST) cost_fold(m, in, out, ws, tid, nt);

    // ---- RNEA backward: net forces, then child-to-parent sums ----------
    block_sync();
    const T* grav = m.gravity();
    for (int col = tid; col < NCOL; col += nt) {
      const Work w{ws, col};
      for (int j = 0; j < NJ; ++j) {
        D Rw[9], vj[6], at[6], mg[3], gl[3], Iv[6], Ia[6], x[6];
        for (int k = 0; k < 9; ++k) Rw[k] = w.place(j, k);
        for (int k = 0; k < 6; ++k) {
          vj[k] = w.motion(j, k);
          at[k] = w.motion(j, 6 + k);
        }
        for (int k = 0; k < 3; ++k) mg[k] = D(-grav[k]);
        matTvec3(Rw, mg, gl);
        for (int k = 0; k < 3; ++k) at[k] = at[k] + gl[k];
        inertia_apply(m.mass(j), m.com(j), m.Io(j), at, Ia);
        inertia_apply(m.mass(j), m.com(j), m.Io(j), vj, Iv);
        force_cross(vj, Iv, x);
        for (int k = 0; k < 6; ++k) x[k] = Ia[k] + x[k];
        for (int c = 0; c < NC; ++c) {   // contact forces on this joint
          if (m.cpar(c) != j) continue;
          // a point force (linear part only) or a surface wrench, local
          T fc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
          for (int k = 0; k < CT; ++k) fc[k] = f[CT * c + k];
          T fj[6];
          force_xfm(m.fR(c), m.fp(c), fc, fj);
          for (int k = 0; k < 6; ++k) x[k] = x[k] - D(fj[k]);
        }
        for (int k = 0; k < 6; ++k) {
          if (col == 0) ws[O_FV + 6 * j + k] = x[k].v;
          w.force_tan(j, k) = x[k].d;
        }
      }
    }
    block_sync();
    for (int l = nlev - 1; l >= 0; --l) {
      for (int col = tid; col < NCOL; col += nt) {
        const Work w{ws, col};
        for (int i = m.level_start(l); i < m.level_start(l + 1); ++i) {
          const int j = m.level_joint(i), p = m.parent(j);
          const int jt = m.jtype(j), vo = m.voff(j);
          D F[6];
          for (int k = 0; k < 6; ++k)
            F[k] = D(ws[O_FV + 6 * j + k], w.force_tan(j, k));
          if (jt == kFree) {
            for (int k = 0; k < 6; ++k)
              emit(F[k], vo + k, col, out[0], out[1], out[2], out[3]);
          } else {
            const T* ax = m.axis(j);
            const int o = jt == kRevolute ? 3 : 0;
            const D tq = D(ax[0]) * F[o] + D(ax[1]) * F[o + 1]
                         + D(ax[2]) * F[o + 2];
            emit(tq, vo, col, out[0], out[1], out[2], out[3]);
          }
          if (p >= 0) {
            D Rl[9], pl[3], X[6];
            local_dual(m, j, q, col, Rl, pl);
            force_xfm(Rl, pl, F, X);
            for (int k = 0; k < 6; ++k) {
              if (col == 0) ws[O_FV + 6 * p + k] += X[k].v;
              w.force_tan(p, k) += X[k].d;
            }
          }
        }
      }
      block_sync();
    }
  }

  // ---- gait cost stack + Lie state-equation base blocks ---------------
  static RTT_HD void cost_fold(const Model& m, const T* const* in,
                               T* const* out, T* ws, int tid, int nt) {
    const T* q = in[0];
    const T* v = in[1];
    const T* a = in[2];
    const T* const* ci = in + I_COST;
    const T* u = ci[0];
    const T dt = ci[1][0];
    const T* tref = ci[2];
    const T* tact = ci[3];
    const T* brq = ci[4];
    const T* wq = ci[5];
    const T* wv = ci[6];
    const T* wa = ci[7];
    const T* wu = ci[8];
    const T* wtask = ci[9];
    const T* wbr = ci[10];
    const T* qr = ci[11];
    const T* vr = ci[12];
    const T* qn = ci[13];
    T* Jr = ws + O_JR;
    T* rr = ws + O_RR;
    T* wr = ws + O_WR;
    T* Js = ws + O_JS;
    T* nu = ws + O_NU;
    T* A6 = ws + O_A6;
    for (int col = tid; col < NV; col += nt) {
      D R1[9], p1[3], R0[9], p0[3], Rrel[9], dp[3], prel[3], wl[3], vl[3];
      base_pose(q, col, R1, p1);
      base_pose(qr, -1, R0, p0);
      // configuration residual q (-) q_ref: base log6, then joint deltas
      matTmul3(R0, R1, Rrel);
      for (int k = 0; k < 3; ++k) dp[k] = p1[k] - p0[k];
      matTvec3(R0, dp, prel);
      so3_log(Rrel, wl);
      se3_log_linear(wl, prel, vl);
      D res[NR];
      for (int k = 0; k < 3; ++k) { res[k] = vl[k]; res[3 + k] = wl[k]; }
      for (int k = 6; k < NV; ++k)
        res[k] = D(q[k + 1] - qr[k + 1], col == k ? T(1) : T(0));
      // base-rotation residual log3(R_ref^T R_base)
      D Rb[9], pb[3], Rbr[9];
      T qb[7] = {T(0), T(0), T(0), brq[0], brq[1], brq[2], brq[3]};
      base_pose(qb, -1, Rb, pb);
      matTmul3(Rb, R1, Rbr);
      so3_log(Rbr, res + NV);
      for (int r = 0; r < NV + 3; ++r) Jr[r * NV + col] = res[r].d;
      if (col == 0) {
        for (int r = 0; r < NV; ++r) { rr[r] = res[r].v; wr[r] = wq[r]; }
        for (int k = 0; k < 3; ++k) {
          rr[NV + k] = res[NV + k].v;
          wr[NV + k] = wbr[k];
        }
        for (int k = 0; k < NT; ++k) {
          rr[NV + 3 + k] = out[11][k] - tref[k];
          wr[NV + 3 + k] = wtask[k] * tact[k];
        }
      }
    }
    // state equation: d(q_next (-) q) over the base tangents of q
    // (columns 0-5) and of q_next (columns 6-11)
    for (int col = tid; col < 12; col += nt) {
      D R0[9], p0[3], R1[9], p1[3], Rrel[9], dp[3], prel[3], wl[3], vl[3];
      base_pose(q, col, R0, p0);
      base_pose(qn, col - 6, R1, p1);
      matTmul3(R0, R1, Rrel);
      for (int k = 0; k < 3; ++k) dp[k] = p1[k] - p0[k];
      matTvec3(R0, dp, prel);
      so3_log(Rrel, wl);
      se3_log_linear(wl, prel, vl);
      for (int k = 0; k < 3; ++k) {
        Js[k * 12 + col] = vl[k].d;
        Js[(3 + k) * 12 + col] = wl[k].d;
        if (col == 0) { nu[k] = vl[k].v; nu[3 + k] = wl[k].v; }
      }
    }
    block_sync();
    for (int e = tid; e < 36; e += nt) A6[e] = Js[(e / 6) * 12 + 6 + e % 6];
    // Gauss-Newton blocks of the stack (all threads, disjoint entries)
    for (int e = tid; e < NV * NV; e += nt) {
      const int i = e / NV, j = e % NV;
      T acc = T(0);
      for (int r = 0; r < NR; ++r) acc += wr[r] * Jr[r * NV + i] * Jr[r * NV + j];
      out[18][e] = dt * acc;
    }
    for (int i = tid; i < NV; i += nt) {
      T acc = T(0);
      for (int r = 0; r < NR; ++r) acc += Jr[r * NV + i] * (wr[r] * rr[r]);
      out[14][i] = dt * acc;
      out[15][i] = dt * wv[i] * (v[i] - vr[i]);
      out[16][i] = dt * wa[i] * a[i];
    }
    for (int i = tid; i < NU; i += nt) out[17][i] = dt * wu[i] * u[i];
    if (tid == 0) {
      T c = T(0);
      for (int r = 0; r < NR; ++r) c += wr[r] * rr[r] * rr[r];
      for (int i = 0; i < NV; ++i)
        c += wv[i] * (v[i] - vr[i]) * (v[i] - vr[i]) + wa[i] * a[i] * a[i];
      for (int i = 0; i < NU; ++i) c += wu[i] * u[i] * u[i];
      out[13][0] = T(0.5) * dt * c;
    }
    block_sync();
    gauss_jordan<T, 6>(A6, 6, tid, nt);
    for (int e = tid; e < 36; e += nt) {
      const int i = e / 6, j = e % 6;
      T acc = T(0);
      for (int k = 0; k < 6; ++k) acc += A6[i * 6 + k] * Js[k * 12 + j];
      out[19][e] = -acc;
      out[20][e] = A6[e];
    }
    for (int i = tid; i < NV; i += nt) {
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
};

}  // namespace rtt

// Scalar, 3-D and spatial algebra of the chain kernel K6 (csrc/chain.cu),
// and the layout of its model tables (ops/chain.model_tables).
//
// Every routine is an RTT_HD template over the scalar type, so that the
// kernel body (csrc/chain_stage.cuh), its host build (csrc/host_shim.cpp)
// and its operation count (the body run on a counting scalar by
// csrc/chain_flops.cpp) share one code.
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

// theta, sin theta and cos theta of a rotation with trace tr, clipped
// clear of the poles
template <typename T>
RTT_HD void theta_s(T tr, T& theta, T& s, T& c) {
  c = m_clip(T(0.5) * (tr - T(1)), T(-1) + T(1e-7), T(1) - T(1e-12));
  theta = m_acos(c);
  const T s2 = (T(1) - c) * (T(1) + c);
  s = m_sqrt(s2 > T(1e-24) ? s2 : T(1e-24));
}

// ---- model tables (ops/chain.model_tables) ------------------------------
// consts: per joint [XR 9, Xp 3, axis 3, mass, com 3, Io 9], gravity 3,
// per contact [fR 9, fp 3, kp, kv, rect X, rect Y], total mass.
// topo: parents, jtypes, q_offs, v_offs (nj each), contact parents (nc);
// the chain layout (ops/chain.chain_layout): n_chains, n_chain_levels, per
// chain [first joint, length, parent joint, level, descendant chains]
// (nj slots), each contact's chain (nc), each joint's chain (nj; -1 for
// the base); then n_levels, level starts (n_levels + 1), joints in level
// order.
template <typename T, int NJ, int NC>
struct ChainModel {
  const T* c;
  const int* t;
  static constexpr int JW = 28, CW = 16;
  static constexpr int T_CH = 4 * NJ + NC, T_LV = T_CH + 2 + 6 * NJ + NC;
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
  RTT_HD int n_chains() const { return t[T_CH]; }
  RTT_HD int n_chain_levels() const { return t[T_CH + 1]; }
  RTT_HD int ch_first(int ch) const { return t[T_CH + 2 + 5 * ch]; }
  RTT_HD int ch_len(int ch) const { return t[T_CH + 3 + 5 * ch]; }
  RTT_HD int ch_parent(int ch) const { return t[T_CH + 4 + 5 * ch]; }
  RTT_HD int ch_level(int ch) const { return t[T_CH + 5 + 5 * ch]; }
  RTT_HD int ch_ndesc(int ch) const { return t[T_CH + 6 + 5 * ch]; }
  RTT_HD int contact_chain(int k) const { return t[T_CH + 2 + 5 * NJ + k]; }
  RTT_HD int joint_chain(int j) const {
    return t[T_CH + 2 + 5 * NJ + NC + j];
  }
  RTT_HD int n_levels() const { return t[T_LV]; }
  RTT_HD int level_start(int l) const { return t[T_LV + 1 + l]; }
  RTT_HD int level_joint(int i) const {
    return t[T_LV + 2 + n_levels() + i];
  }
};

constexpr int kFree = 0, kRevolute = 1;   // models/urdf.py joint types
constexpr int kPoint = 3, kSurface = 6;   // models/contacts.py types
}  // namespace rtt

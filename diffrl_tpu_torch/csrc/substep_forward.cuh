// One cached articulation substep per env, one thread per env.
//
// Replaces the TPU kernel substep_forward_batched
// (diffrl_tpu/sim/pallas_substep.py), whose traced body is
// articulation_substep(..., mass_cache=(Hinv, Hinv)): fk -> inverse
// dynamics -> ground contacts -> tau -> qdd = Hinv tau -> semi-implicit
// integrate. The plain PyTorch version of the same function is
// diffrl_tpu_torch/sim/articulation_lb.py:substep_lb; every formula below
// mirrors its env-minor counterpart there, in the same operation order.
//
// What bounds it: per env the kernel reads q [C], qd [D], joint_act [D] and
// Hinv [D*D] once and writes q' [C], qd' [D] once (Ant: 268 floats); the
// arithmetic is a few thousand flops, so the card's memory rate is the
// bound. Design against it: every [k, E] array is read at k*E + e, so the
// 32 threads of a warp touch 32 consecutive floats (coalesced), and every
// intermediate (link transforms, twists, wrenches, tau) stays in the
// thread's registers or local memory instead of round-tripping through
// device memory as the plain version's per-op tensors do.
//
// Compile-time model: substep_topology.h (generated per model topology by
// diffrl_tpu_torch/_build.py) defines the sizes and the per-link tables in
// processing order (parents before children). Every loop over links and
// contacts has a constant trip count and is unrolled, so table lookups fold
// to constants and per-link arrays are indexed with constants.
// The float constants (joint frames, inertias, gains, contact points and
// materials) come in one packed buffer laid out by the offsets below.
#pragma once

#include "substep_topology.h"

namespace drl {

constexpr int kPrismatic = 0;
constexpr int kRevolute = 1;
constexpr int kFree = 4;

constexpr int NL = DRL_NL;  // links
constexpr int NC = DRL_NC;  // coords
constexpr int ND = DRL_ND;  // dofs
constexpr int NK = DRL_NK;  // ground contacts

// packed constant buffer, per link row r at r * kLinkStride:
constexpr int kXpj = 0;       // joint frame in parent [7]
constexpr int kXcm = 7;       // COM frame in link [7]
constexpr int kAxis = 14;     // joint axis [3]
constexpr int kI3 = 17;       // rotational inertia about the COM, row-major [9]
constexpr int kMass = 26;
constexpr int kTargetKe = 27;
constexpr int kTargetKd = 28;
constexpr int kLimitKe = 29;
constexpr int kLimitKd = 30;
constexpr int kTarget = 31;
constexpr int kLower = 32;
constexpr int kUpper = 33;
constexpr int kLinkStride = 34;
constexpr int kGravity = NL * kLinkStride;  // [3]
constexpr int kContact0 = kGravity + 3;
// per contact k at kContact0 + k * kContactStride:
// point [3], dist, ke, kd, kf, mu
constexpr int kContactStride = 8;
constexpr int kConstCount = kContact0 + NK * kContactStride;

__device__ __forceinline__ int link_type(int r) {
  constexpr int v[] = DRL_TYPE;
  return v[r];
}
__device__ __forceinline__ int link_parent(int r) {  // -1 for roots
  constexpr int v[] = DRL_PARENT;
  return v[r];
}
__device__ __forceinline__ int link_qstart(int r) {
  constexpr int v[] = DRL_QSTART;
  return v[r];
}
__device__ __forceinline__ int link_dstart(int r) {
  constexpr int v[] = DRL_DSTART;
  return v[r];
}
__device__ __forceinline__ int contact_row(int k) {
  constexpr int v[] = DRL_CONTACT_ROW;
  return v[k];
}

struct V3 {
  float x, y, z;
};
struct Quat {
  float x, y, z, w;
};
struct Xform {
  V3 p;
  Quat q;
};
struct SV {  // spatial vector: angular part first, as the engine's [w, v]
  V3 w, v;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ SV operator+(SV a, SV b) {
  return {a.w + b.w, a.v + b.v};
}
__device__ __forceinline__ SV operator-(SV a, SV b) {
  return {a.w - b.w, a.v - b.v};
}
__device__ __forceinline__ SV operator*(SV a, float s) {
  return {a.w * s, a.v * s};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float dot(SV a, SV b) {
  return a.w.x * b.w.x + a.w.y * b.w.y + a.w.z * b.w.z + a.v.x * b.v.x +
         a.v.y * b.v.y + a.v.z * b.v.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// min/max that return NaN when either side is NaN (jnp.minimum and
// torch.minimum semantics; fminf would drop the NaN)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

__device__ __forceinline__ V3 qrot(Quat q, V3 v) {
  V3 qv = {q.x, q.y, q.z};
  return v * (2.0f * q.w * q.w - 1.0f) + cross(qv, v) * q.w * 2.0f +
         qv * dot(qv, v) * 2.0f;
}
__device__ __forceinline__ V3 qrot_inv(Quat q, V3 v) {
  V3 qv = {q.x, q.y, q.z};
  return v * (2.0f * q.w * q.w - 1.0f) - cross(qv, v) * q.w * 2.0f +
         qv * dot(qv, v) * 2.0f;
}
__device__ __forceinline__ Quat qmul(Quat a, Quat b) {
  return {a.w * b.x + b.w * a.x + a.y * b.z - b.y * a.z,
          a.w * b.y + b.w * a.y + a.z * b.x - b.z * a.x,
          a.w * b.z + b.w * a.z + a.x * b.y - b.x * a.y,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}
__device__ __forceinline__ Quat qconj(Quat q) { return {-q.x, -q.y, -q.z, q.w}; }
__device__ __forceinline__ Quat qnormalize(Quat q) {
  float l2 = q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w;
  bool safe = l2 > 1.0e-12f;
  float l = sqrtf(safe ? l2 : 1.0f);
  if (!safe) return {0.0f, 0.0f, 0.0f, 1.0f};
  return {q.x / l, q.y / l, q.z / l, q.w / l};
}

__device__ __forceinline__ Xform tmul(Xform t, Xform u) {
  return {qrot(t.q, u.p) + t.p, qmul(t.q, u.q)};
}
__device__ __forceinline__ Xform tinv(Xform t) {
  Quat qi = qconj(t.q);
  return {neg(qrot(qi, t.p)), qi};
}
__device__ __forceinline__ V3 tpoint(Xform t, V3 x) { return t.p + qrot(t.q, x); }

__device__ __forceinline__ SV scross(SV a, SV b) {
  return {cross(a.w, b.w), cross(a.v, b.w) + cross(a.w, b.v)};
}
__device__ __forceinline__ SV scross_dual(SV a, SV b) {
  return {cross(a.w, b.w) + cross(a.v, b.v), cross(a.w, b.v)};
}
__device__ __forceinline__ SV twist_xform(Xform t, SV x) {
  V3 w = qrot(t.q, x.w);
  return {w, qrot(t.q, x.v) + cross(t.p, w)};
}
__device__ __forceinline__ SV wrench_xform(Xform t, SV x) {
  V3 v = qrot(t.q, x.v);
  return {qrot(t.q, x.w) + cross(t.p, v), v};
}

// y = T^T I_m T x with T = Ad(t^-1): the factored spatial-inertia apply
__device__ __forceinline__ SV inertia_matvec(Xform t, const float* I3, float m,
                                             SV x) {
  SV u = twist_xform(tinv(t), x);
  V3 top = {I3[0] * u.w.x + I3[1] * u.w.y + I3[2] * u.w.z,
            I3[3] * u.w.x + I3[4] * u.w.y + I3[5] * u.w.z,
            I3[6] * u.w.x + I3[7] * u.w.y + I3[8] * u.w.z};
  return wrench_xform(t, SV{top, u.v * m});
}

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ Xform load_xform(const float* p) {
  return {{p[0], p[1], p[2]}, {p[3], p[4], p[5], p[6]}};
}

// q [NC, E], qd / joint_act [ND, E], hinv [ND, ND, E] (row i, column j at
// (i * ND + j) * E + e); outputs q_out [NC, E], qd_out [ND, E].
__global__ void __launch_bounds__(32) substep_forward_kernel(
    const float* __restrict__ q, const float* __restrict__ qd,
    const float* __restrict__ joint_act, const float* __restrict__ hinv,
    const float* __restrict__ P, float* __restrict__ q_out,
    float* __restrict__ qd_out, int E, float dt) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const Xform kIdentity = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f}};

  float qv[NC], qdv[ND];
#pragma unroll
  for (int i = 0; i < NC; ++i) qv[i] = q[i * E + e];
#pragma unroll
  for (int i = 0; i < ND; ++i) qdv[i] = qd[i * E + e];

  const V3 gravity = load3(P + kGravity);
  Xform X_sc[NL];  // link frames in space
  SV vel[NL];      // spatial twists
  SV acc[NL];      // spatial accelerations (velocity-product part)
  SV frc[NL];      // body wrenches, then subtree sums
  SV S[NL];        // motion subspace of each scalar joint

  // forward sweep: fk, motion subspaces, twists, bias forces
#pragma unroll
  for (int r = 0; r < NL; ++r) {
    const float* c = P + r * kLinkStride;
    const int ty = link_type(r);
    const int pr = link_parent(r);
    const int qs = link_qstart(r);
    const int ds = link_dstart(r);
    const Xform X_pj = load_xform(c + kXpj);
    const V3 axis = load3(c + kAxis);

    Xform X_jc = kIdentity;
    if (ty == kPrismatic) {
      X_jc.p = axis * qv[qs];
    } else if (ty == kRevolute) {
      const float half = qv[qs] * 0.5f;
      const V3 s = axis * sinf(half);
      X_jc.p = {0.0f, 0.0f, 0.0f};
      X_jc.q = {s.x, s.y, s.z, cosf(half)};
    } else {  // free
      X_jc = {{qv[qs], qv[qs + 1], qv[qs + 2]},
              {qv[qs + 3], qv[qs + 4], qv[qs + 5], qv[qs + 6]}};
    }
    const Xform X_local = tmul(X_pj, X_jc);
    X_sc[r] = pr < 0 ? X_local : tmul(X_sc[pr], X_local);
    const Xform X_sm = tmul(X_sc[r], load_xform(c + kXcm));
    const Xform X_sj = pr < 0 ? tmul(kIdentity, X_pj) : tmul(X_sc[pr], X_pj);

    SV v_j;
    if (ty == kRevolute) {
      const V3 w = qrot(X_sj.q, axis);
      S[r] = {w, cross(X_sj.p, w)};
      v_j = S[r] * qdv[ds];
    } else if (ty == kPrismatic) {
      const V3 v = qrot(X_sj.q, axis);
      S[r] = {{0.0f, 0.0f, 0.0f}, v};
      v_j = S[r] * qdv[ds];
    } else {  // free: S is the identity
      v_j = {{qdv[ds], qdv[ds + 1], qdv[ds + 2]},
             {qdv[ds + 3], qdv[ds + 4], qdv[ds + 5]}};
    }
    if (pr < 0) {
      vel[r] = v_j;
      acc[r] = scross(v_j, v_j);
    } else {
      vel[r] = vel[pr] + v_j;
      acc[r] = acc[pr] + scross(vel[r], v_j);
    }

    const float m = c[kMass];
    const V3 gm = gravity * m;
    const SV f_g = {cross(X_sm.p, gm), gm};
    const SV Ia = inertia_matvec(X_sm, c + kI3, m, acc[r]);
    const SV Iv = inertia_matvec(X_sm, c + kI3, m, vel[r]);
    frc[r] = Ia + scross_dual(vel[r], Iv) - f_g;
  }

  // ground contacts: penalty normal force, damping and clamped friction,
  // summed per link (the plain version's index_add_) before joining frc
  if (NK > 0) {
    SV cf[NL];
#pragma unroll
    for (int r = 0; r < NL; ++r) cf[r] = SV{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float* cc = P + kContact0 + k * kContactStride;
      const int row = contact_row(k);
      const float dist = cc[3], ke = cc[4], kd = cc[5], kf = cc[6], mu = cc[7];
      V3 p = tpoint(X_sc[row], load3(cc));
      p = {p.x - 0.0f * dist, p.y - 1.0f * dist, p.z - 0.0f * dist};
      const V3 dpdt = vel[row].v + cross(vel[row].w, p);
      const float c = p.y;
      const float vn = dpdt.y;
      const V3 vt = {dpdt.x - 0.0f * vn, dpdt.y - 1.0f * vn, dpdt.z - 0.0f * vn};
      const float fn = c * ke;
      const float fd = min_nan(vn, 0.0f) * kd * (-c);
      const float vt_len2 = dot(vt, vt);
      const bool safe = vt_len2 > 1.0e-12f;
      const float vt_len = sqrtf(safe ? vt_len2 : 1.0f);
      const V3 dir = safe ? V3{vt.x / vt_len, vt.y / vt_len, vt.z / vt_len}
                          : V3{0.0f, 0.0f, 0.0f};
      const float mag = min_nan(kf * (safe ? vt_len : 0.0f), -mu * c * ke);
      const V3 ft = dir * mag;
      const float fnd = fn + fd;
      V3 f_total = {0.0f * fnd + ft.x, 1.0f * fnd + ft.y, 0.0f * fnd + ft.z};
      if (!(c < 0.0f)) f_total = {0.0f, 0.0f, 0.0f};
      cf[row] = cf[row] + SV{cross(p, f_total), f_total};
    }
#pragma unroll
    for (int r = 0; r < NL; ++r) frc[r] = frc[r] + cf[r];
  }

  // subtree sums: reverse walk over the processing order, child into parent
#pragma unroll
  for (int r = NL - 1; r >= 0; --r) {
    const int pr = link_parent(r);
    if (pr >= 0) frc[pr] = frc[pr] + frc[r];
  }

  // joint-space torques
  float tau[ND];
#pragma unroll
  for (int r = 0; r < NL; ++r) {
    const float* c = P + r * kLinkStride;
    const int ty = link_type(r);
    const int qs = link_qstart(r);
    const int ds = link_dstart(r);
    if (ty == kFree) {
      tau[ds + 0] = -frc[r].w.x;
      tau[ds + 1] = -frc[r].w.y;
      tau[ds + 2] = -frc[r].w.z;
      tau[ds + 3] = -frc[r].v.x;
      tau[ds + 4] = -frc[r].v.y;
      tau[ds + 5] = -frc[r].v.z;
    } else {  // revolute / prismatic
      const float Sf = dot(S[r], frc[r]);
      const float qj = qv[qs];
      const float qdj = qdv[ds];
      const float lower = c[kLower], upper = c[kUpper], l_ke = c[kLimitKe];
      const float limit_f = qj < lower   ? l_ke * (lower - qj)
                            : qj > upper ? l_ke * (upper - qj)
                                         : 0.0f;
      const float damping_f = -c[kLimitKd] * qdj;
      tau[ds] = -Sf - c[kTargetKe] * (qj - c[kTarget]) - c[kTargetKd] * qdj +
                joint_act[ds * E + e] + limit_f + damping_f;
    }
  }

  // qdd = Hinv tau with the frozen inverse from the last refresh substep
  float qdd[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < ND; ++j) s += hinv[(i * ND + j) * E + e] * tau[j];
    qdd[i] = s;
  }

  // semi-implicit integration
#pragma unroll
  for (int r = 0; r < NL; ++r) {
    const int ty = link_type(r);
    const int qs = link_qstart(r);
    const int ds = link_dstart(r);
    if (ty == kFree) {
      const V3 w_s = V3{qdv[ds], qdv[ds + 1], qdv[ds + 2]} +
                     V3{qdd[ds], qdd[ds + 1], qdd[ds + 2]} * dt;
      const V3 v_s = V3{qdv[ds + 3], qdv[ds + 4], qdv[ds + 5]} +
                     V3{qdd[ds + 3], qdd[ds + 4], qdd[ds + 5]} * dt;
      const V3 p_s = {qv[qs], qv[qs + 1], qv[qs + 2]};
      const V3 dpdt = v_s + cross(w_s, p_s);
      const Quat r_s = {qv[qs + 3], qv[qs + 4], qv[qs + 5], qv[qs + 6]};
      const Quat dr = qmul(Quat{w_s.x, w_s.y, w_s.z, 0.0f}, r_s);
      const V3 p_n = p_s + dpdt * dt;
      const Quat r_n = qnormalize({r_s.x + dr.x * 0.5f * dt,
                                   r_s.y + dr.y * 0.5f * dt,
                                   r_s.z + dr.z * 0.5f * dt,
                                   r_s.w + dr.w * 0.5f * dt});
      q_out[(qs + 0) * E + e] = p_n.x;
      q_out[(qs + 1) * E + e] = p_n.y;
      q_out[(qs + 2) * E + e] = p_n.z;
      q_out[(qs + 3) * E + e] = r_n.x;
      q_out[(qs + 4) * E + e] = r_n.y;
      q_out[(qs + 5) * E + e] = r_n.z;
      q_out[(qs + 6) * E + e] = r_n.w;
      qd_out[(ds + 0) * E + e] = w_s.x;
      qd_out[(ds + 1) * E + e] = w_s.y;
      qd_out[(ds + 2) * E + e] = w_s.z;
      qd_out[(ds + 3) * E + e] = v_s.x;
      qd_out[(ds + 4) * E + e] = v_s.y;
      qd_out[(ds + 5) * E + e] = v_s.z;
    } else {  // revolute / prismatic
      const float qd_n = qdv[ds] + qdd[ds] * dt;
      q_out[qs * E + e] = qv[qs] + qd_n * dt;
      qd_out[ds * E + e] = qd_n;
    }
  }
}

}  // namespace drl

// VJP of one cached articulation substep per env, a team of T threads per
// env.
//
// Replaces the TPU kernel substep_vjp_batched
// (diffrl_tpu/sim/pallas_substep.py), which traced jax.vjp of the substep
// inside the kernel. Here the adjoint is written by hand, one adj_*
// function per forward primitive of substep_forward.cuh, placed in the same
// order. The plain PyTorch version of the same function is
// diffrl_tpu_torch/sim/articulation_lb.py:substep_vjp_lb (autograd of
// substep_lb); the conventions are the ones autodiff gives there and in JAX:
// - min_nan: the smaller side takes the cotangent, a tie gives half to each
//   (a NaN gives all of it to both, as torch.minimum's backward does);
// - a select (?:, the contact mask c < 0, the safe branches of the friction
//   direction and of qnormalize, the joint limits) passes the cotangent to
//   the branch it took only;
// - the frozen-factor solve qdd = Hinv tau: lam = Hinv adj_qdd (the
//   forward's index order), adj_tau = lam, dH = -lam qdd^T, Hinv frozen.
//   H itself is never read.
//
// Pass structure: recompute the forward with the phases of
// substep_forward.cuh (frames, twists, accelerations, motion subspaces,
// subtree wrenches and qdd stay in the env's shared-memory slot); then
// sweep backward: integrate -> solve -> torques and dH -> subtree sums ->
// contacts -> each link's wrench -> inverse dynamics and fk, level by level
// from the leaves to the root.
//
// What bounds it: per env it reads q, qd, joint_act, Hinv, gq and gqd once
// (Ant: 268 floats) and writes dq, dqd, djoint_act and dH once (239 floats);
// the arithmetic is roughly three times the forward's. The design is the
// forward kernel's: a team of T lanes per env, every intermediate and every
// adjoint in the env's shared-memory slot (kVjpEnvWords floats), global
// I/O staged through shared memory by the whole block. The lanes split the
// links of a level, the contacts, the rows of Hinv adj_qdd and the entries
// of dH. What a link passes to its parent (acceleration, twist and frame
// adjoints) goes to its own slot, and the parent's lane adds its children's
// after the level's sync, in descending row order: no atomics, so two
// launches give the same bits.
#pragma once

#include "substep_forward.cuh"

namespace drl {

__device__ __forceinline__ void operator+=(V3& a, V3 b) { a = a + b; }
__device__ __forceinline__ void operator+=(SV& a, SV b) { a = a + b; }
__device__ __forceinline__ void operator+=(Quat& a, Quat b) {
  a = {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}
__device__ __forceinline__ void operator+=(Xform& a, Xform b) {
  a.p += b.p;
  a.q += b.q;
}

#define kZero3 (V3{0.0f, 0.0f, 0.0f})
#define kZeroSV (SV{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}})
#define kZeroX (Xform{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}})

// cotangents of (a, b) for out = min_nan(a, b) given g (torch.minimum's
// backward: where(a == b, g / 2, g), zeroed on the side that is larger)
__device__ __forceinline__ void adj_min_nan(float a, float b, float g,
                                            float& ga, float& gb) {
  const float share = a == b ? 0.5f * g : g;
  ga += a > b ? 0.0f : share;
  gb += a < b ? 0.0f : share;
}

// cross(a, b): adj_a += cross(b, g), adj_b += cross(g, a)
__device__ __forceinline__ void adj_cross(V3 a, V3 b, V3 g, V3& aa, V3& ab) {
  aa += cross(b, g);
  ab += cross(g, a);
}

// qrot(q, v) = v (2w^2 - 1) + cross(qv, v) 2w + qv dot(qv, v) 2
__device__ __forceinline__ void adj_qrot(Quat q, V3 v, V3 g, Quat& aq,
                                         V3& av) {
  const V3 qv = {q.x, q.y, q.z};
  const float w = q.w;
  av += g * (2.0f * w * w - 1.0f) + cross(g, qv) * (2.0f * w) +
        qv * (2.0f * dot(qv, g));
  const V3 aqv = cross(v, g) * (2.0f * w) + v * (2.0f * dot(qv, g)) +
                 g * (2.0f * dot(qv, v));
  const float aw = 4.0f * w * dot(v, g) + 2.0f * dot(cross(qv, v), g);
  aq += Quat{aqv.x, aqv.y, aqv.z, aw};
}

__device__ __forceinline__ void adj_qmul(Quat a, Quat b, Quat g, Quat& aa,
                                         Quat& ab) {
  aa += Quat{b.w * g.x - b.z * g.y + b.y * g.z - b.x * g.w,
             b.z * g.x + b.w * g.y - b.x * g.z - b.y * g.w,
             -b.y * g.x + b.x * g.y + b.w * g.z - b.z * g.w,
             b.x * g.x + b.y * g.y + b.z * g.z + b.w * g.w};
  ab += Quat{a.w * g.x + a.z * g.y - a.y * g.z - a.x * g.w,
             -a.z * g.x + a.w * g.y + a.x * g.z - a.y * g.w,
             a.y * g.x - a.x * g.y + a.w * g.z - a.z * g.w,
             a.x * g.x + a.y * g.y + a.z * g.z + a.w * g.w};
}

// qnormalize: q / |q| on the safe branch, the identity (no gradient) else
__device__ __forceinline__ Quat adj_qnormalize(Quat q, Quat g) {
  const float l2 = q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w;
  if (!(l2 > 1.0e-12f)) return {0.0f, 0.0f, 0.0f, 0.0f};
  const float l = sqrtf(l2);
  const float al = -(g.x * q.x + g.y * q.y + g.z * q.z + g.w * q.w) / (l * l);
  const float s = 2.0f * (al * 0.5f / l);
  return {g.x / l + q.x * s, g.y / l + q.y * s, g.z / l + q.z * s,
          g.w / l + q.w * s};
}

// tmul(t, u) = {qrot(t.q, u.p) + t.p, qmul(t.q, u.q)}
__device__ __forceinline__ void adj_tmul(Xform t, Xform u, Xform g, Xform& at,
                                         Xform& au) {
  at.p += g.p;
  adj_qrot(t.q, u.p, g.p, at.q, au.p);
  adj_qmul(t.q, u.q, g.q, at.q, au.q);
}

// tinv(t) = {-qrot(qconj(t.q), t.p), qconj(t.q)}
__device__ __forceinline__ void adj_tinv(Xform t, Xform g, Xform& at) {
  const Quat qi = qconj(t.q);
  Quat aqi = g.q;
  adj_qrot(qi, t.p, neg(g.p), aqi, at.p);
  at.q += Quat{-aqi.x, -aqi.y, -aqi.z, aqi.w};
}

// twist_xform(t, x) = {w = qrot(q, x.w), qrot(q, x.v) + cross(p, w)}
__device__ __forceinline__ void adj_twist_xform(Xform t, SV x, SV g,
                                                Xform& at, SV& ax) {
  const V3 w = qrot(t.q, x.w);
  V3 aw = g.w;
  adj_cross(t.p, w, g.v, at.p, aw);
  adj_qrot(t.q, x.w, aw, at.q, ax.w);
  adj_qrot(t.q, x.v, g.v, at.q, ax.v);
}

// wrench_xform(t, x) = {qrot(q, x.w) + cross(p, v), v = qrot(q, x.v)}
__device__ __forceinline__ void adj_wrench_xform(Xform t, SV x, SV g,
                                                 Xform& at, SV& ax) {
  const V3 v = qrot(t.q, x.v);
  V3 av = g.v;
  adj_cross(t.p, v, g.w, at.p, av);
  adj_qrot(t.q, x.w, g.w, at.q, ax.w);
  adj_qrot(t.q, x.v, av, at.q, ax.v);
}

// inertia_matvec(t, I3, m, x) = wrench_xform(t, {I3 u.w, m u.v}) with
// u = twist_xform(tinv(t), x)
__device__ __forceinline__ void adj_inertia_matvec(Xform t, const float* I3,
                                                   float m, SV x, SV g,
                                                   Xform& at, SV& ax) {
  const Xform ti = tinv(t);
  const SV u = twist_xform(ti, x);
  const V3 top = {I3[0] * u.w.x + I3[1] * u.w.y + I3[2] * u.w.z,
                  I3[3] * u.w.x + I3[4] * u.w.y + I3[5] * u.w.z,
                  I3[6] * u.w.x + I3[7] * u.w.y + I3[8] * u.w.z};
  SV ay = kZeroSV;
  adj_wrench_xform(t, SV{top, u.v * m}, g, at, ay);
  const SV au = {{I3[0] * ay.w.x + I3[3] * ay.w.y + I3[6] * ay.w.z,
                  I3[1] * ay.w.x + I3[4] * ay.w.y + I3[7] * ay.w.z,
                  I3[2] * ay.w.x + I3[5] * ay.w.y + I3[8] * ay.w.z},
                 ay.v * m};
  Xform ati = kZeroX;
  adj_twist_xform(ti, x, au, ati, ax);
  adj_tinv(t, ati, at);
}

// scross(a, b) = {cross(a.w, b.w), cross(a.v, b.w) + cross(a.w, b.v)}
__device__ __forceinline__ void adj_scross(SV a, SV b, SV g, SV& aa, SV& ab) {
  adj_cross(a.w, b.w, g.w, aa.w, ab.w);
  adj_cross(a.v, b.w, g.v, aa.v, ab.w);
  adj_cross(a.w, b.v, g.v, aa.w, ab.v);
}

// scross_dual(a, b) = {cross(a.w, b.w) + cross(a.v, b.v), cross(a.w, b.v)}
__device__ __forceinline__ void adj_scross_dual(SV a, SV b, SV g, SV& aa,
                                                SV& ab) {
  adj_cross(a.w, b.w, g.w, aa.w, ab.w);
  adj_cross(a.v, b.v, g.w, aa.v, ab.v);
  adj_cross(a.w, b.v, g.v, aa.w, ab.v);
}

// one ground contact of add_contacts, recomputed from the link's frame X
// and twist v6; g is the cotangent of the link's summed wrench
__device__ __forceinline__ void adj_contact(const float* cc, Xform X, SV v6,
                                            SV g, Xform& aX, SV& av6) {
  const float dist = cc[3], ke = cc[4], kd = cc[5], kf = cc[6], mu = cc[7];
  const V3 pt = load3(cc);
  V3 p = tpoint(X, pt);
  p = {p.x - 0.0f * dist, p.y - 1.0f * dist, p.z - 0.0f * dist};
  const V3 dpdt = v6.v + cross(v6.w, p);
  const float c = p.y;
  if (!(c < 0.0f)) return;  // f_total selected to 0: nothing flows back
  const float vn = dpdt.y;
  const V3 vt = {dpdt.x - 0.0f * vn, dpdt.y - 1.0f * vn, dpdt.z - 0.0f * vn};
  const float mn = min_nan(vn, 0.0f);
  const float fd = mn * kd * (-c);
  const float fnd = c * ke + fd;
  const float vt_len2 = dot(vt, vt);
  const bool safe = vt_len2 > 1.0e-12f;
  const float vt_len = sqrtf(safe ? vt_len2 : 1.0f);
  const V3 dir = safe ? V3{vt.x / vt_len, vt.y / vt_len, vt.z / vt_len}
                      : kZero3;
  const float mag_a = kf * (safe ? vt_len : 0.0f);
  const float mag_b = -mu * c * ke;
  const float mag = min_nan(mag_a, mag_b);
  const V3 ft = dir * mag;
  const V3 f = {0.0f * fnd + ft.x, 1.0f * fnd + ft.y, 0.0f * fnd + ft.z};

  // wrench {cross(p, f), f}
  V3 af = g.v;
  V3 ap = kZero3;
  adj_cross(p, f, g.w, ap, af);
  const float afnd = 0.0f * af.x + 1.0f * af.y + 0.0f * af.z;
  // ft = dir * mag
  const V3 adir = af * mag;
  const float amag = dot(dir, af);
  float ga = 0.0f, gb = 0.0f;
  adj_min_nan(mag_a, mag_b, amag, ga, gb);
  float ac = -mu * ke * gb;
  float avt_len = safe ? kf * ga : 0.0f;
  V3 avt = kZero3;
  if (safe) {
    avt = {adir.x / vt_len, adir.y / vt_len, adir.z / vt_len};
    avt_len += -dot(adir, vt) / (vt_len * vt_len);
    avt += vt * (2.0f * (avt_len * 0.5f / vt_len));
  }
  // fnd = c ke + (mn kd) (-c)
  ac += ke * afnd - mn * kd * afnd;
  float avn = 0.0f, azero = 0.0f;
  adj_min_nan(vn, 0.0f, afnd * (-c) * kd, avn, azero);
  // vt = dpdt - n vn, vn = dpdt.y, c = p.y
  V3 adpdt = avt;
  avn += -(0.0f * avt.x + 1.0f * avt.y + 0.0f * avt.z);
  adpdt.y += avn;
  ap.y += ac;
  // dpdt = v6.v + cross(v6.w, p)
  av6.v += adpdt;
  adj_cross(v6.w, p, adpdt, av6.w, ap);
  // p = X.p + qrot(X.q, pt) - n dist
  aX.p += ap;
  V3 apt = kZero3;
  adj_qrot(X.q, pt, ap, aX.q, apt);
}

// K2's fields of an env slot, after the forward's (fw::)
namespace bw {
constexpr int gq = fw::end;      // cotangent of q' [NC]
constexpr int gqd = gq + NC;     // cotangent of qd' [ND]
constexpr int aq = gqd + ND;     // dq [NC]
constexpr int aqd = aq + NC;     // dqd [ND]
constexpr int aqdd = aqd + ND;   // [ND]
constexpr int atau = aqdd + ND;  // lam = Hinv adj_qdd [ND]
constexpr int dja = atau + ND;   // djoint_act [ND]
constexpr int aF = dja + ND;     // wrench adjoints [NL][6]
constexpr int aS = aF + 6 * NL;  // motion-subspace adjoints [NL][6]
constexpr int aX = aS + 6 * NL;  // link-frame adjoints [NL][7]
constexpr int avel = aX + 7 * NL;   // twist adjoints [NL][6]
constexpr int aacc = avel + 6 * NL;  // acceleration adjoints [NL][6]
constexpr int cX = aacc + 6 * NL;   // per contact: its link's frame [NK][7]
constexpr int cv = cX + 7 * NK;     // and twist [NK][6] adjoints
constexpr int pX = cv + 6 * NK;     // per link, to its parent: frame [NL][7],
constexpr int pvel = pX + 7 * NL;   // twist [NL][6] and
constexpr int pacc = pvel + 6 * NL;  // acceleration [NL][6] adjoints
constexpr int end = pacc + 6 * NL;
}  // namespace bw

constexpr int kVjpEnvWords = odd_words(bw::end);
static_assert(kVjpEnvWords == DRL_VJP_ENV_WORDS,
              "the adjoint slot differs from kernel_tables' layout");

// integrate: q' = q + qd' dt, qd' = qd + qdd dt (free joints: position by
// the spatial twist, rotation by qmul and qnormalize); the first adjoint of
// link r's coordinates, so it assigns aq and aqd
__device__ __forceinline__ void link_integrate_adj(float* s, int r, float dt) {
  const int qs = link_qstart(r), ds = link_dstart(r);
  const float* qv = s + fw::q + qs;
  const float* qdv = s + fw::qd + ds;
  const float* qdd = s + fw::qdd + ds;
  const float* gq = s + bw::gq + qs;
  const float* gqd = s + bw::gqd + ds;
  float* aq = s + bw::aq + qs;
  float* aqd = s + bw::aqd + ds;
  float* aqdd = s + bw::aqdd + ds;
  if (link_type(r) == kFree) {
    const V3 w_s = V3{qdv[0], qdv[1], qdv[2]} + V3{qdd[0], qdd[1], qdd[2]} * dt;
    const V3 p_s = {qv[0], qv[1], qv[2]};
    const Quat r_s = {qv[3], qv[4], qv[5], qv[6]};
    const Quat wq = {w_s.x, w_s.y, w_s.z, 0.0f};
    const Quat dr = qmul(wq, r_s);
    const Quat u = {r_s.x + dr.x * 0.5f * dt, r_s.y + dr.y * 0.5f * dt,
                    r_s.z + dr.z * 0.5f * dt, r_s.w + dr.w * 0.5f * dt};
    const V3 gp = {gq[0], gq[1], gq[2]};
    const Quat gr = {gq[3], gq[4], gq[5], gq[6]};
    V3 aw_s = {gqd[0], gqd[1], gqd[2]};
    V3 av_s = {gqd[3], gqd[4], gqd[5]};
    // r_n = qnormalize(r_s + dr * 0.5 * dt), dr = qmul(wq, r_s)
    Quat ar_s = adj_qnormalize(u, gr);
    const Quat adr = {ar_s.x * 0.5f * dt, ar_s.y * 0.5f * dt,
                      ar_s.z * 0.5f * dt, ar_s.w * 0.5f * dt};
    Quat awq = {0.0f, 0.0f, 0.0f, 0.0f};
    adj_qmul(wq, r_s, adr, awq, ar_s);
    aw_s += V3{awq.x, awq.y, awq.z};
    // p_n = p_s + (v_s + cross(w_s, p_s)) dt
    V3 ap_s = gp;
    const V3 adpdt = gp * dt;
    av_s += adpdt;
    adj_cross(w_s, p_s, adpdt, aw_s, ap_s);
    // w_s = w + qdd_w dt, v_s = v + qdd_v dt
    store_xform(aq, Xform{ap_s, ar_s});
    store_sv(aqd, SV{aw_s, av_s});
    store_sv(aqdd, SV{aw_s, av_s} * dt);
  } else {  // revolute / prismatic
    const float gq_j = gq[0];
    const float aqd_n = gqd[0] + gq_j * dt;
    aq[0] = gq_j;
    aqd[0] = aqd_n;
    aqdd[0] = aqd_n * dt;
  }
}

// joint torques of link r: its wrench adjoint aF (before the subtree
// sums), its motion-subspace adjoint aS, djoint_act and the gain and limit
// terms of aq, aqd
__device__ __forceinline__ void link_torque_adj(const float* P, float* s,
                                                int r) {
  const float* c = P + r * kLinkStride;
  const int qs = link_qstart(r);
  const int ds = link_dstart(r);
  const float* atau = s + bw::atau + ds;
  float* dja = s + bw::dja + ds;
  if (link_type(r) == kFree) {
    store_sv(s + bw::aF + 6 * r, SV{{-atau[0], -atau[1], -atau[2]},
                                    {-atau[3], -atau[4], -atau[5]}});
    store_sv(s + bw::aS + 6 * r, kZeroSV);
#pragma unroll
    for (int k = 0; k < 6; ++k) dja[k] = 0.0f;
  } else {
    const float at = atau[0];
    const float qj = s[fw::q + qs];
    store_sv(s + bw::aF + 6 * r, load_sv(s + fw::S + 6 * r) * (-at));
    store_sv(s + bw::aS + 6 * r, load_sv(s + fw::frc + 6 * r) * (-at));
    float aqj = -c[kTargetKe] * at;
    if (qj < c[kLower] || qj > c[kUpper]) aqj += -c[kLimitKe] * at;
    s[bw::aq + qs] += aqj;
    s[bw::aqd + ds] += -c[kTargetKd] * at - c[kLimitKd] * at;
    dja[0] = at;
  }
}

// ground contact k: the adjoints of its link's frame and twist, from the
// link's final wrench adjoint, to the contact's own slots
__device__ __forceinline__ void contact_adj(const float* P, float* s,
                                            int k) {
  const int row = contact_row(k);
  Xform aX = kZeroX;
  SV av6 = kZeroSV;
  adj_contact(P + kContact0 + k * kContactStride,
              load_xform(s + fw::X + 7 * row), load_sv(s + fw::vel + 6 * row),
              load_sv(s + bw::aF + 6 * row), aX, av6);
  store_xform(s + bw::cX + 7 * k, aX);
  store_sv(s + bw::cv + 6 * k, av6);
}

// link r's body wrench, frc = Ia + scross_dual(vel, Iv) - f_g with
// f_g = {cross(X_sm.p, gm), gm}: the adjoints of its frame, twist and
// acceleration, on top of its contacts' (in contact order)
__device__ __forceinline__ void body_wrench_adj(const float* P, float* s,
                                                int r) {
  const float* c = P + r * kLinkStride;
  Xform aX = kZeroX;
  SV avel = kZeroSV, aacc = kZeroSV;
  if (NK > 0) {
    for (int i = link_contact_start(r); i < link_contact_start(r + 1); ++i) {
      const int k = link_contact(i);
      aX += load_xform(s + bw::cX + 7 * k);
      avel += load_sv(s + bw::cv + 6 * k);
    }
  }
  const Xform X_sc = load_xform(s + fw::X + 7 * r);
  const Xform X_cm = load_xform(c + kXcm);
  const float m = c[kMass];
  const Xform X_sm = tmul(X_sc, X_cm);
  const SV vel = load_sv(s + fw::vel + 6 * r);
  const SV g = load_sv(s + bw::aF + 6 * r);
  Xform aX_sm = kZeroX;
  adj_inertia_matvec(X_sm, c + kI3, m, load_sv(s + fw::acc + 6 * r), g,
                     aX_sm, aacc);
  const SV Iv = inertia_matvec(X_sm, c + kI3, m, vel);
  SV aIv = kZeroSV;
  adj_scross_dual(vel, Iv, g, avel, aIv);
  adj_inertia_matvec(X_sm, c + kI3, m, vel, aIv, aX_sm, avel);
  V3 agm = kZero3;
  adj_cross(X_sm.p, load3(P + kGravity) * m, neg(g.w), aX_sm.p, agm);
  Xform dummyX = kZeroX;
  adj_tmul(X_sc, X_cm, aX_sm, aX, dummyX);
  store_xform(s + bw::aX + 7 * r, aX);
  store_sv(s + bw::avel + 6 * r, avel);
  store_sv(s + bw::aacc + 6 * r, aacc);
}

// link r's twist, acceleration and frame recursions, once its children's
// level has run: add what each child passed up (descending row order), then
// take the adjoints of v_j, S, X_sj and X_sc = tmul(X_sc[pr], tmul(X_pj,
// X_jc)); what belongs to the parent goes to r's p* slots
__device__ __forceinline__ void link_reverse(const float* P, float* s,
                                             int r) {
  const Xform kIdentity = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f}};
  const float* c = P + r * kLinkStride;
  const int ty = link_type(r);
  const int pr = link_parent(r);
  const int qs = link_qstart(r);
  const int ds = link_dstart(r);
  Xform aX = load_xform(s + bw::aX + 7 * r);
  SV avel = load_sv(s + bw::avel + 6 * r);
  SV aacc = load_sv(s + bw::aacc + 6 * r);
  for (int i = child_start(r); i < child_start(r + 1); ++i) {
    const int ch = child(i);
    aacc += load_sv(s + bw::pacc + 6 * ch);
    avel += load_sv(s + bw::pvel + 6 * ch);
    aX += load_xform(s + bw::pX + 7 * ch);
  }
  const float* qv = s + fw::q + qs;
  const float* qdv = s + fw::qd + ds;
  const Xform X_pj = load_xform(c + kXpj);
  const V3 axis = load3(c + kAxis);
  const Xform X_p = pr < 0 ? kIdentity : load_xform(s + fw::X + 7 * pr);
  Xform dummyX = kZeroX;
  Xform aX_p = kZeroX;  // cotangent of the parent's frame

  // v_j, then acc = acc[pr] + scross(vel, v_j), vel = vel[pr] + v_j
  const Xform X_sj = pr < 0 ? tmul(kIdentity, X_pj) : tmul(X_p, X_pj);
  const SV Sr = load_sv(s + fw::S + 6 * r);
  SV v_j;
  if (ty == kFree) {
    v_j = {{qdv[0], qdv[1], qdv[2]}, {qdv[3], qdv[4], qdv[5]}};
  } else {
    v_j = Sr * qdv[0];
  }
  SV avj = kZeroSV;
  if (pr < 0) {
    adj_scross(v_j, v_j, aacc, avj, avj);
  } else {
    store_sv(s + bw::pacc + 6 * r, aacc);
    adj_scross(load_sv(s + fw::vel + 6 * r), v_j, aacc, avel, avj);
    store_sv(s + bw::pvel + 6 * r, avel);
  }
  avj += avel;
  float* aq = s + bw::aq + qs;
  float* aqd = s + bw::aqd + ds;
  if (ty == kFree) {
    aqd[0] += avj.w.x;
    aqd[1] += avj.w.y;
    aqd[2] += avj.w.z;
    aqd[3] += avj.v.x;
    aqd[4] += avj.v.y;
    aqd[5] += avj.v.z;
  } else {
    const SV aS = load_sv(s + bw::aS + 6 * r) + avj * qdv[0];
    aqd[0] += dot(Sr, avj);
    // S from X_sj: revolute {w, cross(p, w)} with w = qrot(q, axis),
    // prismatic {0, qrot(q, axis)}
    Xform aX_sj = kZeroX;
    V3 aaxis = kZero3;
    if (ty == kRevolute) {
      const V3 w = qrot(X_sj.q, axis);
      V3 aw = aS.w;
      adj_cross(X_sj.p, w, aS.v, aX_sj.p, aw);
      adj_qrot(X_sj.q, axis, aw, aX_sj.q, aaxis);
    } else {
      adj_qrot(X_sj.q, axis, aS.v, aX_sj.q, aaxis);
    }
    if (pr >= 0) adj_tmul(X_p, X_pj, aX_sj, aX_p, dummyX);
  }

  // X_sc = tmul(X_sc[pr], X_local), X_local = tmul(X_pj, X_jc)
  Xform X_jc = kIdentity;
  float half = 0.0f;
  if (ty == kPrismatic) {
    X_jc.p = axis * qv[0];
  } else if (ty == kRevolute) {
    half = qv[0] * 0.5f;
    const V3 sn = axis * sinf(half);
    X_jc.p = kZero3;
    X_jc.q = {sn.x, sn.y, sn.z, cosf(half)};
  } else {
    X_jc = {{qv[0], qv[1], qv[2]}, {qv[3], qv[4], qv[5], qv[6]}};
  }
  Xform aX_local = kZeroX;
  if (pr < 0) {
    aX_local = aX;
  } else {
    adj_tmul(X_p, tmul(X_pj, X_jc), aX, aX_p, aX_local);
    store_xform(s + bw::pX + 7 * r, aX_p);
  }
  Xform aX_jc = kZeroX;
  adj_tmul(X_pj, X_jc, aX_local, dummyX, aX_jc);
  if (ty == kPrismatic) {
    aq[0] += dot(axis, aX_jc.p);
  } else if (ty == kRevolute) {
    const V3 aqv = {aX_jc.q.x, aX_jc.q.y, aX_jc.q.z};
    aq[0] += (dot(axis, aqv) * cosf(half) - aX_jc.q.w * sinf(half)) * 0.5f;
  } else {
    aq[0] += aX_jc.p.x;
    aq[1] += aX_jc.p.y;
    aq[2] += aX_jc.p.z;
    aq[3] += aX_jc.q.x;
    aq[4] += aX_jc.q.y;
    aq[5] += aX_jc.q.z;
    aq[6] += aX_jc.q.w;
  }
}

// q, gq [NC, E]; qd, joint_act, gqd [ND, E]; hinv [ND, ND, E]. Outputs
// dq [NC, E], dqd, djoint_act [ND, E], dh [ND, ND, E] (row i, column j at
// (i * ND + j) * E + e). Block b takes envs [b * kEnvsPerBlock, ...) with
// kVjpEnvWords floats of dynamic shared memory each, and a copy of the
// constant buffer.
__global__ void __launch_bounds__(kBlockThreads) substep_vjp_kernel(
    const float* __restrict__ q, const float* __restrict__ qd,
    const float* __restrict__ joint_act, const float* __restrict__ hinv,
    const float* __restrict__ gq, const float* __restrict__ gqd,
    const float* __restrict__ consts, float* __restrict__ dq,
    float* __restrict__ dqd, float* __restrict__ dja, float* __restrict__ dh,
    int E, float dt) {
  constexpr int W = kVjpEnvWords;
  const int e0 = blockIdx.x * kEnvsPerBlock;
  const int nenv = E - e0 < kEnvsPerBlock ? E - e0 : kEnvsPerBlock;
  const float* P = drl_smem + kEnvsPerBlock * W;
  DRL_FOR_EACH_THREAD(t) {
    load_consts<W>(consts, t);
    load_rows<W>(q, NC, fw::q, e0, E, t);
    load_rows<W>(qd, ND, fw::qd, e0, E, t);
    DRL_COPY_COMMIT();
    load_rows<W>(joint_act, ND, fw::ja, e0, E, t);
    load_rows<W>(hinv, ND * ND, fw::hinv, e0, E, t);
    load_rows<W>(gq, NC, bw::gq, e0, E, t);
    load_rows<W>(gqd, ND, bw::gqd, e0, E, t);
    DRL_COPY_COMMIT();
    copy_tables(t);
    DRL_COPY_WAIT_PRIOR();
  }
  __syncthreads();

  // ---- forward recompute (substep_forward_kernel up to qdd)
  forward_phases<W>(P, nenv);

  // ---- integrate
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int r = t % T; r < NL; r += T) link_integrate_adj(s, r, dt);
    }
  }
  __syncwarp();
  // ---- solve: lam = Hinv adj_qdd is adj_tau
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int i = t % T; i < ND; i += T)
        hinv_row(s, s + bw::aqdd, s + bw::atau, i);
    }
  }
  __syncwarp();
  // ---- dH = -lam qdd^T, over Hinv (read for the last time above); joint
  // torques
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int i = t % T; i < ND * ND; i += T)
        s[fw::hinv + i] = -s[bw::atau + i / ND] * s[fw::qdd + i % ND];
      for (int r = t % T; r < NL; r += T) link_torque_adj(P, s, r);
    }
  }
  __syncwarp();
  // ---- subtree sums: each link's wrench reached all its ancestors
#pragma unroll 1
  for (int lv = 1; lv < NLEV; ++lv) {
    DRL_FOR_EACH_THREAD(t) {
      if (float* s = env_slot<W>(t, nenv)) {
        for (int r = level_start(lv) + t % T; r < level_start(lv + 1); r += T) {
          const SV a = load_sv(s + bw::aF + 6 * r) +
                       load_sv(s + bw::aF + 6 * link_parent(r));
          store_sv(s + bw::aF + 6 * r, a);
        }
      }
    }
    __syncwarp();
  }
  // ---- contacts, then each link's body wrench
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int k = t % T; k < NK; k += T) contact_adj(P, s, k);
    }
  }
  __syncwarp();
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int r = t % T; r < NL; r += T) body_wrench_adj(P, s, r);
    }
  }
  __syncwarp();
  // ---- inverse dynamics and fk, leaves to root
#pragma unroll 1
  for (int lv = NLEV - 1; lv >= 0; --lv) {
    DRL_FOR_EACH_THREAD(t) {
      if (float* s = env_slot<W>(t, nenv)) {
        for (int r = level_start(lv) + t % T; r < level_start(lv + 1);
             r += T)
          link_reverse(P, s, r);
      }
    }
    __syncwarp();
  }

  __syncthreads();
  DRL_FOR_EACH_THREAD(t) {
    store_rows<W>(dq, NC, bw::aq, e0, E, t);
    store_rows<W>(dqd, ND, bw::aqd, e0, E, t);
    store_rows<W>(dja, ND, bw::dja, e0, E, t);
    store_rows<W>(dh, ND * ND, fw::hinv, e0, E, t);
  }
}

}  // namespace drl

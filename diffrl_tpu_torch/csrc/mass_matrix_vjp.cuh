// VJP of the articulation's mass matrix H(q) per env, a team of T threads
// per env.
//
// The refresh substep builds H from the joint coordinates alone (fk, the
// joint frames and motion subspaces, the composite inertias: CRBA) and then
// runs the cached substep's chain on (H, Hinv). So its VJP is the adjoint
// kernel's (substep_vjp.cuh) at the block's start plus this one: given the
// whole cotangent G of H, it adds (dH/dq)^T G to dq. The plain PyTorch
// version of the same function is
// diffrl_tpu_torch/sim/articulation_lb.py:mass_matrix_vjp_lb (autograd of
// _mass_matrix_h after _fk and _motion_subspaces); the conventions are the
// ones autodiff gives there: the raw quaternion coordinates of free and
// ball joints are read as they are (no normalization), and a free joint's
// motion subspace is the constant identity. It replaces no TPU kernel: the
// JAX package's reverse pass replays the refresh substep under jax.vjp
// (diffrl_tpu/sim/articulation_lb.py, simulate_batched_lb's run_bwd), and
// this kernel is what lets the port's reverse pass skip that replay.
//
// The forward, in canonical dof order (a, b dofs, l(a) the link row that
// owns a, anc(r, s) that row r is an ancestor of row s or s itself):
//   I_j = T_j^T Im_j T_j, T_j = Ad(X_sm[j]^-1) (gram_matvec), Im_j the
//     link's inertia about its COM;
//   U_b = sum_{j: anc(l(b), j)} I_j S_b   (the composite inertia's column);
//   H[a, b] = S_a . U_b where anc(l(a), l(b)), else S_b . U_a where
//     anc(l(b), l(a)), else 0.
// The reverse sweep:
//   dA[a, b] = G[a, b] where anc(l(a), l(b)), plus G[b, a] where l(a) is a
//     strict ancestor of l(b);
//   W_b = sum_a dA[a, b] S_a (U_b's cotangent) and
//   aS_a = sum_b dA[a, b] U_b;
//   aS_b += sum_j I_j^T W_b, and X_sm[j]'s cotangent from
//     sum_b <W_b, I_j S_b> (adj_gram_matvec);
//   X_sm = X_sc X_cm, S from the joint frames X_sj = X_sc[parent] X_pj, and
//   fk, level by level from the leaves to the root, down to q.
//
// What bounds it: per env it reads q [C], G [D*D] and the dq it adds to [C]
// once and writes dq [C] once (Ant: 241 floats); the arithmetic is two gram
// matvecs and one adjoint for every (link, dof of an ancestor or of the
// link) pair (Ant: 66 pairs, about 7.7e4 flops in all, by
// substep_kernels.mass_matrix_vjp_flops), so operations bound it on every
// model: on Ant 75 us at 65,536 envs on an H100. The design is the other
// kernels': a team of T lanes per env inside one warp (T = DRL_T, the
// substep kernels' team), every intermediate and adjoint in the env's
// shared-memory slot (kMassEnvWords floats, odd), global I/O staged through
// shared memory by the whole block with cp.async. The lanes split the
// links of a level, the dofs and the links; every sum is taken by one lane
// in a fixed order (over dofs or links in increasing order, a link's
// children in descending row order), so two launches give the same bits.
//
// Compile-time model: substep_topology.h, the substep kernels' generated
// header, with the tables this kernel adds (each dof's link row, each
// link's ancestor mask); the constants are the substep kernels' packed
// buffer. The adjoint primitives (adj_qrot, adj_tmul, ...) are
// substep_vjp.cuh's.
#pragma once

#include "substep_vjp.cuh"

namespace drl {

static_assert(NL <= 63, "the ancestor masks (signed 64-bit literals in the "
              "generated header) hold 63 links");

// Each dof's link row (canonical dof order) and each link's ancestors: bit
// s of anc[r] is set when row s is an ancestor of row r or r itself. The
// block copies them into shared memory with the substep kernels' tables.
struct MassTables {
  unsigned long long anc[NL];
  int dof_row[ND > 0 ? ND : 1];
};
__constant__ MassTables kMassTables = {DRL_ANC, DRL_DOF_ROW};
__shared__ MassTables drl_mass_tables;

__device__ __forceinline__ void copy_mass_tables(int t) {
  const int* src = reinterpret_cast<const int*>(&kMassTables);
  int* dst = reinterpret_cast<int*>(&drl_mass_tables);
  for (int i = t; i < static_cast<int>(sizeof(MassTables) / sizeof(int));
       i += kBlockThreads)
    dst[i] = src[i];
}
// row r is an ancestor of row s, or s itself
__device__ __forceinline__ bool is_anc(int r, int s) {
  return (drl_mass_tables.anc[s] >> r) & 1ull;
}
__device__ __forceinline__ int dof_row(int a) {
  return drl_mass_tables.dof_row[a];
}

// One env's slot, in floats
namespace mm {
constexpr int q = 0;             // [NC]
constexpr int g = q + NC;        // cotangent of H [ND][ND], row-major
constexpr int X = g + ND * ND;   // link frames in space X_sc [NL][7]
constexpr int Xm = X + 7 * NL;   // COM frames X_sm [NL][7]
constexpr int S = Xm + 7 * NL;   // motion-subspace column of each dof [ND][6]
constexpr int U = S + 6 * ND;    // composite inertia times S [ND][6]
constexpr int W = U + 6 * ND;    // U's cotangent [ND][6]
constexpr int aS = W + 6 * ND;   // S's cotangent [ND][6]
constexpr int aX = aS + 6 * ND;  // link-frame cotangents [NL][7]
constexpr int pX = aX + 7 * NL;  // per link, to its parent's frame [NL][7]
constexpr int aq = pX + 7 * NL;  // dq [NC]
constexpr int end = aq + NC;
}  // namespace mm

constexpr int kMassEnvWords = odd_words(mm::end);
static_assert(kMassEnvWords == DRL_MASS_ENV_WORDS,
              "the mass-matrix slot differs from kernel_tables' layout");

// I3 x (row-major) or, transposed, I3^T x
template <bool kTrans>
__device__ __forceinline__ V3 i3_apply(const float* I3, V3 x) {
  if (kTrans)
    return {I3[0] * x.x + I3[3] * x.y + I3[6] * x.z,
            I3[1] * x.x + I3[4] * x.y + I3[7] * x.z,
            I3[2] * x.x + I3[5] * x.y + I3[8] * x.z};
  return {I3[0] * x.x + I3[1] * x.y + I3[2] * x.z,
          I3[3] * x.x + I3[4] * x.y + I3[5] * x.z,
          I3[6] * x.x + I3[7] * x.y + I3[8] * x.z};
}

// the exact transpose of x -> twist_xform(ti, x), ti = tinv(t):
// {qrot_inv(ti.q, y.w - ti.p x y.v), qrot_inv(ti.q, y.v)}
// (articulation_lb._twist_inv_T)
__device__ __forceinline__ SV twist_inv_T(Xform ti, SV y) {
  return {qrot_inv(ti.q, y.w - cross(ti.p, y.v)), qrot_inv(ti.q, y.v)};
}

// y = T^T Im T x with T = Ad(t^-1), ti = tinv(t) (articulation_lb.
// _inertia_gram_matvec), or with kTrans the transpose T^T Im^T T x
template <bool kTrans>
__device__ __forceinline__ SV gram_matvec(Xform ti, const float* I3, float m,
                                          SV x) {
  const SV u = twist_xform(ti, x);
  return twist_inv_T(ti, SV{i3_apply<kTrans>(I3, u.w), u.v * m});
}

// qrot_inv(q, v) = qrot(qconj(q), v)
__device__ __forceinline__ void adj_qrot_inv(Quat q, V3 v, V3 g, Quat& aq,
                                             V3& av) {
  Quat ac = {0.0f, 0.0f, 0.0f, 0.0f};
  adj_qrot(qconj(q), v, g, ac, av);
  aq += Quat{-ac.x, -ac.y, -ac.z, ac.w};
}

// the cotangent of ti in <g, gram_matvec(ti, I3, m, x)>, added to ati
__device__ __forceinline__ void adj_gram_matvec(Xform ti, const float* I3,
                                                float m, SV x, SV g,
                                                Xform& ati) {
  const SV u = twist_xform(ti, x);
  const SV y = {i3_apply<false>(I3, u.w), u.v * m};
  // out = {qrot_inv(ti.q, z), qrot_inv(ti.q, y.v)}, z = y.w - ti.p x y.v
  const V3 z = y.w - cross(ti.p, y.v);
  SV ay = kZeroSV;
  V3 az = kZero3;
  adj_qrot_inv(ti.q, z, g.w, ati.q, az);
  adj_qrot_inv(ti.q, y.v, g.v, ati.q, ay.v);
  ay.w += az;
  adj_cross(ti.p, y.v, neg(az), ati.p, ay.v);
  // y = {I3 u.w, m u.v}, u = twist_xform(ti, x)
  SV ax = kZeroSV;
  adj_twist_xform(ti, x, SV{i3_apply<true>(I3, ay.w), ay.v * m}, ati, ax);
}

// fk of link r (its parent's frame final), its COM frame, and its dofs'
// motion-subspace columns from its joint frame
__device__ __forceinline__ void mass_link_forward(const float* P, float* s,
                                                  int r) {
  const Xform kIdentity = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f}};
  const float* c = P + r * kLinkStride;
  const int ty = link_type(r);
  const int pr = link_parent(r);
  const Xform X_pj = load_xform(c + kXpj);
  const V3 axis = load3(c + kAxis);
  const Xform X_local = tmul(X_pj, joint_xform(ty, axis, s + mm::q +
                                                          link_qstart(r)));
  Xform X_sc, X_sj;
  if (pr < 0) {
    X_sc = X_local;
    X_sj = tmul(kIdentity, X_pj);
  } else {
    const Xform X_p = load_xform(s + mm::X + 7 * pr);
    X_sc = tmul(X_p, X_local);
    X_sj = tmul(X_p, X_pj);
  }
  store_xform(s + mm::X + 7 * r, X_sc);
  store_xform(s + mm::Xm + 7 * r, tmul(X_sc, load_xform(c + kXcm)));
  float* S = s + mm::S + 6 * link_dstart(r);
  if (is_type(ty, kFree)) {
#pragma unroll
    for (int k = 0; k < 6; ++k)
#pragma unroll
      for (int i = 0; i < 6; ++i) S[6 * k + i] = i == k ? 1.0f : 0.0f;
  } else {
    const int ncol = subspace_cols(ty);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k >= ncol) break;
      store_sv(S + 6 * k, subspace_col(ty, X_sj, axis, k));
    }
  }
}

// U_b = sum over the links j of l(b)'s subtree, in row order, of I_j S_b
__device__ __forceinline__ void composite_column(const float* P, float* s,
                                                 int b) {
  const int rb = dof_row(b);
  const SV Sb = load_sv(s + mm::S + 6 * b);
  SV U = kZeroSV;
  for (int j = rb; j < NL; ++j) {  // a link's subtree lies at rows >= its own
    if (!is_anc(rb, j)) continue;
    const float* c = P + j * kLinkStride;
    U += gram_matvec<false>(tinv(load_xform(s + mm::Xm + 7 * j)), c + kI3,
                            c[kMass], Sb);
  }
  store_sv(s + mm::U + 6 * b, U);
}

// dof x: W_x = sum_a dA[a, x] S_a and aS_x = sum_b dA[x, b] U_b, with
// dA[a, b] = G[a, b] where anc(l(a), l(b)), plus G[b, a] where l(a) is a
// strict ancestor of l(b)
__device__ __forceinline__ void mass_entries_adj(float* s, int x) {
  const int rx = dof_row(x);
  const float* G = s + mm::g;
  SV Wx = kZeroSV, aSx = kZeroSV;
  for (int a = 0; a < ND; ++a) {
    const int ra = dof_row(a);
    if (is_anc(ra, rx)) {  // dA[a, x]
      const float dA = G[a * ND + x] + (is_anc(rx, ra) ? 0.0f : G[x * ND + a]);
      Wx += load_sv(s + mm::S + 6 * a) * dA;
    }
    if (is_anc(rx, ra)) {  // dA[x, a]
      const float dA = G[x * ND + a] + (is_anc(ra, rx) ? 0.0f : G[a * ND + x]);
      aSx += load_sv(s + mm::U + 6 * a) * dA;
    }
  }
  store_sv(s + mm::W + 6 * x, Wx);
  store_sv(s + mm::aS + 6 * x, aSx);
}

// dof b: aS_b += sum over the links j of l(b)'s subtree of I_j^T W_b
__device__ __forceinline__ void composite_column_adj(const float* P, float* s,
                                                     int b) {
  const int rb = dof_row(b);
  const SV Wb = load_sv(s + mm::W + 6 * b);
  SV a = load_sv(s + mm::aS + 6 * b);
  for (int j = rb; j < NL; ++j) {
    if (!is_anc(rb, j)) continue;
    const float* c = P + j * kLinkStride;
    a += gram_matvec<true>(tinv(load_xform(s + mm::Xm + 7 * j)), c + kI3,
                           c[kMass], Wb);
  }
  store_sv(s + mm::aS + 6 * b, a);
}

// link j: the cotangent of its frame X_sc through its inertia I_j, from
// sum over the dofs b of its ancestors and itself of <W_b, I_j S_b>
__device__ __forceinline__ void link_inertia_adj(const float* P, float* s,
                                                 int j) {
  const float* c = P + j * kLinkStride;
  const Xform X_sc = load_xform(s + mm::X + 7 * j);
  const Xform X_cm = load_xform(c + kXcm);
  const Xform X_sm = load_xform(s + mm::Xm + 7 * j);
  const Xform ti = tinv(X_sm);
  Xform ati = kZeroX;
  for (int b = 0; b < ND; ++b) {
    if (!is_anc(dof_row(b), j)) continue;
    adj_gram_matvec(ti, c + kI3, c[kMass], load_sv(s + mm::S + 6 * b),
                    load_sv(s + mm::W + 6 * b), ati);
  }
  Xform aX_sm = kZeroX, aX = kZeroX, dummy = kZeroX;
  adj_tinv(X_sm, ati, aX_sm);
  adj_tmul(X_sc, X_cm, aX_sm, aX, dummy);
  store_xform(s + mm::aX + 7 * j, aX);
}

// link r, once its children's level has run: its frame's cotangent (its
// own and what each child passed up, in descending row order), then the
// adjoints of its motion-subspace columns through X_sj = X_sc[pr] X_pj and
// of X_sc = X_sc[pr] X_pj X_jc down to its coordinates, added to aq; what
// belongs to the parent goes to r's pX slot
__device__ __forceinline__ void mass_link_reverse(const float* P, float* s,
                                                  int r) {
  const Xform kIdentity = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f}};
  const float* c = P + r * kLinkStride;
  const int ty = link_type(r);
  const int pr = link_parent(r);
  const float* qv = s + mm::q + link_qstart(r);
  float* aq = s + mm::aq + link_qstart(r);
  Xform aX = load_xform(s + mm::aX + 7 * r);
  for (int i = child_start(r); i < child_start(r + 1); ++i)
    aX += load_xform(s + mm::pX + 7 * child(i));
  const Xform X_pj = load_xform(c + kXpj);
  const V3 axis = load3(c + kAxis);
  const Xform X_p = pr < 0 ? kIdentity : load_xform(s + mm::X + 7 * pr);
  Xform aX_p = kZeroX, dummy = kZeroX;

  // each column S_k from X_sj: revolute and ball {w, cross(p, w)},
  // prismatic {0, w}, with w = qrot(q, axis_k); a free joint's is
  // constant, and so is a root's joint frame
  const int ncol = subspace_cols(ty);
  if (ncol > 0 && pr >= 0) {
    const Xform X_sj = tmul(X_p, X_pj);
    Xform aX_sj = kZeroX;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k >= ncol) break;
      const SV aS = load_sv(s + mm::aS + 6 * (link_dstart(r) + k));
      const V3 ax = subspace_axis(ty, axis, k);
      V3 aaxis = kZero3;
      if (is_type(ty, kPrismatic)) {
        adj_qrot(X_sj.q, ax, aS.v, aX_sj.q, aaxis);
      } else {
        const V3 w = qrot(X_sj.q, ax);
        V3 aw = aS.w;
        adj_cross(X_sj.p, w, aS.v, aX_sj.p, aw);
        adj_qrot(X_sj.q, ax, aw, aX_sj.q, aaxis);
      }
    }
    adj_tmul(X_p, X_pj, aX_sj, aX_p, dummy);
  }

  // X_sc = tmul(X_sc[pr], X_local), X_local = tmul(X_pj, X_jc)
  const Xform X_jc = joint_xform(ty, axis, qv);
  Xform aX_local = kZeroX;
  if (pr < 0) {
    aX_local = aX;
  } else {
    adj_tmul(X_p, tmul(X_pj, X_jc), aX, aX_p, aX_local);
    store_xform(s + mm::pX + 7 * r, aX_p);
  }
  if (is_type(ty, kFixed)) return;  // X_jc is the identity: no coordinate
  Xform aX_jc = kZeroX;
  adj_tmul(X_pj, X_jc, aX_local, dummy, aX_jc);
  if (is_type(ty, kPrismatic)) {
    aq[0] += dot(axis, aX_jc.p);
  } else if (is_type(ty, kRevolute)) {
    const float half = qv[0] * 0.5f;
    const V3 aqv = {aX_jc.q.x, aX_jc.q.y, aX_jc.q.z};
    aq[0] += (dot(axis, aqv) * cosf(half) - aX_jc.q.w * sinf(half)) * 0.5f;
  } else if (is_type(ty, kBall)) {  // X_jc = {0, q}
    aq[0] += aX_jc.q.x;
    aq[1] += aX_jc.q.y;
    aq[2] += aX_jc.q.z;
    aq[3] += aX_jc.q.w;
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

// q, dq_in, dq_out [NC, E]; gh [ND, ND, E] (row i, column j at
// (i * ND + j) * E + e), the whole cotangent of H. dq_out = dq_in +
// (dH/dq)^T gh. Block b takes envs [b * kEnvsPerBlock, ...) with
// kMassEnvWords floats of dynamic shared memory each, and a copy of the
// constant buffer.
__global__ void __launch_bounds__(kBlockThreads) mass_matrix_vjp_kernel(
    const float* __restrict__ q, const float* __restrict__ gh,
    const float* __restrict__ dq_in, const float* __restrict__ consts,
    float* __restrict__ dq_out, int E) {
  constexpr int W = kMassEnvWords;
  const int e0 = blockIdx.x * kEnvsPerBlock;
  const int nenv = E - e0 < kEnvsPerBlock ? E - e0 : kEnvsPerBlock;
  const float* P = drl_smem + kEnvsPerBlock * W;
  DRL_FOR_EACH_THREAD(t) {
    load_consts<W>(consts, t);
    load_rows<W>(q, NC, mm::q, e0, E, t);
    DRL_COPY_COMMIT();
    load_rows<W>(gh, ND * ND, mm::g, e0, E, t);
    load_rows<W>(dq_in, NC, mm::aq, e0, E, t);
    DRL_COPY_COMMIT();
    copy_tables(t);
    copy_mass_tables(t);
    DRL_COPY_WAIT_PRIOR();
  }
  __syncthreads();

  // ---- fk, COM frames and motion subspaces, level by level
#pragma unroll 1
  for (int lv = 0; lv < NLEV; ++lv) {
    DRL_FOR_EACH_THREAD(t) {
      if (float* s = env_slot<W>(t, nenv)) {
        for (int r = level_start(lv) + t % T; r < level_start(lv + 1);
             r += T)
          mass_link_forward(P, s, r);
      }
    }
    __syncwarp();
  }
  // ---- the composite inertias' columns U
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int b = t % T; b < ND; b += T) composite_column(P, s, b);
    }
    DRL_COPY_WAIT();
  }
  __syncthreads();
  // ---- H's entries: the cotangents of U and S
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int x = t % T; x < ND; x += T) mass_entries_adj(s, x);
    }
  }
  __syncwarp();
  // ---- U = I^C S: S's cotangent and each link frame's through its inertia
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int b = t % T; b < ND; b += T) composite_column_adj(P, s, b);
      for (int j = t % T; j < NL; j += T) link_inertia_adj(P, s, j);
    }
  }
  __syncwarp();
  // ---- joint frames and fk, leaves to root
#pragma unroll 1
  for (int lv = NLEV - 1; lv >= 0; --lv) {
    DRL_FOR_EACH_THREAD(t) {
      if (float* s = env_slot<W>(t, nenv)) {
        for (int r = level_start(lv) + t % T; r < level_start(lv + 1);
             r += T)
          mass_link_reverse(P, s, r);
      }
    }
    __syncwarp();
  }

  __syncthreads();
  DRL_FOR_EACH_THREAD(t) { store_rows<W>(dq_out, NC, mm::aq, e0, E, t); }
}

}  // namespace drl

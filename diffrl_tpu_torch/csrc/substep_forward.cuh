// One cached articulation substep per env, a team of T threads per env.
//
// Replaces the TPU kernel substep_forward_batched
// (diffrl_tpu/sim/pallas_substep.py), whose traced body is
// articulation_substep(..., mass_cache=(Hinv, Hinv)): fk -> inverse
// dynamics -> ground contacts -> muscles -> tau -> qdd = Hinv tau ->
// semi-implicit integrate, for every joint type (free, ball, revolute,
// prismatic, fixed) and for muscle-tendon units. The plain PyTorch version
// of the same function is
// diffrl_tpu_torch/sim/articulation_lb.py:substep_lb; every formula below
// mirrors its env-minor counterpart there, in the same operation order.
//
// What bounds it: per env the kernel reads q [C], qd [D], joint_act [D],
// the muscle activations [M] and Hinv [D*D] once and writes q' [C], qd' [D]
// once (Ant: 268 floats); the arithmetic is a few thousand flops (SNU's 198
// muscle segments add about 25,000), so the card's memory rate is the
// bound. What the design does about it on Hopper:
// - a team of T lanes per env, inside one warp (T = DRL_T from the
//   generated header), so that a batch of a few thousand envs still gives
//   every SM several warps. The lanes split the work that is independent
//   inside one env: the links of one level of the tree, the ground
//   contacts, the rows of Hinv x. A __syncwarp() separates dependent
//   phases;
// - every per-env intermediate (link frames, twists, accelerations,
//   wrenches, motion subspaces, tau, qdd) lives in shared memory, one slot
//   of kFwdEnvWords floats per env (an odd count, so the lanes of a warp
//   that read the same field of four envs hit different banks). A lane
//   keeps only the values of its current link or contact in registers, so
//   nothing spills;
// - the block's threads stage every [k, E] array through shared memory,
//   consecutive threads on consecutive envs, so global loads and stores
//   stay coalesced. The loads are asynchronous (cp.async) in two groups:
//   what the kinematics read first (the constants, q, qd), then the rest
//   (Hinv, joint_act), which lands while the kinematics run;
// - every sum is taken by one lane in a fixed order (a link's contacts in
//   contact order, its muscle segment ends in the plain version's order,
//   its children in descending row order, as the one-thread sweep took
//   them): no atomics, and two launches give the same bits;
// - muscles keep nothing in the slot: a link's lane recomputes each
//   segment that ends on it from the two link frames, reading the
//   activation and the segment's points and tables through the read-only
//   path from global memory (SNU's 198 segments would not fit the adjoint
//   kernel's shared memory, which the forward's layout is part of).
//
// Each phase is a function of (env slot, lane); the kernel runs the phases
// of all its envs in order through DRL_FOR_EACH_THREAD, which on the card
// is the thread itself. A host build (g++, with the CUDA qualifiers, the
// syncs and DRL_FOR_EACH_THREAD defined for the host) runs every thread of
// a block through one phase before the next, so the arithmetic and the
// lane-to-work map are checked where no GPU is present
// (tests/test_torch_substep.py).
//
// Compile-time model: substep_topology.h (generated per model topology by
// diffrl_tpu_torch/sim/substep_kernels.py:kernel_tables) defines the sizes,
// the team size, the level spans of the processing order (parents before
// children) and the per-link int tables. The float constants (joint
// frames, inertias, gains, contact points and materials, muscle points)
// come in one packed buffer laid out by the offsets below. Each block
// copies the int tables and the constants up to the muscle points into
// shared memory: the lanes of a team read them at different links. The
// muscle tables and points stay in global memory.
#pragma once

#include "substep_topology.h"

#ifndef DRL_FOR_EACH_THREAD
// runs the body once, as this thread of the block
#define DRL_FOR_EACH_THREAD(t) \
  for (int t = threadIdx.x, t##_end = t + 1; t < t##_end; ++t)
// an asynchronous 4-byte copy from global to shared memory (cp.async, no
// register round trip, so all of a thread's copies are in flight at once);
// the end of a group of copies; the wait for all but the last group, and
// for all of this thread's copies
#define DRL_COPY_TO_SHARED(dst, src)                               \
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"( \
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))), \
               "l"(src))
#define DRL_COPY_COMMIT() asm volatile("cp.async.commit_group;\n" ::)
#define DRL_COPY_WAIT_PRIOR() asm volatile("cp.async.wait_group 1;\n" ::)
#define DRL_COPY_WAIT() asm volatile("cp.async.wait_all;\n" ::)
#endif
#ifndef DRL_LDG
// a load through the read-only data cache
#define DRL_LDG(p) __ldg(p)
#endif

namespace drl {

constexpr int kPrismatic = 0;
constexpr int kRevolute = 1;
constexpr int kBall = 2;
constexpr int kFixed = 3;
constexpr int kFree = 4;

constexpr int NL = DRL_NL;  // links
constexpr int NC = DRL_NC;  // coords
constexpr int ND = DRL_ND;  // dofs
constexpr int NK = DRL_NK;  // ground contacts
constexpr int NLEV = DRL_NLEV;  // levels of the tree
constexpr int NS = DRL_NS;  // motion-subspace columns (with a ball joint in
                            // the model 1 per scalar joint and 3 per ball
                            // joint, free and fixed joints none; else 1 per
                            // link)
constexpr int NM = DRL_NM;  // muscles
constexpr int NSEG = DRL_NSEG;  // muscle segments between two links
// bit t set when the model has a joint of type t: the branches of the
// types it lacks compile away
constexpr int kJointTypes = DRL_JOINT_TYPES;

constexpr int T = DRL_T;  // threads per env (one team)
constexpr int kBlockThreads = DRL_BLOCK_THREADS;
constexpr int kEnvsPerBlock = kBlockThreads / T;
static_assert(T >= 1 && T <= 32 && 32 % T == 0,
              "a team of threads must lie inside one warp");
static_assert(kBlockThreads % 32 == 0 && kBlockThreads % T == 0,
              "a block holds whole warps and whole teams");

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
// the constants each block copies into shared memory
constexpr int kSmemConstCount = kContact0 + NK * kContactStride;
// per muscle segment k at kSeg0 + k * kSegStride, read from global memory:
// its first point in the frame of its first link [3], its second point in
// the frame of its second link [3]
constexpr int kSeg0 = kSmemConstCount;
constexpr int kSegStride = 6;
constexpr int kConstCount = kSeg0 + NSEG * kSegStride;

// The topology's int tables, indexed by the lane's link or contact (a
// runtime value): children of link r are child(child_start(r) ..
// child_start(r + 1) - 1), in descending row order; its contacts are
// link_contact(link_contact_start(r) .. link_contact_start(r + 1) - 1), in
// ascending contact order; level lv spans rows level_start(lv) ..
// level_start(lv + 1) - 1. The block copies them from constant memory into
// shared memory once (copy_tables): the lanes of a team read different
// links, which constant memory would serve one address at a time.
constexpr int kNChild = DRL_NCHILD;  // links with a parent
struct Tables {
  int type[NL], parent[NL], qstart[NL], dstart[NL];  // parent -1 for roots
  int sstart[NL];  // first motion-subspace column
  int contact_row[NK > 0 ? NK : 1];
  int child_start[NL + 1], children[kNChild > 0 ? kNChild : 1];
  int link_contact_start[NL + 1], link_contacts[NK > 0 ? NK : 1];
  int level_start[NLEV + 1];
};
__constant__ Tables kTables = {
    DRL_TYPE,        DRL_PARENT,       DRL_QSTART,
    DRL_DSTART,      DRL_SSTART,       DRL_CONTACT_ROW,
    DRL_CHILD_START, DRL_CHILDREN,     DRL_LINK_CONTACT_START,
    DRL_LINK_CONTACTS, DRL_LEVEL_START};
__shared__ Tables drl_tables;

// The muscle tables, in global memory (read with DRL_LDG, never written):
// segment k joins link rows seg_row0[k] and seg_row1[k] and belongs to
// muscle seg_m[k]; muscle m's segments are muscle_seg_start[m] ..
// muscle_seg_start[m + 1] - 1; link r's segment ends are
// link_ends[link_end_start[r] .. link_end_start[r + 1] - 1], each 2 k + side
// (side 0: the segment's first point, whose link takes -[p x f, f]; side 1:
// its second, +[p x f, f]), all of side 0 first, each side in segment
// order: the order in which the plain version's two index_add_ calls sum
// them.
struct MuscleTables {
  int seg_row0[NSEG > 0 ? NSEG : 1], seg_row1[NSEG > 0 ? NSEG : 1];
  int seg_m[NSEG > 0 ? NSEG : 1];
  int muscle_seg_start[NM + 1];
  int link_end_start[NL + 1], link_ends[NSEG > 0 ? 2 * NSEG : 1];
};
__device__ MuscleTables kMuscleTables = {
    DRL_SEG_ROW0, DRL_SEG_ROW1, DRL_SEG_M, DRL_MUSCLE_SEG_START,
    DRL_LINK_END_START, DRL_LINK_ENDS};

__device__ __forceinline__ int link_type(int r) { return drl_tables.type[r]; }
__device__ __forceinline__ int link_parent(int r) {
  return drl_tables.parent[r];
}
__device__ __forceinline__ int link_qstart(int r) {
  return drl_tables.qstart[r];
}
__device__ __forceinline__ int link_dstart(int r) {
  return drl_tables.dstart[r];
}
// link r's first motion-subspace column: r itself in a model without a
// ball joint (one column per link, no table read), else from the table
constexpr bool kColumnPerLink = !((kJointTypes >> kBall) & 1);
__device__ __forceinline__ int link_sstart(int r) {
  return kColumnPerLink ? r : drl_tables.sstart[r];
}
// whether a link's joint type ty is t (false at compile time when the
// model has no joint of type t)
__device__ __forceinline__ bool is_type(int ty, int t) {
  return ((kJointTypes >> t) & 1) && ty == t;
}
// motion-subspace columns of a joint type, and the most any has
__device__ __forceinline__ int subspace_cols(int ty) {
  if (is_type(ty, kBall)) return 3;
  return is_type(ty, kFree) || is_type(ty, kFixed) ? 0 : 1;
}
constexpr int kMaxCols = (kJointTypes >> kBall) & 1 ? 3 : 1;
__device__ __forceinline__ int contact_row(int k) {
  return drl_tables.contact_row[k];
}
__device__ __forceinline__ int child_start(int r) {
  return drl_tables.child_start[r];
}
__device__ __forceinline__ int child(int i) { return drl_tables.children[i]; }
__device__ __forceinline__ int link_contact_start(int r) {
  return drl_tables.link_contact_start[r];
}
__device__ __forceinline__ int link_contact(int i) {
  return drl_tables.link_contacts[i];
}
__device__ __forceinline__ int level_start(int lv) {
  return drl_tables.level_start[lv];
}

// One env's slot in shared memory, in floats. K1 uses these fields; K2
// (substep_vjp.cuh) appends its adjoints after fw::end.
namespace fw {
constexpr int q = 0;             // [NC], integrated in place
constexpr int qd = q + NC;       // [ND], integrated in place
constexpr int ja = qd + ND;      // joint_act [ND]
constexpr int hinv = ja + ND;    // [ND][ND]; K2 writes dH over it
constexpr int X = hinv + ND * ND;  // link frames in space [NL][7]
constexpr int vel = X + 7 * NL;  // spatial twists [NL][6]
constexpr int acc = vel + 6 * NL;  // velocity-product accelerations
constexpr int frc = acc + 6 * NL;  // body wrenches, then subtree sums
constexpr int S = frc + 6 * NL;  // motion-subspace columns [NS][6]
constexpr int cw = S + 6 * NS;   // contact wrenches [NK][6]
constexpr int tau = cw + 6 * NK;  // [ND]
constexpr int qdd = tau + ND;    // [ND]
constexpr int end = qdd + ND;
}  // namespace fw

constexpr int odd_words(int n) { return n % 2 ? n : n + 1; }
constexpr int kFwdEnvWords = odd_words(fw::end);
static_assert(kFwdEnvWords == DRL_FWD_ENV_WORDS,
              "the forward slot differs from kernel_tables' layout");

// dynamic shared memory: kEnvsPerBlock env slots of W floats, then the
// packed constant buffer (kConstCount floats), which the lanes of a team
// read at different links: from shared memory that costs one access where
// from global memory each load would touch one cache line per link
extern __shared__ float drl_smem[];

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

__device__ __forceinline__ SV load_sv(const float* p) {
  return {{p[0], p[1], p[2]}, {p[3], p[4], p[5]}};
}
__device__ __forceinline__ void store_sv(float* p, SV x) {
  p[0] = x.w.x;
  p[1] = x.w.y;
  p[2] = x.w.z;
  p[3] = x.v.x;
  p[4] = x.v.y;
  p[5] = x.v.z;
}
__device__ __forceinline__ void store_xform(float* p, Xform x) {
  p[0] = x.p.x;
  p[1] = x.p.y;
  p[2] = x.p.z;
  p[3] = x.q.x;
  p[4] = x.q.y;
  p[5] = x.q.z;
  p[6] = x.q.w;
}

// ---- block-wide I/O: rows [0, R) of a [R, E] array to or from field `off`
// of every env slot of the block; consecutive threads take consecutive envs
// (coalesced), and a slot past E touches no global memory. The loads are
// asynchronous: a wait (DRL_COPY_WAIT...) and a __syncthreads() come before
// their first reader.
template <int W>
__device__ __forceinline__ void load_rows(const float* __restrict__ g, int R,
                                          int off, int e0, int E, int t) {
  for (int i = t; i < R * kEnvsPerBlock; i += kBlockThreads) {
    const int r = i / kEnvsPerBlock, j = i % kEnvsPerBlock;
    if (e0 + j < E) DRL_COPY_TO_SHARED(&drl_smem[j * W + off + r],
                                       &g[r * E + e0 + j]);
  }
}
template <int W>
__device__ __forceinline__ void store_rows(float* __restrict__ g, int R,
                                           int off, int e0, int E, int t) {
#pragma unroll 4
  for (int i = t; i < R * kEnvsPerBlock; i += kBlockThreads) {
    const int r = i / kEnvsPerBlock, j = i % kEnvsPerBlock;
    if (e0 + j < E) g[r * E + e0 + j] = drl_smem[j * W + off + r];
  }
}

// Copies the packed constant buffer up to the muscle points after the
// block's W-float env slots; returns where it lands. Asynchronous, as
// load_rows.
template <int W>
__device__ __forceinline__ const float* load_consts(const float* __restrict__ g,
                                                    int t) {
  float* dst = drl_smem + kEnvsPerBlock * W;
  for (int i = t; i < kSmemConstCount; i += kBlockThreads)
    DRL_COPY_TO_SHARED(&dst[i], &g[i]);
  return dst;
}

// Copies the int tables into shared memory (before the block's first
// __syncthreads()).
__device__ __forceinline__ void copy_tables(int t) {
  const int* src = reinterpret_cast<const int*>(&kTables);
  int* dst = reinterpret_cast<int*>(&drl_tables);
  for (int i = t; i < static_cast<int>(sizeof(Tables) / sizeof(int));
       i += kBlockThreads)
    dst[i] = src[i];
}

// The env slot of thread t (its lane is t % T), or nullptr where the env
// does not exist (nenv envs in this block): the lanes of a partial block do
// nothing.
template <int W>
__device__ __forceinline__ float* env_slot(int t, int nenv) {
  return t / T < nenv ? drl_smem + (t / T) * W : nullptr;
}

// ---- the phases of one cached substep, shared by the forward kernel below
// and the adjoint kernel (substep_vjp.cuh), which recomputes the forward to
// get its linearization point. s is the env's slot.

// column k of a joint's motion subspace in space, from its joint frame
// X_sj: a ball joint's k-th axis, or the joint axis of a scalar joint;
// angular {w, p x w} (revolute, ball) or linear {0, w} (prismatic), with
// w = qrot(X_sj.q, axis)
__device__ __forceinline__ V3 subspace_axis(int ty, V3 axis, int k) {
  if (!is_type(ty, kBall)) return axis;
  return {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f, k == 2 ? 1.0f : 0.0f};
}
__device__ __forceinline__ SV subspace_col(int ty, Xform X_sj, V3 axis,
                                           int k) {
  const V3 w = qrot(X_sj.q, subspace_axis(ty, axis, k));
  if (is_type(ty, kPrismatic)) return {{0.0f, 0.0f, 0.0f}, w};
  return {w, cross(X_sj.p, w)};
}

// joint transform X_jc of link r from its coordinates
__device__ __forceinline__ Xform joint_xform(int ty, V3 axis, const float* qv) {
  Xform X_jc = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f}};  // fixed
  if (is_type(ty, kPrismatic)) {
    X_jc.p = axis * qv[0];
  } else if (is_type(ty, kRevolute)) {
    const float half = qv[0] * 0.5f;
    const V3 sn = axis * sinf(half);
    X_jc.q = {sn.x, sn.y, sn.z, cosf(half)};
  } else if (is_type(ty, kBall)) {
    X_jc.q = {qv[0], qv[1], qv[2], qv[3]};
  } else if (is_type(ty, kFree) || !((kJointTypes >> kFixed) & 1)) {
    // (without fixed joints the last type left is free)
    X_jc = {{qv[0], qv[1], qv[2]}, {qv[3], qv[4], qv[5], qv[6]}};
  }
  return X_jc;
}

// fk, motion subspace, twist and velocity-product acceleration of link r;
// its parent's are final (the sweep goes level by level)
__device__ __forceinline__ void link_kinematics(const float* P, float* s,
                                                int r) {
  const Xform kIdentity = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f}};
  const float* c = P + r * kLinkStride;
  const int ty = link_type(r);
  const int pr = link_parent(r);
  const float* qv = s + fw::q + link_qstart(r);
  const float* qdv = s + fw::qd + link_dstart(r);
  const Xform X_pj = load_xform(c + kXpj);
  const V3 axis = load3(c + kAxis);

  const Xform X_local = tmul(X_pj, joint_xform(ty, axis, qv));
  Xform X_sc, X_sj;
  if (pr < 0) {
    X_sc = X_local;
    X_sj = tmul(kIdentity, X_pj);
  } else {
    const Xform X_p = load_xform(s + fw::X + 7 * pr);
    X_sc = tmul(X_p, X_local);
    X_sj = tmul(X_p, X_pj);
  }
  store_xform(s + fw::X + 7 * r, X_sc);

  // v_j = sum_k S_k qd_k; free: S is the identity; fixed: no column
  SV v_j = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (is_type(ty, kFree)) {
    v_j = {{qdv[0], qdv[1], qdv[2]}, {qdv[3], qdv[4], qdv[5]}};
  } else {
    float* S = s + fw::S + 6 * link_sstart(r);
    const int ncol = subspace_cols(ty);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k >= ncol) break;
      const SV Sk = subspace_col(ty, X_sj, axis, k);
      store_sv(S + 6 * k, Sk);
      v_j = k == 0 ? Sk * qdv[0] : v_j + Sk * qdv[k];
    }
  }
  SV vel, acc;
  if (pr < 0) {
    vel = v_j;
    acc = scross(v_j, v_j);
  } else {
    vel = load_sv(s + fw::vel + 6 * pr) + v_j;
    acc = load_sv(s + fw::acc + 6 * pr) + scross(vel, v_j);
  }
  store_sv(s + fw::vel + 6 * r, vel);
  store_sv(s + fw::acc + 6 * r, acc);
}

// body wrench of link r: inertial + bias - gravity
__device__ __forceinline__ void body_wrench(const float* P, float* s, int r) {
  const float* c = P + r * kLinkStride;
  const Xform X_sm = tmul(load_xform(s + fw::X + 7 * r), load_xform(c + kXcm));
  const SV vel = load_sv(s + fw::vel + 6 * r);
  const float m = c[kMass];
  const V3 gm = load3(P + kGravity) * m;
  const SV f_g = {cross(X_sm.p, gm), gm};
  const SV Ia = inertia_matvec(X_sm, c + kI3, m, load_sv(s + fw::acc + 6 * r));
  const SV Iv = inertia_matvec(X_sm, c + kI3, m, vel);
  store_sv(s + fw::frc + 6 * r, Ia + scross_dual(vel, Iv) - f_g);
}

// ground contact k: penalty normal force, damping and clamped friction; its
// wrench on its link (0 above the ground) goes to its own cw slot
__device__ __forceinline__ void contact_wrench(const float* P, float* s,
                                               int k) {
  const float* cc = P + kContact0 + k * kContactStride;
  const int row = contact_row(k);
  const float dist = cc[3], ke = cc[4], kd = cc[5], kf = cc[6], mu = cc[7];
  const SV v6 = load_sv(s + fw::vel + 6 * row);
  V3 p = tpoint(load_xform(s + fw::X + 7 * row), load3(cc));
  p = {p.x - 0.0f * dist, p.y - 1.0f * dist, p.z - 0.0f * dist};
  const V3 dpdt = v6.v + cross(v6.w, p);
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
  store_sv(s + fw::cw + 6 * k, SV{cross(p, f_total), f_total});
}

// Muscle segment k at the link frames of the slot: its end points in space
// and its force f = safe_normalize(pos1 - pos0) act on link seg_row1(k) (the
// reverse on seg_row0(k)); act is its muscle's activation, read at
// ma[m * E] (ma already offset to the env). Also returns the direction's
// pieces that the adjoint needs: d = pos1 - pos0 and inv = 1 / |d| (0
// below the guard |d|^2 <= 1e-12, where the direction is 0).
struct Segment {
  V3 pos0, pos1, d, f;
  float inv, act;
};
__device__ __forceinline__ Segment muscle_segment(const float* __restrict__ G,
                                                  const float* s,
                                                  const float* __restrict__ ma,
                                                  int E, int k) {
  const MuscleTables& mt = kMuscleTables;
  const float* pts = G + kSeg0 + k * kSegStride;
  const V3 r0 = {DRL_LDG(pts), DRL_LDG(pts + 1), DRL_LDG(pts + 2)};
  const V3 r1 = {DRL_LDG(pts + 3), DRL_LDG(pts + 4), DRL_LDG(pts + 5)};
  Segment g;
  g.pos0 = tpoint(load_xform(s + fw::X + 7 * DRL_LDG(&mt.seg_row0[k])), r0);
  g.pos1 = tpoint(load_xform(s + fw::X + 7 * DRL_LDG(&mt.seg_row1[k])), r1);
  g.d = g.pos1 - g.pos0;
  const float l2 = dot(g.d, g.d);
  const bool safe = l2 > 1.0e-12f;
  g.inv = safe ? 1.0f / sqrtf(l2) : 0.0f;
  g.act = DRL_LDG(ma + DRL_LDG(&mt.seg_m[k]) * E);
  g.f = (g.d * g.inv) * g.act;
  return g;
}

// the muscle wrench on link r: the sum over its segment ends, in the plain
// version's order (every first end, then every second end, each in segment
// order), of -[pos0 x f, f] at a first end and +[pos1 x f, f] at a second
__device__ __forceinline__ SV muscle_wrench(const float* __restrict__ G,
                                            const float* s,
                                            const float* __restrict__ ma,
                                            int E, int r) {
  const MuscleTables& mt = kMuscleTables;
  SV w = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  const int i1 = DRL_LDG(&mt.link_end_start[r + 1]);
  for (int i = DRL_LDG(&mt.link_end_start[r]); i < i1; ++i) {
    const int end = DRL_LDG(&mt.link_ends[i]);
    const Segment g = muscle_segment(G, s, ma, E, end >> 1);
    if (end & 1) {
      w = w + SV{cross(g.pos1, g.f), g.f};
    } else {
      w = w - SV{cross(g.pos0, g.f), g.f};
    }
  }
  return w;
}

// subtree wrench of link r: its body wrench plus its contacts' (summed in
// contact order, the plain version's index_add_) plus its muscles' plus its
// children's subtree wrenches, final since their level ran first
__device__ __forceinline__ void subtree_wrench(const float* __restrict__ G,
                                               float* s,
                                               const float* __restrict__ ma,
                                               int E, int r) {
  SV f = load_sv(s + fw::frc + 6 * r);
  if (NK > 0) {
    SV cf = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    for (int i = link_contact_start(r); i < link_contact_start(r + 1); ++i)
      cf = cf + load_sv(s + fw::cw + 6 * link_contact(i));
    f = f + cf;
  }
  if (NSEG > 0) f = f + muscle_wrench(G, s, ma, E, r);
  for (int i = child_start(r); i < child_start(r + 1); ++i)
    f = f + load_sv(s + fw::frc + 6 * child(i));
  store_sv(s + fw::frc + 6 * r, f);
}

// joint-space torques of link r from its subtree wrench, gains, limits and
// actuation (a fixed joint has none)
__device__ __forceinline__ void link_torque(const float* P, float* s, int r) {
  const float* c = P + r * kLinkStride;
  const int ty = link_type(r);
  const int qs = link_qstart(r);
  const int ds = link_dstart(r);
  const SV frc = load_sv(s + fw::frc + 6 * r);
  float* tau = s + fw::tau + ds;
  if (is_type(ty, kFree)) {
    tau[0] = -frc.w.x;
    tau[1] = -frc.w.y;
    tau[2] = -frc.w.z;
    tau[3] = -frc.v.x;
    tau[4] = -frc.v.y;
    tau[5] = -frc.v.z;
  } else if (is_type(ty, kBall)) {
    // -S_k f - kd qd_k - ke q_k on the quaternion's vector part; no
    // actuation and no limits
    const float* S = s + fw::S + 6 * link_sstart(r);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tau[k] = -dot(load_sv(S + 6 * k), frc) -
               c[kTargetKd] * s[fw::qd + ds + k] -
               c[kTargetKe] * s[fw::q + qs + k];
  } else if (!is_type(ty, kFixed)) {  // revolute / prismatic
    const float Sf = dot(load_sv(s + fw::S + 6 * link_sstart(r)), frc);
    const float qj = s[fw::q + qs];
    const float qdj = s[fw::qd + ds];
    const float lower = c[kLower], upper = c[kUpper], l_ke = c[kLimitKe];
    const float limit_f = qj < lower   ? l_ke * (lower - qj)
                          : qj > upper ? l_ke * (upper - qj)
                                       : 0.0f;
    const float damping_f = -c[kLimitKd] * qdj;
    tau[0] = -Sf - c[kTargetKe] * (qj - c[kTarget]) - c[kTargetKd] * qdj +
             s[fw::ja + ds] + limit_f + damping_f;
  }
}

// row i of y = Hinv x, with the frozen inverse from the last refresh
// substep (row-major [ND][ND] in the slot)
__device__ __forceinline__ void hinv_row(const float* s, const float* x,
                                         float* y, int i) {
  const float* h = s + fw::hinv + i * ND;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < ND; ++j) acc += h[j] * x[j];
  y[i] = acc;
}

// semi-implicit integration of link r's coordinates, in place: each link
// reads and writes only its own (a fixed joint has none)
__device__ __forceinline__ void link_integrate(float* s, int r, float dt) {
  const int ty = link_type(r);
  float* qv = s + fw::q + link_qstart(r);
  float* qdv = s + fw::qd + link_dstart(r);
  const float* qdd = s + fw::qdd + link_dstart(r);
  if (is_type(ty, kFree) || is_type(ty, kBall)) {
    // the rotation: r' = normalize(r + 0.5 (w', 0) r dt); a free joint's
    // position by its spatial twist
    const int o = is_type(ty, kFree) ? 3 : 0;  // the quaternion in q
    const V3 w_s = V3{qdv[0], qdv[1], qdv[2]} + V3{qdd[0], qdd[1], qdd[2]} * dt;
    const Quat r_s = {qv[o], qv[o + 1], qv[o + 2], qv[o + 3]};
    const Quat dr = qmul(Quat{w_s.x, w_s.y, w_s.z, 0.0f}, r_s);
    const Quat r_n = qnormalize({r_s.x + dr.x * 0.5f * dt,
                                 r_s.y + dr.y * 0.5f * dt,
                                 r_s.z + dr.z * 0.5f * dt,
                                 r_s.w + dr.w * 0.5f * dt});
    if (is_type(ty, kFree)) {
      const V3 v_s =
          V3{qdv[3], qdv[4], qdv[5]} + V3{qdd[3], qdd[4], qdd[5]} * dt;
      const V3 p_s = {qv[0], qv[1], qv[2]};
      const V3 p_n = p_s + (v_s + cross(w_s, p_s)) * dt;
      store_xform(qv, Xform{p_n, r_n});
      store_sv(qdv, SV{w_s, v_s});
    } else {
      qv[0] = r_n.x;
      qv[1] = r_n.y;
      qv[2] = r_n.z;
      qv[3] = r_n.w;
      qdv[0] = w_s.x;
      qdv[1] = w_s.y;
      qdv[2] = w_s.z;
    }
  } else if (!is_type(ty, kFixed)) {  // revolute / prismatic
    const float qd_n = qdv[0] + qdd[0] * dt;
    qv[0] = qv[0] + qd_n * dt;
    qdv[0] = qd_n;
  }
}

// The forward up to qdd, for the nenv envs of the block: fk and twists
// level by level; body and contact wrenches; subtree sums from the deepest
// level up, each link's torque as soon as its subtree wrench is final;
// qdd = Hinv tau. The block's first group of copies (constants, q, qd) has
// landed; the second (joint_act, Hinv and what else the kernel reads
// later) lands while the wrenches run. G is the constant buffer in global
// memory (the muscle points), ma the muscle activations [NM, E] (unused
// without muscles), e0 the block's first env.
template <int W>
__device__ __forceinline__ void forward_phases(const float* P,
                                               const float* __restrict__ G,
                                               const float* __restrict__ ma,
                                               int e0, int E, int nenv) {
#pragma unroll 1
  for (int lv = 0; lv < NLEV; ++lv) {
    DRL_FOR_EACH_THREAD(t) {
      if (float* s = env_slot<W>(t, nenv)) {
        for (int r = level_start(lv) + t % T; r < level_start(lv + 1);
             r += T)
          link_kinematics(P, s, r);
      }
    }
    __syncwarp();
  }
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int r = t % T; r < NL; r += T) body_wrench(P, s, r);
      for (int k = t % T; k < NK; k += T) contact_wrench(P, s, k);
    }
    DRL_COPY_WAIT();
  }
  __syncthreads();
#pragma unroll 1
  for (int lv = NLEV - 1; lv >= 0; --lv) {
    DRL_FOR_EACH_THREAD(t) {
      if (float* s = env_slot<W>(t, nenv)) {
        for (int r = level_start(lv) + t % T; r < level_start(lv + 1);
             r += T) {
          subtree_wrench(G, s, NM > 0 ? ma + e0 + t / T : ma, E, r);
          link_torque(P, s, r);
        }
      }
    }
    __syncwarp();
  }
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int i = t % T; i < ND; i += T)
        hinv_row(s, s + fw::tau, s + fw::qdd, i);
    }
  }
  __syncwarp();
}

// q [NC, E], qd / joint_act [ND, E], ma [NM, E] (muscle activations; may
// be null without muscles), hinv [ND, ND, E] (row i, column j at
// (i * ND + j) * E + e); outputs q_out [NC, E], qd_out [ND, E]. Block b
// takes envs [b * kEnvsPerBlock, ...) with kFwdEnvWords floats of dynamic
// shared memory each, and a copy of the constant buffer.
__global__ void __launch_bounds__(kBlockThreads) substep_forward_kernel(
    const float* __restrict__ q, const float* __restrict__ qd,
    const float* __restrict__ joint_act, const float* __restrict__ ma,
    const float* __restrict__ hinv, const float* __restrict__ consts,
    float* __restrict__ q_out, float* __restrict__ qd_out, int E, float dt) {
  constexpr int W = kFwdEnvWords;
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
    DRL_COPY_COMMIT();
    copy_tables(t);
    DRL_COPY_WAIT_PRIOR();
  }
  __syncthreads();
  forward_phases<W>(P, consts, ma, e0, E, nenv);
  DRL_FOR_EACH_THREAD(t) {
    if (float* s = env_slot<W>(t, nenv)) {
      for (int r = t % T; r < NL; r += T) link_integrate(s, r, dt);
    }
  }
  __syncthreads();
  DRL_FOR_EACH_THREAD(t) {
    store_rows<W>(q_out, NC, fw::q, e0, E, t);
    store_rows<W>(qd_out, ND, fw::qd, e0, E, t);
  }
}

}  // namespace drl

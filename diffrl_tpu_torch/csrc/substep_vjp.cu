// Host entry points of the cached-substep adjoint kernel, with a plain C
// interface (loaded with ctypes by diffrl_tpu_torch/_build.py). The kernel
// itself is in substep_vjp.cuh.
#include <cuda_runtime.h>

#include "kernel_host.cuh"
#include "substep_vjp.cuh"

namespace {
// kEnvsPerBlock env slots and the constants per block (Ant: 16 envs of 8
// threads, 102.6 KB, so two blocks share an SM)
constexpr int kSmemBytes =
    (drl::kEnvsPerBlock * drl::kVjpEnvWords + drl::kConstCount) *
    static_cast<int>(sizeof(float));
static_assert(kSmemBytes + sizeof(drl::Tables) <= 232448,
              "more shared memory than a block has");
}  // namespace

extern "C" {

// Size of the packed constant buffer this build expects, in floats.
int drl_substep_vjp_const_count() { return drl::kConstCount; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
int drl_substep_vjp(const float* q, const float* qd, const float* joint_act,
                    const float* hinv, const float* gq, const float* gqd,
                    const float* consts, float* dq, float* dqd, float* dja,
                    float* dh, int E, float dt, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = drl::allow_smem(drl::substep_vjp_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (E + drl::kEnvsPerBlock - 1) / drl::kEnvsPerBlock;
  drl::substep_vjp_kernel<<<blocks, drl::kBlockThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      q, qd, joint_act, hinv, gq, gqd, consts, dq, dqd, dja, dh, E, dt);
  return static_cast<int>(cudaGetLastError());
}

// out[0..6] as drl::kernel_attributes (kernel_host.cuh) says; returns the
// cudaError_t.
int drl_substep_vjp_attributes(int* out) {
  return drl::kernel_attributes(drl::substep_vjp_kernel, kSmemBytes, out);
}

}  // extern "C"

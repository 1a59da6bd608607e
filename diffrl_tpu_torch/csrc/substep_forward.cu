// Host entry points of the cached-substep forward kernel, with a plain C
// interface (loaded with ctypes by diffrl_tpu_torch/_build.py). The kernel
// itself is in substep_forward.cuh.
#include <cuda_runtime.h>

#include "kernel_host.cuh"
#include "substep_forward.cuh"

namespace {
// kEnvsPerBlock env slots and the constants per block (Ant: 16 envs of 8
// threads, 46.6 KB)
constexpr int kSmemBytes =
    (drl::kEnvsPerBlock * drl::kFwdEnvWords + drl::kConstCount) *
    static_cast<int>(sizeof(float));
static_assert(kSmemBytes + sizeof(drl::Tables) <= 232448,
              "more shared memory than a block has");
}  // namespace

extern "C" {

// Size of the packed constant buffer this build expects, in floats.
int drl_substep_forward_const_count() { return drl::kConstCount; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
int drl_substep_forward(const float* q, const float* qd, const float* joint_act,
                        const float* hinv, const float* consts, float* q_out,
                        float* qd_out, int E, float dt, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = drl::allow_smem(drl::substep_forward_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (E + drl::kEnvsPerBlock - 1) / drl::kEnvsPerBlock;
  drl::substep_forward_kernel<<<blocks, drl::kBlockThreads, kSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(
      q, qd, joint_act, hinv, consts, q_out, qd_out, E, dt);
  return static_cast<int>(cudaGetLastError());
}

// out[0..6] as drl::kernel_attributes (kernel_host.cuh) says; returns the
// cudaError_t.
int drl_substep_forward_attributes(int* out) {
  return drl::kernel_attributes(drl::substep_forward_kernel, kSmemBytes, out);
}

}  // extern "C"

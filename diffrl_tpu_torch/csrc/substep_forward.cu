// Host entry points of the cached-substep forward kernel, with a plain C
// interface (loaded with ctypes by diffrl_tpu_torch/_build.py). The kernel
// itself is in substep_forward.cuh.
#include <cuda_runtime.h>

#include "substep_forward.cuh"

namespace {
// One warp per block: at the main path's E = 4096 that gives 128 blocks, so
// nearly every one of the H100's 132 SMs runs one warp of envs.
constexpr int kThreads = 32;
}  // namespace

extern "C" {

// Size of the packed constant buffer this build expects, in floats.
int drl_substep_forward_const_count() { return drl::kConstCount; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
int drl_substep_forward(const float* q, const float* qd, const float* joint_act,
                        const float* hinv, const float* consts, float* q_out,
                        float* qd_out, int E, float dt, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (E + kThreads - 1) / kThreads;
  drl::substep_forward_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      q, qd, joint_act, hinv, consts, q_out, qd_out, E, dt);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill + stack) bytes per thread of the
// kernel as loaded on the current device; returns the cudaError_t.
int drl_substep_forward_attributes(int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, drl::substep_forward_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"

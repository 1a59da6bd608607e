// Host-side helpers of the kernels' C entry points (substep_forward.cu,
// substep_vjp.cu): the dynamic shared-memory opt-in and the attribute and
// occupancy query.
#pragma once

#include <cuda_runtime.h>

#include "substep_forward.cuh"

namespace drl {

// Lets `kernel` take `smem` bytes of dynamic shared memory. A kernel whose
// static and dynamic shared memory together pass 48 KB has to opt in; the
// static part (the int tables) is not counted in `smem`, so every kernel
// opts in. Returns the cudaError_t.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Fills out[0..6] for `kernel` as loaded on the current device: registers
// per thread, local (spill + stack) bytes per thread, threads per env, envs
// per block, dynamic shared-memory bytes per block, the most blocks
// resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// the device's SM count. Returns the cudaError_t.
template <class Kernel>
inline int kernel_attributes(Kernel kernel, int smem, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0, device = 0, sms = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kBlockThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = T;
  out[3] = kEnvsPerBlock;
  out[4] = smem;
  out[5] = blocks;
  out[6] = sms;
  return 0;
}

}  // namespace drl

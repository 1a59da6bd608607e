// Host entry points of the mass-matrix adjoint kernel, with a plain C
// interface (loaded with ctypes by diffrl_tpu_torch/_build.py). The kernel
// itself is in mass_matrix_vjp.cuh.
#include <cuda_runtime.h>

#include "kernel_host.cuh"
#include "mass_matrix_vjp.cuh"

namespace {
// kEnvsPerBlock env slots and the constants up to the muscle points per
// block (Ant: 16 envs of 8 threads, 54.2 KB, so four blocks share an SM)
constexpr int kSmemBytes =
    (drl::kEnvsPerBlock * drl::kMassEnvWords + drl::kSmemConstCount) *
    static_cast<int>(sizeof(float));
static_assert(kSmemBytes + sizeof(drl::Tables) + sizeof(drl::MassTables) <=
                  232448,
              "more shared memory than a block has");
}  // namespace

extern "C" {

// Size of the packed constant buffer this build expects, in floats (the
// muscle points included).
int drl_mass_matrix_vjp_const_count() { return drl::kConstCount; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// dq_out = dq_in + (dH/dq)^T gh.
int drl_mass_matrix_vjp(const float* q, const float* gh, const float* dq_in,
                        const float* consts, float* dq_out, int E,
                        void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = drl::allow_smem(drl::mass_matrix_vjp_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (E + drl::kEnvsPerBlock - 1) / drl::kEnvsPerBlock;
  drl::mass_matrix_vjp_kernel<<<blocks, drl::kBlockThreads, kSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(
      q, gh, dq_in, consts, dq_out, E);
  return static_cast<int>(cudaGetLastError());
}

// out[0..6] as drl::kernel_attributes (kernel_host.cuh) says; returns the
// cudaError_t.
int drl_mass_matrix_vjp_attributes(int* out) {
  return drl::kernel_attributes(drl::mass_matrix_vjp_kernel, kSmemBytes, out);
}

}  // extern "C"

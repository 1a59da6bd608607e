"""The substep kernels' CUDA sources compiled for the host with g++, so the
CPU tests check their arithmetic and lane-to-work map where no GPU is
present (tests/test_torch_substep.py, test_torch_grad.py and
test_torch_host_kernels.py).

The shim defines the CUDA qualifiers and syncs away and
``DRL_FOR_EACH_THREAD(t)`` as a loop over the block's threads, so every
lane of every team runs one phase before the next phase starts (on the card
each thread runs its own lane between syncs); ``cp.async``
(``DRL_COPY_*``) becomes a plain copy. The harness calls the kernel once
per block. This module imports no JAX.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from diffrl_tpu_torch.sim import substep_kernels as sk

CSRC = os.path.join(os.path.dirname(__file__), "..", "diffrl_tpu_torch",
                    "csrc")

SHIM = """
#include <math.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __constant__
#define __shared__
#define __syncwarp()
#define __syncthreads()
#define DRL_FOR_EACH_THREAD(t) for (int t = 0; t < (int)blockDim.x; ++t)
#define DRL_COPY_TO_SHARED(dst, src) (*(dst) = *(src))
#define DRL_COPY_COMMIT()
#define DRL_COPY_WAIT_PRIOR()
#define DRL_COPY_WAIT()
struct Dim3 { int x; };
static Dim3 blockIdx, blockDim, threadIdx;
"""

_HARNESS = {
    "substep_forward": """
#include "substep_forward.cuh"
namespace drl {
float drl_smem[kEnvsPerBlock * kFwdEnvWords + kConstCount];
}
extern "C" int const_count() { return drl::kConstCount; }
extern "C" void run(const float* q, const float* qd, const float* ja,
                    const float* hinv, const float* consts, float* q_out,
                    float* qd_out, int E, float dt) {
  blockDim.x = drl::kBlockThreads;
  for (int b = 0; b * drl::kEnvsPerBlock < E; ++b) {
    blockIdx.x = b;
    drl::substep_forward_kernel(q, qd, ja, hinv, consts, q_out, qd_out, E,
                                dt);
  }
}
""",
    "substep_vjp": """
#include "substep_vjp.cuh"
namespace drl {
float drl_smem[kEnvsPerBlock * kVjpEnvWords + kConstCount];
}
extern "C" int const_count() { return drl::kConstCount; }
extern "C" void run(const float* q, const float* qd, const float* ja,
                    const float* hinv, const float* gq, const float* gqd,
                    const float* consts, float* dq, float* dqd, float* dja,
                    float* dh, int E, float dt) {
  blockDim.x = drl::kBlockThreads;
  for (int b = 0; b * drl::kEnvsPerBlock < E; ++b) {
    blockIdx.x = b;
    drl::substep_vjp_kernel(q, qd, ja, hinv, gq, gqd, consts, dq, dqd, dja,
                            dh, E, dt);
  }
}
""",
}
# inputs (q, qd, joint_act, hinv[, gq, gqd]); outputs shaped like the first
# two or four inputs
_N_IN = {"substep_forward": 4, "substep_vjp": 6}
_N_OUT = {"substep_forward": 2, "substep_vjp": 4}


class HostKernel:
    """One kernel built for the host for one model: call it with env-minor
    float32 numpy inputs; returns the outputs as numpy arrays."""

    def __init__(self, name, so, consts):
        self.name, self.so, self.consts = name, so, consts

    def __call__(self, *inputs, dt):
        ins = [np.ascontiguousarray(x, dtype=np.float32) for x in inputs]
        assert len(ins) == _N_IN[self.name]
        outs = [np.zeros_like(x) for x in ins[:_N_OUT[self.name]]]
        E = ins[0].shape[-1]
        self.so.run(*(a.ctypes.data_as(ctypes.c_void_p)
                      for a in (*ins, self.consts, *outs)), E, dt)
        return outs


def build_host_kernel(model, name, tmp):
    """Compiles kernel ``name`` ("substep_forward" or "substep_vjp") for
    ``model`` with g++ in directory ``tmp``; skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    header, consts = sk.kernel_tables(model)
    (tmp / "substep_topology.h").write_text(header)
    (tmp / "shim.h").write_text(SHIM)
    (tmp / "harness.cpp").write_text(_HARNESS[name])
    lib = tmp / f"lib{name}_host.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-include", str(tmp / "shim.h"), f"-I{tmp}", f"-I{CSRC}",
         "-o", str(lib), str(tmp / "harness.cpp")],
        check=True, capture_output=True, text=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    n_ptr = _N_IN[name] + 1 + _N_OUT[name]
    so.run.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int,
                                                   ctypes.c_float]
    assert so.const_count() == consts.size
    return HostKernel(name, so, consts)

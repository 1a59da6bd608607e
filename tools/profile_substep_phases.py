#!/usr/bin/env python3
"""Where one block of each substep kernel (K1, K2) spends its cycles.

    python3 tools/profile_substep_phases.py

Needs one CUDA device. Copies the kernel sources into
build/phase_profile/csrc with a clock stamp after every __syncwarp() and
__syncthreads() of the two kernels (thread 0 of each block writes
clock64() and the sync's place to a device array), builds that copy for
Ant at the port's team size, runs each kernel on the settled 4096-env state
of chip_smoke.py's adjoint phase, and prints for each phase, in order, the
median over blocks of the SM cycles since the previous stamp, labelled by
the phase functions between the two syncs. The stamps add a few
instructions per phase; the kernels that the port runs are not changed.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import diffrl_tpu_torch.envs as envs  # noqa: E402
from diffrl_tpu_torch import _build  # noqa: E402
from diffrl_tpu_torch.sim import articulation_lb as lb  # noqa: E402
from diffrl_tpu_torch.sim import substep_kernels as sk  # noqa: E402

E = 4096
MAX_MARKS = 64
PHASES = ("load_rows", "link_kinematics", "body_wrench", "contact_wrench",
          "subtree_wrench", "link_torque", "hinv_row", "link_integrate",
          "link_integrate_adj", "link_torque_adj", "contact_adj",
          "body_wrench_adj", "link_reverse", "bw::aF")
_STAMPS = """
__device__ long long drl_stamp_clock[8192 * %(m)d];
__device__ int drl_stamp_id[8192 * %(m)d];
__shared__ int drl_stamp_n;
#define DRL_STAMP(id)                                                  \\
  do {                                                                 \\
    if (threadIdx.x == 0) {                                            \\
      drl_stamp_clock[blockIdx.x * %(m)d + drl_stamp_n] = clock64();    \\
      drl_stamp_id[blockIdx.x * %(m)d + drl_stamp_n] = (id);            \\
      ++drl_stamp_n;                                                   \\
    }                                                                  \\
  } while (0)
"""
_READ = """
int drl_read_stamps(long long* clocks, int* ids, int n) {
  cudaError_t err = cudaMemcpyFromSymbol(clocks, drl::drl_stamp_clock,
                                         n * sizeof(long long));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(ids, drl::drl_stamp_id, n * sizeof(int));
  return static_cast<int>(err);
}
}  // extern "C"
"""
# a stamp's id is the line of its sync plus this per file
_FILE_BASE = {"substep_forward.cuh": 0, "substep_vjp.cuh": 100000}


def instrument(dst: Path) -> dict:
    """Copy csrc/ to dst with the stamps; {stamp id: label}, the label
    naming the phase functions called since the previous stamp of the same
    function (or since the function's start)."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    labels = {}
    for name, base in _FILE_BASE.items():
        text = (dst / name).read_text()
        if name == "substep_forward.cuh":
            text = text.replace(
                "extern __shared__ float drl_smem[];",
                "extern __shared__ float drl_smem[];\n"
                + _STAMPS % {"m": MAX_MARKS})
        stamp = f"DRL_STAMP({base} + __LINE__);"
        text = text.replace(
            "  const int e0 = blockIdx.x * kEnvsPerBlock;\n",
            "  const int e0 = blockIdx.x * kEnvsPerBlock;\n"
            f"  if (threadIdx.x == 0) drl_stamp_n = 0;\n  {stamp}\n")
        text = re.sub(r"^( *)(__syncwarp\(\);|__syncthreads\(\);)$",
                      r"\1\2 " + stamp, text, flags=re.M)
        lines = text.split("\n")
        prev = 0
        for i, line in enumerate(lines, 1):
            if line.startswith(("__device__", "__global__", "template")):
                prev = i
            if stamp in line:
                seen = [p for p in PHASES
                        if any(p + "(" in ln or p + "<" in ln or
                               (p == "bw::aF" and p + " +" in ln)
                               for ln in lines[prev:i - 1])]
                labels[base + i] = "+".join(seen) or (
                    "kernel start" if "drl_stamp_n = 0" in lines[i - 2]
                    else "sync")
                prev = i
        (dst / name).write_text(text)
    for name in ("substep_forward.cu", "substep_vjp.cu"):
        path = dst / name
        path.write_text(path.read_text().replace('}  // extern "C"', _READ))
    return labels


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_substep_phases: CUDA is not available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    labels = instrument(ROOT / "build" / "phase_profile" / "csrc")
    _build.CSRC = ROOT / "build" / "phase_profile" / "csrc"
    env = envs.make("Ant", num_envs=E, seed=0, stochastic_init=True,
                    episode_length=1000, MM_caching_frequency=cs.MM,
                    device=dev)
    model = env.model
    names = ("substep_forward", "substep_vjp")
    libs = {}
    for n, b in zip(names, _build.build_all(
            [sk.kernel_source(model, n) for n in names])):
        sk._prepare(n, model, dev, b)
        libs[n] = b.lib
        libs[n].drl_read_stamps.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int]

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    s = cs.settled_state(env, cs.SETTLE_STEPS)
    acts = torch.rand((E, env.num_acts), generator=gen, device=dev) * 2 - 1
    jat = env.action_to_controls(acts)[0].T.contiguous()
    h = env.dt / env.sim_substeps
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    blocks = -(-E // sk.team_layout(model).envs_per_block)
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(model, q, qd, jat, None, h)
        gq = torch.randn(q1.shape, generator=gen, device=dev)
        gqd = torch.randn(qd1.shape, generator=gen, device=dev)
        runs = {
            "substep_forward": lambda: sk.substep_forward(
                model, q1, qd1, jat, None, h, H, Hinv),
            "substep_vjp": lambda: sk.substep_vjp(
                model, q1, qd1, jat, None, h, H, Hinv, gq, gqd)}
        for n in names:
            for _ in range(4):      # the last launch's stamps are read
                runs[n]()
            torch.cuda.synchronize()
            clocks = np.zeros((8192, MAX_MARKS), np.int64)
            ids = np.zeros((8192, MAX_MARKS), np.int32)
            err = libs[n].drl_read_stamps(clocks.ctypes.data,
                                          ids.ctypes.data, clocks.size)
            if err:
                raise RuntimeError(f"reading the stamps: cudaError {err}")
            clocks, ids = clocks[:blocks], ids[0]
            marks = int((clocks[0] != 0).sum())
            cyc = np.median(np.diff(clocks[:, :marks], axis=1), axis=0)
            total = float(np.median(clocks[:, marks - 1] - clocks[:, 0]))
            print(f"{n}: median SM cycles per phase over {blocks} blocks, "
                  f"{total:.0f} from the first stamp to the last | {card}")
            for k in range(1, marks):
                label = labels[int(ids[k])]
                print(f"  {k:2d} {label:<40s} {cyc[k - 1]:8.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

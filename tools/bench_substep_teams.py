#!/usr/bin/env python3
"""Device time of the substep kernels (K1, K2) at several team sizes.

    python3 tools/bench_substep_teams.py [--env NAME] [T ...]
                                          (default: Ant, 8 16)

Needs one CUDA device. Builds K1 and K2 for the env's model (any env of
chip_smoke.py's MODELS; SNU Humanoid's muscles at random activations) once
per team size T (threads per env;
``substep_kernels.team_layout``'s rule picks the one the port uses, and
here the generated header's DRL_T line is set to each T in turn; the
shared-memory slots do not depend on T), all nvcc processes together, and
on the settled 4096-env state of chip_smoke.py's adjoint phase for that env
checks each build against the plain versions and float64 by
``testing.check_kernel`` (K1 at q rtol 2e-5 atol 2e-6 and qd rtol 2e-5 atol
2e-5, K2 at rtol 2e-4 atol 1e-5, as chip_smoke.py)
and times one launch on the device (chip_smoke.device_ms,
median of 7 x 50 launches). The team sizes are timed in turns, forward and
back (8, 16, 16, 8), so that the card's drift falls on both. Prints, per T,
ptxas' registers and spills, the occupancy at E = 4096 and the times.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import diffrl_tpu_torch.envs as envs  # noqa: E402
from diffrl_tpu_torch import _build  # noqa: E402
from diffrl_tpu_torch.sim import articulation_lb as lb  # noqa: E402
from diffrl_tpu_torch.sim import substep_kernels as sk  # noqa: E402
from diffrl_tpu_torch.testing import check_kernel, f64_floor  # noqa

E = 4096


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bench_substep_teams: CUDA is not available", file=sys.stderr)
        return 1
    env_name = "Ant"
    if argv[:1] == ["--env"]:
        env_name, argv = argv[1], argv[2:]
    teams = [int(a) for a in argv] or [8, 16]
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    spec = cs.MODELS[env_name]
    env = envs.make(env_name, num_envs=E, seed=0, stochastic_init=True,
                    episode_length=1000, MM_caching_frequency=spec["mm"],
                    device=dev)
    base = env.model
    # one Model object per team size: kernels are cached per Model
    models = {T: dataclasses.replace(base) for T in teams}
    default = f"#define DRL_T {sk.team_layout(base).threads_per_env}\n"
    specs = []
    for T in teams:
        for kname in ("substep_forward", "substep_vjp"):
            src = sk.kernel_source(base, kname)
            header = src.headers["substep_topology.h"]
            if default not in header:
                raise RuntimeError("the generated header has no DRL_T line")
            specs.append(dataclasses.replace(src, headers={
                "substep_topology.h": header.replace(
                    default, f"#define DRL_T {T}\n")}))
    built = iter(_build.build_all(specs))
    for T in teams:
        for kname in ("substep_forward", "substep_vjp"):
            b = next(built)
            k = sk._prepare(kname, models[T], dev, b)
            a = sk.kernel_attributes(k)
            blocks, warps = a.resident(E)
            print(f"{env_name} T={T} {kname}: ptxas {b.registers} registers, "
                  f"{b.spill_store_bytes} B spill stores, {b.stack_bytes} B "
                  f"stack; {a.envs_per_block} envs per block, "
                  f"{a.smem_bytes} B shared per block, at most "
                  f"{a.max_blocks_per_sm} blocks per SM; at E={E} "
                  f"{blocks:.3f} blocks, {warps:.3f} warps per SM",
                  flush=True)

    floor = f64_floor(env_name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    s = cs.settled_state(env, spec["settle"])
    acts = torch.rand((E, env.num_acts), generator=gen, device=dev) * 2 - 1
    ja, ma = cs.controls(env, acts)
    jat = ja.T.contiguous()
    mat = ma.T.contiguous() if ma is not None else None
    h = env.dt / env.sim_substeps
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()

    def f64(*xs):
        return [None if t is None else t.double() for t in xs]

    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(base, q, qd, jat, mat, h)
        gq = torch.randn(q1.shape, generator=gen, device=dev)
        gqd = torch.randn(qd1.shape, generator=gen, device=dev)
        pf = lb.substep_lb(base, q1, qd1, jat, mat, h, H, Hinv)
        xf = lb.substep_lb(base, *f64(q1, qd1, jat, mat), h, *f64(H, Hinv))
        pv = lb.substep_vjp_lb(base, q1, qd1, jat, mat, h, H, Hinv, gq,
                               gqd)
        xv = lb.substep_vjp_lb(base, *f64(q1, qd1, jat, mat), h,
                               *f64(H, Hinv, gq, gqd))
        for T in teams:
            m = models[T]
            kf = sk.substep_forward(m, q1, qd1, jat, mat, h, H, Hinv)
            kv = sk.substep_vjp(m, q1, qd1, jat, mat, h, H, Hinv, gq, gqd)
            torch.cuda.synchronize()
            check_kernel(f"T={T} q", kf[0], pf[0], xf[0], 2e-5, 2e-6, floor)
            check_kernel(f"T={T} qd", kf[1], pf[1], xf[1], 2e-5, 2e-5,
                         floor)
            for lab, a, b, x in zip(("dq", "dqd", "dja", "dma", "dH"), kv,
                                    pv, xv):
                if a is not None:
                    check_kernel(f"T={T} {lab}", a, b, x, 2e-4, 1e-5,
                                 floor)

        times = {T: ([], []) for T in teams}
        for T in teams + teams[::-1]:
            m = models[T]
            times[T][0].append(statistics.median(cs.device_ms(
                lambda: sk.substep_forward(m, q1, qd1, jat, mat, h, H,
                                           Hinv), 50) for _ in range(7)))
            times[T][1].append(statistics.median(cs.device_ms(
                lambda: sk.substep_vjp(m, q1, qd1, jat, mat, h, H, Hinv,
                                       gq, gqd), 50) for _ in range(7)))
    for T in teams:
        f, v = times[T]
        print(f"{env_name} T={T}: substep_forward " + ", ".join(
            f"{x * 1e3:.2f}" for x in f) + " us; substep_vjp " + ", ".join(
            f"{x * 1e3:.2f}" for x in v) + f" us per launch on the device "
            f"(two turns, each the median of 7 x 50 launches) | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

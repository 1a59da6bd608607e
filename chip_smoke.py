#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (diffrl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device  -- needs CUDA; prints the card's name and power limit
              (nvidia-smi).
2. build   -- builds the cached-substep forward kernel (csrc/) with nvcc for
              sm_90a: seconds, registers per thread, spill bytes.
3. kernel  -- Ant at E = 4096: one cached substep, kernel against its plain
              version substep_lb (q rtol 2e-5 atol 2e-6, qd rtol 2e-5
              atol 2e-5), and one whole env step (16 substeps, mass matrix
              every 16), kernel path against plain path (rtol/atol 1e-4);
              plus a prismatic + revolute model without ground.
4. fixture -- the kernel path against the dflex golden Ant trajectory
              tests/fixtures/env_ant_mjcf.npz (40 steps; atol 1e-5 on the
              first 15, 1e-4 on all).
5. main    -- the port's main path: Ant with 4096 envs, mm 16, stochastic
              init, the SHAC Ant actor (128/64/32, ELU + LayerNorm) and
              obs_rms, batched_eval for 64 env steps of deterministic
              actions; then timings (CUDA events) and bench.py-style
              random-action env-steps/s.

Before the last line it prints the nvidia-smi line and one JSON line with
the kernels' launches, errors and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

E = 4096
MM = 16
EVAL_STEPS = 64
BENCH_WARMUP, BENCH_STEPS = 5, 50
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ROOT = os.path.dirname(os.path.abspath(__file__))


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def event_times(fn, n, warmup=3):
    """Per-call milliseconds of fn() over n calls between CUDA events. The
    device waits for the host between calls, so this includes the host's
    launch overhead: the time a caller sees."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def device_ms(fn, n, warmup=3):
    """Device milliseconds per call of n back-to-back calls, with the host
    queued ahead: the device first spins (torch.cuda._sleep) for twice the
    time the host takes to issue the n calls, so the events time the work on
    the device and not the host's launch overhead. Raises if the host did
    not get ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 6)
    b.record()
    torch.cuda.synchronize()
    cycles = int(2.0 * host_ms / a.elapsed_time(b) * 10 ** 6) + 10 ** 6
    torch.cuda._sleep(cycles)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    if b.query():
        raise RuntimeError("device_ms: the device caught up with the host")
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def graph_ms(fn, reps=10):
    """Device milliseconds of fn() replayed as one CUDA graph: the device
    time of work whose many small launches a queued host cannot get ahead
    of (the launch queue is shallower than one call's launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def assert_close(name, got, want, rtol, atol):
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def plain_step(model, q, qd, ja, h, mm, substeps):
    """One env step on the plain path only: refresh + (mm - 1) substep_lb."""
    from diffrl_tpu_torch.sim.articulation_lb import (refresh_substep_lb,
                                                      substep_lb)
    for _ in range(substeps // mm):
        q, qd, H, Hinv = refresh_substep_lb(model, q, qd, ja, None, h)
        for _ in range(mm - 1):
            q, qd = substep_lb(model, q, qd, ja, None, h, H, Hinv)
    return q, qd


def prismatic_model():
    from diffrl_tpu_torch.sim.model import (JOINT_PRISMATIC, JOINT_REVOLUTE,
                                            ModelBuilder)
    qi = (0.0, 0.0, 0.0, 1.0)
    b = ModelBuilder()
    b.add_articulation()
    cart = b.add_link(-1, np.array([0.0, 1.0, 0.0, *qi]), axis=(1.0, 0.0, 0.0),
                      type=JOINT_PRISMATIC, limit_lower=-1.0, limit_upper=1.0,
                      stiffness=5.0, damping=1.0)
    b.add_shape_box(cart, hx=0.2, hy=0.1, hz=0.1, density=500.0)
    pole = b.add_link(cart, np.array([0.0, 0.0, 0.0, *qi]),
                      axis=(0.0, 0.0, 1.0), type=JOINT_REVOLUTE,
                      limit_lower=-0.5, limit_upper=0.5)
    b.add_shape_capsule(pole, pos=(0.3, 0.0, 0.0), radius=0.05,
                        half_width=0.3, density=500.0)
    return dataclasses.replace(b.finalize(), ground=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import diffrl_tpu_torch  # noqa: F401  (precision policy)
    from diffrl_tpu_torch import _build, envs
    from diffrl_tpu_torch.algorithms import batched_eval, policy_act_fn
    from diffrl_tpu_torch.models import ActorStochasticMLP
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.utils import RunningMeanStd

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # 2. build (one nvcc per kernel build, all started together)
    env = envs.make("Ant", num_envs=E, seed=0, stochastic_init=True,
                    episode_length=1000, MM_caching_frequency=MM, device=dev)
    model = env.model
    pmodel = prismatic_model()
    built, pbuilt = _build.build_all(
        [sk.kernel_source(model), sk.kernel_source(pmodel)])
    kern = sk.prepare_substep_forward(model, dev, built=built)
    sk.prepare_substep_forward(pmodel, dev, built=pbuilt)
    regs, local = sk.kernel_attributes(kern)
    phase("build", f"substep_forward for Ant: {built.seconds:.2f} s nvcc "
          f"(both builds together), ptxas {built.registers} registers, "
          f"{built.spill_store_bytes} B spill stores, "
          f"{built.spill_load_bytes} B spill loads, {built.stack_bytes} B "
          f"stack; loaded: {regs} registers, {local} B local per thread")

    # 3. kernel against its plain version, both on the card
    h = env.dt / env.sim_substeps
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    s0 = env.reset()
    acts = torch.rand((E, env.num_acts), generator=gen, device=dev) * 2 - 1
    ja, _ = env.action_to_controls(acts)
    q = s0.joint_q.T.contiguous()
    qd = s0.joint_qd.T.contiguous()
    jat = ja.T.contiguous()
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(model, q, qd, jat, None, h)
        kq, kqd = sk.substep_forward(model, q1, qd1, jat, None, h, H, Hinv)
        pq, pqd = lb.substep_lb(model, q1, qd1, jat, None, h, H, Hinv)
        torch.cuda.synchronize()
        err_q = assert_close("substep q", kq, pq, 2e-5, 2e-6)
        err_qd = assert_close("substep qd", kqd, pqd, 2e-5, 2e-5)
        sq, sqd = lb.simulate_batched_lb(
            model, s0.joint_q, s0.joint_qd, ja, None, dt=env.dt,
            substeps=env.sim_substeps, mass_matrix_freq=MM)
        rq, rqd = plain_step(model, q, qd, jat, h, MM, env.sim_substeps)
        err_step_q = assert_close("step q", sq, rq.T, 1e-4, 1e-4)
        err_step_qd = assert_close("step qd", sqd, rqd.T, 1e-4, 1e-4)
        # prismatic + revolute, limits, no ground
        pe = 256
        pq0 = torch.rand((2, pe), generator=gen, device=dev) * 3 - 1.5
        pqd0 = torch.rand((2, pe), generator=gen, device=dev) * 2 - 1
        pja = torch.rand((2, pe), generator=gen, device=dev) * 10 - 5
        ph = 1.0 / 60.0 / 4
        _, _, pH, pHinv = lb.refresh_substep_lb(pmodel, pq0, pqd0, pja, None,
                                                ph)
        a = sk.substep_forward(pmodel, pq0, pqd0, pja, None, ph, pH, pHinv)
        b = lb.substep_lb(pmodel, pq0, pqd0, pja, None, ph, pH, pHinv)
        err_p = max(assert_close("prismatic q", a[0], b[0], 2e-5, 2e-6),
                    assert_close("prismatic qd", a[1], b[1], 2e-5, 2e-5))
    max_abs_err = max(err_q, err_qd)
    phase("kernel", f"Ant E={E}: one cached substep max|dq| {err_q:.3e} "
          f"max|dqd| {err_qd:.3e}; one env step (16 substeps, mm 16) "
          f"max|dq| {err_step_q:.3e} max|dqd| {err_step_qd:.3e}; "
          f"prismatic+revolute E={pe} max err {err_p:.3e}")

    # 4. dflex golden fixture through the kernel path
    fix = np.load(os.path.join(ROOT, "tests", "fixtures", "env_ant_mjcf.npz"))
    fmodel = dataclasses.replace(
        model, gravity=np.array([0.0, -9.8, 0.0], np.float32))
    fq = torch.as_tensor(model.joint_q_init, device=dev)[None]
    fqd = torch.zeros((1, model.dof_count), device=dev)
    fja = torch.zeros((1, model.dof_count), device=dev)
    fja[0, 6:] = 40.0 * torch.sin(torch.arange(8, device=dev,
                                               dtype=torch.float32))
    traj = []
    launches0 = sk.substep_forward.launches
    with torch.no_grad():
        for _ in range(fix["joint_q"].shape[0]):
            fq, fqd = lb.simulate_batched_lb(fmodel, fq, fqd, fja, None,
                                             dt=1.0 / 60.0, substeps=16,
                                             mass_matrix_freq=16)
            traj.append(fq[0])
    got = torch.stack(traj).cpu().numpy()
    if sk.substep_forward.launches - launches0 != 15 * len(traj):
        raise RuntimeError("the fixture run did not go through the kernel")
    np.testing.assert_allclose(got[:15], fix["joint_q"][:15], atol=1e-5)
    np.testing.assert_allclose(got, fix["joint_q"], atol=1e-4)
    phase("fixture", f"env_ant_mjcf 40 steps through the kernel: max|dq| "
          f"{np.abs(got[:15] - fix['joint_q'][:15]).max():.3e} (15 steps), "
          f"{np.abs(got - fix['joint_q']).max():.3e} (40 steps)")

    # 5. main path: policy rollout through batched_eval
    cfg_network = {"actor_mlp": {"units": [128, 64, 32],
                                 "activation": "elu"}}
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(0)
    actor = ActorStochasticMLP(env.num_obs, env.num_acts, cfg_network,
                               device=dev, generator=wgen)
    obs_rms = RunningMeanStd((env.num_obs,), device=dev)
    obs_rms.update(env.batch_observations(env.reset()))
    eval_env = envs.make("Ant", num_envs=E, seed=2, stochastic_init=True,
                         episode_length=EVAL_STEPS, MM_caching_frequency=MM,
                         device=dev)
    torch.cuda.synchronize()
    sk.substep_forward.launches = 0
    t0 = time.perf_counter()
    mean_rew, mean_disc, mean_len = batched_eval(
        eval_env, policy_act_fn(actor, obs_rms, deterministic=True),
        num_games=E, gamma=0.99, chunk=EVAL_STEPS)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = sk.substep_forward.launches
    if not all(math.isfinite(x) for x in (mean_rew, mean_disc, mean_len)):
        raise RuntimeError(f"non-finite rollout result {mean_rew} "
                           f"{mean_disc} {mean_len}")
    if launches != EVAL_STEPS * (MM - 1):
        raise RuntimeError(f"main path launched substep_forward {launches} "
                           f"times, expected {EVAL_STEPS * (MM - 1)}")
    eval_fps = E * EVAL_STEPS / eval_s
    phase("main", f"batched_eval Ant E={E} {EVAL_STEPS} steps "
          f"deterministic: {eval_s:.3f} s, {eval_fps:.1f} env-steps/s, mean "
          f"reward {mean_rew:.4f}, mean length {mean_len:.2f}, "
          f"substep_forward launches {launches} | {card}")

    # timings at the main path's shapes: device time with the host queued
    # ahead (median of repeated batches), and per-call time as a caller sees
    # it (CUDA events around each call, host launch overhead included)
    def kernel():
        sk.substep_forward(model, q1, qd1, jat, None, h, H, Hinv)

    def plain():
        lb.substep_lb(model, q1, qd1, jat, None, h, H, Hinv)

    def refresh():
        lb.refresh_substep_lb(model, q, qd, jat, None, h)

    with torch.no_grad():
        k_dev = statistics.median(device_ms(kernel, 50) for _ in range(7))
        p_dev = graph_ms(plain)
        r_dev = graph_ms(refresh)
        k_call, p_call, r_call, s_call = (
            statistics.median(event_times(fn, n)) for fn, n in (
                (kernel, 100), (plain, 20), (refresh, 20),
                (lambda: env.step(s0, acts), 10)))
    nbytes = sk.substep_forward_bytes(model, E)
    flops = sk.substep_forward_flops(model, E)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    phase("timing", f"substep_forward kernel {k_dev * 1e3:.2f} us/launch on "
          f"the device (median of 7 x 50 launches), {k_call * 1e3:.2f} us "
          f"per call; bound {bound_ms * 1e3:.3f} us ({nbytes} B, {flops} "
          f"flop) | {card}")
    phase("timing", f"plain substep_lb {p_dev:.3f} ms device (one CUDA "
          f"graph), {p_call:.3f} ms per call; refresh substep {r_dev:.3f} ms "
          f"device (one CUDA graph), "
          f"{r_call:.3f} ms per call; env step {s_call:.3f} ms per call = 1 "
          f"refresh + {MM - 1} kernel launches + obs/reward/reset | {card}")

    # bench.py-style random-action env-steps/s
    bench_env = envs.make("Ant", num_envs=E, seed=0, stochastic_init=True,
                          episode_length=1000, MM_caching_frequency=MM,
                          device=dev)
    state = bench_env.reset()
    agen = torch.Generator(device=dev)
    agen.manual_seed(1)
    with torch.no_grad():
        for i in range(BENCH_WARMUP + BENCH_STEPS):
            if i == BENCH_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            a = torch.rand((E, bench_env.num_acts), generator=agen,
                           device=dev) * 2 - 1
            state, obs, rew, done, _ = bench_env.step(state, a)
        torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    if not (torch.isfinite(obs).all() and torch.isfinite(rew).all()
            and torch.isfinite(state.joint_q).all()):
        raise RuntimeError("non-finite state after the random-action run")
    phase("bench", f"random actions Ant E={E} mm {MM}: "
          f"{E * BENCH_STEPS / bench_s:.1f} env-steps/s over {BENCH_STEPS} "
          f"steps | {card}")
    phase("total", f"{time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "substep_forward",
        "route": "cuda",
        "source": "diffrl_tpu_torch/csrc/substep_forward.cu",
        "replaces": "diffrl_tpu/sim/pallas_substep.py:243",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_dev,
        "plain_ms": p_dev,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (diffrl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device  -- needs CUDA; prints the card's name and power limit
              (nvidia-smi).
2. build   -- builds the cached-substep forward kernel (K1) and its adjoint
              kernel (K2) from csrc/ with nvcc for sm_90a, one nvcc process
              per library, all started together: seconds, registers per
              thread, spill and stack bytes; threads per env, envs per
              block, shared memory per block, and the blocks and warps
              resident per SM at E = 4096 (the card's occupancy query and
              the grid; fails under 4 warps).
3. kernel  -- Ant at E = 4096: one cached substep, K1 against its plain
              version substep_lb (q rtol 2e-5 atol 2e-6, qd rtol 2e-5
              atol 2e-5), and one whole env step (16 substeps, mass matrix
              every 16), kernel path against plain path (rtol/atol 1e-4);
              plus a prismatic + revolute model without ground.
4. adjoint -- Ant at E = 4096 on a settled state with ground contacts
              active: one cached substep, K2 against its plain version
              substep_vjp_lb (rtol 2e-4, atol 1e-5 in units of each env's
              largest cotangent entry), and entry by entry no further from
              the plain version run in float64 than twice the float32 plain
              version's error plus rtol and 8 times the plain version's
              largest error in that env (the rules of
              diffrl_tpu_torch/testing.py); one env step's gradient of a
              fixed weighted sum of (q', qd') w.r.t. (q, qd, joint_act),
              kernel path against plain path (rtol 1e-3, atol 1e-4, same
              units) and against float64 by the same rule.
5. fixture -- the kernel path against the dflex golden Ant trajectory
              tests/fixtures/env_ant_mjcf.npz (40 steps; atol 1e-5 on the
              first 15, 1e-4 on all).
6. main    -- the rollout path: Ant with 4096 envs, mm 16, stochastic init,
              the SHAC Ant actor (128/64/32, ELU + LayerNorm) and obs_rms,
              batched_eval for 64 env steps of deterministic actions.
7. train   -- the training path: SHAC(cfg).train() from
              examples/cfg/shac/ant.yaml at 4096 envs x 32 steps, 16
              substeps, mm 16, 3 epochs; K1 and K2 launch 3 x 32 x 15 times
              each; seconds per epoch, training env-steps/s, peak memory,
              and one more epoch split into its phases.
8. timing  -- device time per launch of both kernels (CUDA events with the
              host queued ahead), per-call times, the plain versions and
              the refresh substep as CUDA graphs, and bench.py-style
              random-action env-steps/s.

Before the last line it prints the nvidia-smi line and one JSON line with
the kernels' launches (in the training path), errors, times, threads per
env and warps per SM; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

E = 4096
MM = 16
EVAL_STEPS = 64
TRAIN_STEPS, TRAIN_EPOCHS = 32, 3
SETTLE_STEPS = 14          # zero-action steps until the feet touch down
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


def settled_state(env, steps):
    """Joint coordinates after zero-action env steps from env.reset()."""
    s = env.reset()
    zero = torch.zeros((env.num_envs, env.num_acts), device=env.device)
    with torch.no_grad():
        for _ in range(steps):
            s, *_ = env.step(s, zero)
    return s


def step_grad(model, q, qd, ja, w_q, w_qd, mm, substeps, plain):
    """d/d(q, qd, joint_act) of <w_q, q'> + <w_qd, qd'> over one env step
    (env-leading [E, .] inputs), through simulate_batched_lb (K1 forward,
    K2 reverse) or, with ``plain``, autograd through refresh_substep_lb and
    substep_lb alone."""
    from diffrl_tpu_torch.sim.articulation_lb import simulate_batched_lb
    leaves = [x.detach().clone().requires_grad_() for x in (q, qd, ja)]
    with torch.enable_grad():
        if plain:
            qt, qdt = plain_step(model, leaves[0].T, leaves[1].T,
                                 leaves[2].T, 1.0 / 60.0 / substeps, mm,
                                 substeps)
            qn, qdn = qt.T, qdt.T
        else:
            qn, qdn = simulate_batched_lb(model, *leaves, None,
                                          dt=1.0 / 60.0, substeps=substeps,
                                          mass_matrix_freq=mm)
        loss = torch.sum(qn * w_q) + torch.sum(qdn * w_qd)
        return torch.autograd.grad(loss, leaves)


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
    from diffrl_tpu_torch.algorithms import SHAC, batched_eval, policy_act_fn
    from diffrl_tpu_torch.models import ActorStochasticMLP
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.testing import check_against_f64, check_vjp
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
    built, vbuilt, pbuilt = _build.build_all(
        [sk.kernel_source(model), sk.kernel_source(model, "substep_vjp"),
         sk.kernel_source(pmodel)])
    kern = sk.prepare_substep_forward(model, dev, built=built)
    vkern = sk.prepare_substep_vjp(model, dev, built=vbuilt)
    sk.prepare_substep_forward(pmodel, dev, built=pbuilt)
    occupancy = {}
    for b, k in ((built, kern), (vbuilt, vkern)):
        a = sk.kernel_attributes(k)
        blocks, warps = a.resident(E)
        occupancy[b.name] = (a.threads_per_env, warps)
        phase("build", f"{b.name} for Ant: {b.seconds:.2f} s nvcc (all "
              f"builds together), ptxas {b.registers} registers, "
              f"{b.spill_store_bytes} B spill stores, "
              f"{b.spill_load_bytes} B spill loads, {b.stack_bytes} B "
              f"stack; loaded: {a.registers} registers, {a.local_bytes} B "
              f"local per thread")
        phase("build", f"{b.name} occupancy: {a.threads_per_env} threads "
              f"per env, {a.envs_per_block} envs per block, "
              f"{a.smem_bytes} B shared memory per block, at most "
              f"{a.max_blocks_per_sm} blocks per SM; at E={E} "
              f"{-(-E // a.envs_per_block)} blocks over {a.sm_count} SMs: "
              f"{blocks:.3f} blocks and {warps:.3f} warps resident per SM")
        if warps < 4.0:
            raise RuntimeError(f"{b.name}: {warps:.3f} warps per SM at "
                               f"E={E}, fewer than 4")

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

    # 4. the adjoint kernel against its plain version, on a settled state
    # with ground contacts active
    s1 = settled_state(env, SETTLE_STEPS)
    sq_, sqd_ = s1.joint_q.T.contiguous(), s1.joint_qd.T.contiguous()
    with torch.no_grad():
        a1, ad1, aH, aHinv = lb.refresh_substep_lb(model, sq_, sqd_, jat,
                                                   None, h)
    n_active = sk.active_contacts(model, a1)
    if n_active < E:
        raise RuntimeError(f"only {n_active} ground contacts active over "
                           f"{E} envs: the state has not settled")
    gq = torch.randn(a1.shape, generator=gen, device=dev)
    gqd = torch.randn(ad1.shape, generator=gen, device=dev)
    vargs = (model, a1, ad1, jat, None, h, aH, aHinv, gq, gqd)
    n0 = sk.substep_vjp.launches
    kv = sk.substep_vjp(*vargs)
    if sk.substep_vjp.launches != n0 + 1:
        raise RuntimeError("substep_vjp did not launch its kernel")
    pv = lb.substep_vjp_lb(*vargs)
    xv = lb.substep_vjp_lb(model, *(t.double() for t in (a1, ad1, jat)),
                           None, h, *(t.double() for t in (aH, aHinv, gq,
                                                            gqd)))
    torch.cuda.synchronize()
    vjp_err, f64 = 0.0, []
    for lab, kx, px, xx in zip(("dq", "dqd", "djoint_act", "dH"),
                               kv[:3] + kv[4:], pv[:3] + pv[4:],
                               xv[:3] + xv[4:]):
        vjp_err = max(vjp_err, check_vjp(f"substep_vjp {lab}", kx, px,
                                         2e-4, 1e-5))
        f64.append((lab,) + check_against_f64(f"substep_vjp {lab}", kx, px,
                                              xx, 2e-4, 1e-5))
    # one env step's gradient, kernel path (K1 + K2) against plain path
    w_q = torch.randn(s1.joint_q.shape, generator=gen, device=dev)
    w_qd = torch.randn(s1.joint_qd.shape, generator=gen, device=dev)
    gargs = (s1.joint_q, s1.joint_qd, ja, w_q, w_qd, MM, env.sim_substeps)
    n0 = sk.substep_vjp.launches
    kg = step_grad(model, *gargs, plain=False)
    if sk.substep_vjp.launches - n0 != MM - 1:
        raise RuntimeError(f"the env step's reverse pass launched "
                           f"substep_vjp {sk.substep_vjp.launches - n0} "
                           f"times, expected {MM - 1}")
    pg = step_grad(model, *gargs, plain=True)
    xg = step_grad(model, *(t.double() for t in gargs[:5]), MM,
                   env.sim_substeps, plain=True)
    torch.cuda.synchronize()
    step_err, step_f64 = 0.0, []
    for lab, kx, px, xx in zip(("dq", "dqd", "djoint_act"), kg, pg, xg):
        step_err = max(step_err, check_vjp(f"env step {lab}", kx.T, px.T,
                                           1e-3, 1e-4))
        step_f64.append((lab,) + check_against_f64(
            f"env step {lab}", kx.T, px.T, xx.T, 1e-3, 1e-4))
    phase("adjoint", f"Ant E={E} settled {SETTLE_STEPS} steps, {n_active} "
          f"of {E * len(lb._plan_for(model, dev).contact_rows)} contacts "
          f"active: one cached substep K2 vs plain max err {vjp_err:.3e}; "
          f"vs float64 (entries outside rtol 2e-4 atol 1e-5 kernel/plain, "
          f"max err kernel/plain, least floor of the 2x-plain rule): "
          + "; ".join(f"{lab} {a}/{b} {c:.2e}/{d:.2e} {n:.1e}"
                      for lab, a, b, c, d, n in f64)
          + f" | one env step grad kernel path vs plain max err "
          f"{step_err:.3e}; vs float64: " + "; ".join(
              f"{lab} {a}/{b} {c:.2e}/{d:.2e} {n:.1e}"
              for lab, a, b, c, d, n in step_f64))

    # 5. dflex golden fixture through the kernel path
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

    # 6. the rollout path: policy rollout through batched_eval
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
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
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
    if launches != EVAL_STEPS * (MM - 1) or sk.substep_vjp.launches:
        raise RuntimeError(f"the rollout path launched substep_forward "
                           f"{launches} times (expected "
                           f"{EVAL_STEPS * (MM - 1)}) and substep_vjp "
                           f"{sk.substep_vjp.launches} (expected 0)")
    eval_fps = E * EVAL_STEPS / eval_s
    phase("main", f"batched_eval Ant E={E} {EVAL_STEPS} steps "
          f"deterministic: {eval_s:.3f} s, {eval_fps:.1f} env-steps/s, mean "
          f"reward {mean_rew:.4f}, mean length {mean_len:.2f}, "
          f"substep_forward launches {launches} | {card}")

    # 7. the training path: SHAC from the Ant config at full width
    import yaml
    with open(os.path.join(ROOT, "examples", "cfg", "shac", "ant.yaml")) as f:
        cfg = yaml.safe_load(f)
    logdir = tempfile.mkdtemp(prefix="chip_smoke_shac_")
    cfg["params"]["general"] = {"logdir": logdir, "seed": 0}
    cfg["params"]["config"].update(num_actors=E, steps_num=TRAIN_STEPS,
                                   max_epochs=TRAIN_EPOCHS, save_interval=0)
    trainer = SHAC(cfg, device=dev)
    if (trainer.env.sim_substeps, trainer.env.mm_caching_frequency) != \
            (16, MM):
        raise RuntimeError("the Ant config no longer runs 16 substeps, mm 16")
    before = [p.detach().clone() for p in trainer.actor.parameters()]
    peaks_gb = []
    train_epoch = trainer.train_epoch

    def epoch_with_peak():
        # the allocator's counters are host-side: no sync added
        torch.cuda.reset_peak_memory_stats()
        out = train_epoch()
        peaks_gb.append(torch.cuda.max_memory_allocated() / 1e9)
        return out

    trainer.train_epoch = epoch_with_peak
    torch.cuda.synchronize()
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = (sk.substep_forward.launches, sk.substep_vjp.launches)
    trainer.train_epoch = train_epoch
    want = TRAIN_EPOCHS * TRAIN_STEPS * (MM - 1)
    if train_launches != (want, want):
        raise RuntimeError(f"the training path launched (substep_forward, "
                           f"substep_vjp) {train_launches} times, expected "
                           f"{want} each")
    losses = [v for k in ("actor_loss", "value_loss")
              for _, _, v in trainer.scalars[k]]
    if len(losses) != 2 * TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"training losses {losses}")
    if all(torch.equal(a, b) for a, b in zip(before,
                                             trainer.actor.parameters())):
        raise RuntimeError("training left the actor's parameters unchanged")
    epoch_s = [E * TRAIN_STEPS / fps for _, _, fps in trainer.scalars["fps"]]
    steady = statistics.mean(epoch_s[1:])
    phase("train", f"SHAC Ant E={E} x {TRAIN_STEPS} steps, 16 substeps, mm "
          f"{MM}, {TRAIN_EPOCHS} epochs in {train_s:.2f} s: epoch seconds "
          + ", ".join(f"{t:.3f}" for t in epoch_s) + f" (first builds); "
          f"{E * TRAIN_STEPS / steady:.1f} training env-steps/s after the "
          f"first; peak memory per epoch " + ", ".join(
              f"{g:.3f}" for g in peaks_gb) + " GB; actor/value loss per "
          f"epoch " + ", ".join(
              f"{a:.4f}/{v:.4f}" for (_, _, a), (_, _, v) in zip(
                  trainer.scalars["actor_loss"],
                  trainer.scalars["value_loss"]))
          + f"; substep_forward/substep_vjp launches {train_launches} | "
          f"{card}")

    # one more epoch, phase by phase (the host waits for the device after
    # each): the window's forward, its backward + actor step, the critic
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    (loss, outs), fwd_ms = timed(trainer.rollout)
    _, bwd_ms = timed(lambda: trainer.actor_step(loss))

    _, critic_ms = timed(lambda: trainer.critic_step(outs))
    shutil.rmtree(logdir)

    # timings at the main path's shapes: device time with the host queued
    # ahead (median of repeated batches), and per-call time as a caller sees
    # it (CUDA events around each call, host launch overhead included)
    def kernel():
        sk.substep_forward(model, q1, qd1, jat, None, h, H, Hinv)

    def plain():
        lb.substep_lb(model, q1, qd1, jat, None, h, H, Hinv)

    def refresh():
        lb.refresh_substep_lb(model, q, qd, jat, None, h)

    gH = torch.randn(aH.shape, generator=gen, device=dev)

    def vjp():
        sk.substep_vjp(*vargs)

    def vjp_plain():
        lb.substep_vjp_lb(*vargs)

    def replay():
        """One block's refresh replay of the reverse pass."""
        leaves = [t.detach().requires_grad_() for t in (sq_, sqd_, jat)]
        with torch.enable_grad():
            r1, rd1, rH, _ = lb.refresh_substep_lb(model, *leaves, None, h)
            torch.autograd.grad((r1, rd1, rH), leaves, (gq, gqd, gH))

    with torch.no_grad():
        k_dev = statistics.median(device_ms(kernel, 50) for _ in range(7))
        v_dev = statistics.median(device_ms(vjp, 50) for _ in range(7))
        p_dev = graph_ms(plain)
        vp_dev = graph_ms(vjp_plain)
        r_dev = graph_ms(refresh)
        rp_dev = graph_ms(replay)
        k_call, v_call, p_call, vp_call, r_call, rp_call, s_call, g_call = (
            statistics.median(event_times(fn, n)) for fn, n in (
                (kernel, 100), (vjp, 100), (plain, 20), (vjp_plain, 10),
                (refresh, 20), (replay, 10),
                (lambda: env.step(s0, acts), 10),
                (lambda: step_grad(model, *gargs, plain=False), 5)))
    nbytes = sk.substep_forward_bytes(model, E)
    flops = sk.substep_forward_flops(model, E)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    phase("timing", f"substep_forward kernel {k_dev * 1e3:.2f} us/launch on "
          f"the device (median of 7 x 50 launches), {k_call * 1e3:.2f} us "
          f"per call; bound {bound_ms * 1e3:.3f} us ({nbytes} B, {flops} "
          f"flop) | {card}")
    vbytes = sk.substep_vjp_bytes(model, E)
    vflops = sk.substep_vjp_flops(model, E, n_active)
    vt_bytes = vbytes / PEAK_BYTES_PER_S * 1e3
    vt_ops = vflops / PEAK_F32_FLOPS * 1e3
    vbound_ms = max(vt_bytes, vt_ops)
    phase("timing", f"substep_vjp kernel {v_dev * 1e3:.2f} us/launch on the "
          f"device (median of 7 x 50 launches), {v_call * 1e3:.2f} us per "
          f"call; bound {vbound_ms * 1e3:.3f} us ({vbytes} B, {vflops} flop "
          f"with {n_active} contacts active) | {card}")
    phase("timing", f"plain substep_lb {p_dev:.3f} ms device (one CUDA "
          f"graph), {p_call:.3f} ms per call; plain substep_vjp_lb "
          f"{vp_dev:.3f} ms device (one CUDA graph), {vp_call:.3f} ms per "
          f"call; refresh substep {r_dev:.3f} ms device (one CUDA graph), "
          f"{r_call:.3f} ms per call; refresh replay (forward + autograd) "
          f"{rp_dev:.3f} ms device (one CUDA graph), {rp_call:.3f} ms per "
          f"call; env step {s_call:.3f} ms per call = 1 refresh + {MM - 1} "
          f"kernel launches + obs/reward/reset; training env step (forward "
          f"and backward of simulate) {g_call:.3f} ms per call | {card}")
    n_win = TRAIN_STEPS * (MM - 1)
    phase("timing", f"one training epoch (E={E}, {TRAIN_STEPS} steps), host "
          f"waiting after each phase: window forward {fwd_ms:.1f} ms, "
          f"backward + actor step {bwd_ms:.1f} ms (K2 {n_win} launches x "
          f"{v_call:.3f} ms per call = {n_win * v_call:.1f} ms; refresh "
          f"replays {TRAIN_STEPS} x {rp_call:.3f} ms per call = "
          f"{TRAIN_STEPS * rp_call:.1f} ms), critic {critic_ms:.1f} ms | "
          f"{card}")

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
        "launches": train_launches[0],
        "max_abs_err": max_abs_err,
        "ms": k_dev,
        "plain_ms": p_dev,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "threads_per_env": occupancy["substep_forward"][0],
        "warps_per_sm": occupancy["substep_forward"][1],
    }, {
        "name": "substep_vjp",
        "route": "cuda",
        "source": "diffrl_tpu_torch/csrc/substep_vjp.cu",
        "replaces": "diffrl_tpu/sim/pallas_substep.py:298",
        "launches": train_launches[1],
        "max_abs_err": vjp_err,
        "ms": v_dev,
        "plain_ms": vp_dev,
        "bound_ms": vbound_ms,
        "bound_by": "bytes" if vt_bytes >= vt_ops else "operations",
        "library_ms": None,
        "threads_per_env": occupancy["substep_vjp"][0],
        "warps_per_sm": occupancy["substep_vjp"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

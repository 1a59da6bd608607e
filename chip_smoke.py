#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (diffrl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (several for the per-model phases); any failure
raises and the script exits non-zero:

1. device  -- needs CUDA; prints the card's name and power limit
              (nvidia-smi).
2. build   -- builds the cached-substep forward kernel (K1) and its adjoint
              kernel (K2) for Ant, Humanoid, Hopper and Cheetah, and K1 for
              a prismatic + revolute model, from csrc/ with nvcc for sm_90a,
              one nvcc process per library, all started together: seconds,
              registers per thread, spill and stack bytes; threads per env,
              envs per block, shared memory per block, and the blocks and
              warps resident per SM at E = 4096 (the card's occupancy query
              and the grid). Fails on spills and under 4 warps per SM.
3. kernel  -- per model at E = 4096 on a settled state with ground contacts
              active: one cached substep, K1 against its plain version
              substep_lb and float64 (q rtol 2e-5 atol 2e-6, qd rtol 2e-5
              atol 2e-5), and one whole env step (Ant, Hopper, Cheetah 16
              substeps, mm 16; Humanoid 48, mm 48), kernel path against
              plain path and float64 (rtol/atol 1e-4); plus the prismatic +
              revolute model without ground (K1 elementwise).
4. adjoint -- per model on the same state: one cached substep, K2 against
              its plain version substep_vjp_lb and float64 (rtol 2e-4, atol
              1e-5); the env step's gradient of a fixed weighted sum of
              (q', qd') w.r.t. (q, qd, joint_act), kernel path against
              plain path and float64 (rtol 1e-3, atol 1e-4).
              The rules are diffrl_tpu_torch/testing.py's: entry by entry
              no further from float64 than twice the float32 plain
              version's error plus rtol and a floor (8, Humanoid 90) times
              the plain version's largest error in that env, the distance
              to the plain version reported; a whole Humanoid env step,
              chaotic in float32, per env at the median and the 90th
              percentile, at most twice the plain path's error.
5. fixture -- the kernel path against the dflex golden trajectories
              tests/fixtures/env_ant_mjcf.npz (40 steps of 16 substeps;
              atol 1e-5 on the first 15, 1e-4 on all) and
              env_humanoid_mjcf.npz (16 steps of 48 substeps, mm 48; atol
              1e-4 on the first 15, 1e-3 on all).
6. main    -- the rollout path: Ant with 4096 envs, mm 16, stochastic init,
              the SHAC Ant actor (128/64/32, ELU + LayerNorm) and obs_rms,
              batched_eval for 64 env steps of deterministic actions.
7. train   -- the training paths: SHAC(cfg).train() from
              examples/cfg/shac/{ant,humanoid,hopper,cheetah}.yaml at 4096
              envs x 32 steps (Ant and Humanoid 2 epochs, Hopper and Cheetah
              1); K1 and K2 launch epochs x 32 x (mm - 1) times each
              (Humanoid 2 x 32 x 47 = 3,008); seconds per epoch, training
              env-steps/s, peak memory, finite losses, a changed actor; one
              more epoch of Ant and of Humanoid split into its phases.
8. timing  -- per model, device time per launch of both kernels (CUDA
              events with the host queued ahead), per-call times, the plain
              versions as CUDA graphs; for Ant and Humanoid the refresh
              substep and its replay; bench.py-style random-action
              env-steps/s on Ant.

Before the last line it prints the nvidia-smi line and one JSON line with
each kernel's launches per model (in its training path), errors, times,
bound, threads per env and warps per SM; the last line is
{"ok": true, "device": {...}}.
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
# the models on the port's paths: substeps per env step (all of them one
# mass-matrix period), zero-action env steps from env.reset() until ground
# contacts are active, and training epochs from examples/cfg/shac/<cfg>
MODELS = {
    "Ant": dict(mm=16, settle=14, cfg="ant.yaml", epochs=2),
    "Humanoid": dict(mm=48, settle=12, cfg="humanoid.yaml", epochs=2),
    "Hopper": dict(mm=16, settle=8, cfg="hopper.yaml", epochs=1),
    "Cheetah": dict(mm=16, settle=16, cfg="cheetah.yaml", epochs=1),
}
MM = MODELS["Ant"]["mm"]
SETTLE_STEPS = MODELS["Ant"]["settle"]
EVAL_STEPS = 64
TRAIN_STEPS = 32
BENCH_WARMUP, BENCH_STEPS = 5, 50
# the dflex golden trajectories: file, substeps (= mm) per step, constant
# joint torques on the actuated dofs, atol on the first 15 steps and on all
FIXTURES = {
    "Ant": ("env_ant_mjcf.npz", 16, lambda n: 40.0 * np.sin(np.arange(n)),
            1e-5, 1e-4),
    "Humanoid": ("env_humanoid_mjcf.npz", 48,
                 lambda n: 25.0 * np.sin(np.arange(n)), 1e-4, 1e-3),
}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("substep_forward", "substep_vjp")


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


def hold(name, what, got, plain, exact, rtol, atol, whole_step=False):
    """A kernel's output against its plain version and float64 by the rules
    of diffrl_tpu_torch/testing.py: check_kernel (Humanoid with its own
    floor), and for a whole Humanoid env step, whose float32 results are
    chaotic, check_env_distribution. Returns (max |got - plain|, a summary:
    entries off the plain version by check_vjp's bound, entries outside
    rtol/atol vs float64 kernel/plain, max error vs float64 kernel/plain,
    least floor of the float64 rule; or the per-env error quantiles)."""
    from diffrl_tpu_torch.testing import (F64_FLOOR, HUMANOID_FLOOR,
                                          check_env_distribution,
                                          check_kernel)

    if whole_step and name == "Humanoid":
        qs = check_env_distribution(f"{name} {what}", got, plain, exact)
        return float((got - plain).abs().max()), f"{what} per-env error " \
            "kernel/plain " + ", ".join(f"q{q:g} {k:.2e}/{p:.2e}"
                                        for q, (k, p) in qs.items())
    floor = HUMANOID_FLOOR if name == "Humanoid" else F64_FLOOR
    err, off, (a, b, c, d, n) = check_kernel(f"{name} {what}", got, plain,
                                             exact, rtol, atol, floor)
    return err, f"{what} {off} {a}/{b} {c:.2e}/{d:.2e} {n:.1e}"


def check_model(name, env, gen):
    """K1 and K2 against their plain versions on ``env`` (E envs) at a
    settled state with ground contacts active, and one whole env step's
    values and gradient, kernel path against plain path. Returns what the
    timing phase reuses and the largest errors."""
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk

    model, mm = env.model, MODELS[name]["mm"]
    substeps = env.sim_substeps
    h = env.dt / substeps
    s1 = settled_state(env, MODELS[name]["settle"])
    acts = torch.rand((E, env.num_acts), generator=gen,
                      device=env.device) * 2 - 1
    ja, _ = env.action_to_controls(acts)
    jat = ja.T.contiguous()
    q, qd = s1.joint_q.T.contiguous(), s1.joint_qd.T.contiguous()
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(model, q, qd, jat, None, h)
        n_active = sk.active_contacts(model, q1)
        if n_active < E:
            raise RuntimeError(f"{name}: only {n_active} ground contacts "
                               f"active over {E} envs: not settled")
        fargs = (model, q1, qd1, jat, None, h, H, Hinv)
        n0 = sk.substep_forward.launches
        kf = sk.substep_forward(*fargs)
        if sk.substep_forward.launches != n0 + 1:
            raise RuntimeError("substep_forward did not launch its kernel")
        pf = lb.substep_lb(*fargs)
        xf = lb.substep_lb(model, *(t.double() for t in (q1, qd1, jat)),
                           None, h, H.double(), Hinv.double())
        sq, sqd = lb.simulate_batched_lb(
            model, s1.joint_q, s1.joint_qd, ja, None, dt=env.dt,
            substeps=substeps, mass_matrix_freq=mm)
        rs = plain_step(model, q, qd, jat, h, mm, substeps)
        xs = plain_step(model, *(t.double() for t in (q, qd, jat)), h, mm,
                        substeps)
    torch.cuda.synchronize()
    fwd = [hold(name, f"substep {lab}", k, p, x, 2e-5, atol)
           for lab, k, p, x, atol in (("q", kf[0], pf[0], xf[0], 2e-6),
                                      ("qd", kf[1], pf[1], xf[1], 2e-5))]
    step = [hold(name, f"step {lab}", k, p, x, 1e-4, 1e-4, whole_step=True)
            for lab, k, p, x in (("q", sq.T, rs[0], xs[0]),
                                 ("qd", sqd.T, rs[1], xs[1]))]
    err_fwd = max(e for e, _ in fwd)
    phase("kernel", f"{name} E={E} settled {MODELS[name]['settle']} steps: "
          f"one cached substep K1 vs plain max err {err_fwd:.3e}; per "
          f"output: entries off the plain version by check_vjp's bound, vs "
          f"float64 entries outside rtol 2e-5 atol 2e-6/2e-5 kernel/plain, "
          f"max err kernel/plain, least floor of the 2x-plain rule: "
          + "; ".join(t for _, t in fwd) + f" | one env step ({substeps} "
          f"substeps, mm {mm}) kernel path vs plain max err "
          f"{max(e for e, _ in step):.3e}; vs float64: "
          + "; ".join(t for _, t in step))

    gq = torch.randn(q1.shape, generator=gen, device=env.device)
    gqd = torch.randn(qd1.shape, generator=gen, device=env.device)
    vargs = (model, q1, qd1, jat, None, h, H, Hinv, gq, gqd)
    n0 = sk.substep_vjp.launches
    kv = sk.substep_vjp(*vargs)
    if sk.substep_vjp.launches != n0 + 1:
        raise RuntimeError("substep_vjp did not launch its kernel")
    pv = lb.substep_vjp_lb(*vargs)
    xv = lb.substep_vjp_lb(model, *(t.double() for t in (q1, qd1, jat)),
                           None, h, *(t.double() for t in (H, Hinv, gq,
                                                            gqd)))
    torch.cuda.synchronize()
    vjp = [hold(name, f"substep_vjp {lab}", kx, px, xx, 2e-4, 1e-5)
           for lab, kx, px, xx in zip(("dq", "dqd", "djoint_act", "dH"),
                                      kv[:3] + kv[4:], pv[:3] + pv[4:],
                                      xv[:3] + xv[4:])]
    err_vjp = max(e for e, _ in vjp)
    w_q = torch.randn(s1.joint_q.shape, generator=gen, device=env.device)
    w_qd = torch.randn(s1.joint_qd.shape, generator=gen, device=env.device)
    gargs = (s1.joint_q, s1.joint_qd, ja, w_q, w_qd, mm, substeps)
    n0 = sk.substep_vjp.launches
    kg = step_grad(model, *gargs, plain=False)
    if sk.substep_vjp.launches - n0 != mm - 1:
        raise RuntimeError(f"{name}: the env step's reverse pass launched "
                           f"substep_vjp {sk.substep_vjp.launches - n0} "
                           f"times, expected {mm - 1}")
    pg = step_grad(model, *gargs, plain=True)
    xg = step_grad(model, *(t.double() for t in gargs[:5]), mm, substeps,
                   plain=True)
    torch.cuda.synchronize()
    grad = [hold(name, f"env step {lab}", kx.T, px.T, xx.T, 1e-3, 1e-4,
                 whole_step=True)
            for lab, kx, px, xx in zip(("dq", "dqd", "djoint_act"), kg, pg,
                                       xg)]
    K = len(lb._plan_for(model, env.device).contact_rows)
    phase("adjoint", f"{name} E={E}, {n_active} of {E * K} contacts "
          f"active: one cached substep K2 vs plain max err {err_vjp:.3e}; "
          f"per output as in the kernel line (rtol 2e-4 atol 1e-5): "
          + "; ".join(t for _, t in vjp) + " | one env step grad kernel "
          f"path vs plain max err {max(e for e, _ in grad):.3e}; vs "
          f"float64 (rtol 1e-3 atol 1e-4): " + "; ".join(t for _, t in grad))
    return dict(fargs=fargs, vargs=vargs,
                step_state=(s1, ja, acts), gargs=gargs, n_active=n_active,
                err_fwd=err_fwd, err_vjp=err_vjp)


def check_fixture(name, model, dev):
    """The kernel path (E = 1) against the dflex golden trajectory of
    ``name``: the fixture scene keeps the builder's gravity (-9.8) and
    constant torques on the actuated dofs."""
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk

    fname, ss, torques, early, full = FIXTURES[name]
    fix = np.load(os.path.join(ROOT, "tests", "fixtures", fname))
    fmodel = dataclasses.replace(
        model, gravity=np.array([0.0, -9.8, 0.0], np.float32))
    D = model.dof_count
    fq = torch.as_tensor(model.joint_q_init, device=dev)[None]
    fqd = torch.zeros((1, D), device=dev)
    fja = torch.zeros((1, D), device=dev)
    fja[0, 6:] = torch.as_tensor(torques(D - 6), dtype=torch.float32,
                                 device=dev)
    traj = []
    launches0 = sk.substep_forward.launches
    with torch.no_grad():
        for _ in range(fix["joint_q"].shape[0]):
            fq, fqd = lb.simulate_batched_lb(fmodel, fq, fqd, fja, None,
                                             dt=1.0 / 60.0, substeps=ss,
                                             mass_matrix_freq=ss)
            traj.append(fq[0])
    got = torch.stack(traj).cpu().numpy()
    if sk.substep_forward.launches - launches0 != (ss - 1) * len(traj):
        raise RuntimeError(f"the {name} fixture run did not go through the "
                           f"kernel")
    np.testing.assert_allclose(got[:15], fix["joint_q"][:15], atol=early)
    np.testing.assert_allclose(got, fix["joint_q"], atol=full)
    phase("fixture", f"{fname[:-4]} {len(traj)} steps of {ss} substeps "
          f"through the kernel: max|dq| "
          f"{np.abs(got[:15] - fix['joint_q'][:15]).max():.3e} (15 steps, "
          f"atol {early:g}), {np.abs(got - fix['joint_q']).max():.3e} "
          f"({len(traj)} steps, atol {full:g})")


def train(name, dev, card):
    """SHAC(cfg).train() from examples/cfg/shac/<cfg> at E envs x
    TRAIN_STEPS, MODELS[name]['epochs'] epochs, with the launch counts set
    to 0 just before and read just after. Returns (trainer, launches)."""
    import yaml

    from diffrl_tpu_torch.algorithms import SHAC
    from diffrl_tpu_torch.sim import substep_kernels as sk

    spec = MODELS[name]
    epochs, mm = spec["epochs"], spec["mm"]
    with open(os.path.join(ROOT, "examples", "cfg", "shac",
                           spec["cfg"])) as f:
        cfg = yaml.safe_load(f)
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_shac_{name}_")
    cfg["params"]["general"] = {"logdir": logdir, "seed": 0}
    cfg["params"]["config"].update(num_actors=E, steps_num=TRAIN_STEPS,
                                   max_epochs=epochs, save_interval=0)
    trainer = SHAC(cfg, device=dev)
    if (trainer.env.sim_substeps, trainer.env.mm_caching_frequency) != \
            (mm, mm):
        raise RuntimeError(f"the {name} config no longer runs {mm} "
                           f"substeps, mm {mm}")
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
    launches = (sk.substep_forward.launches, sk.substep_vjp.launches)
    trainer.train_epoch = train_epoch
    shutil.rmtree(logdir)
    want = epochs * TRAIN_STEPS * (mm - 1)
    if launches != (want, want):
        raise RuntimeError(f"the {name} training path launched "
                           f"(substep_forward, substep_vjp) {launches} "
                           f"times, expected {want} each")
    losses = [v for k in ("actor_loss", "value_loss")
              for _, _, v in trainer.scalars[k]]
    if len(losses) != 2 * epochs or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"{name} training losses {losses}")
    if all(torch.equal(a, b) for a, b in zip(before,
                                             trainer.actor.parameters())):
        raise RuntimeError(f"{name} training left the actor unchanged")
    epoch_s = [E * TRAIN_STEPS / fps for _, _, fps in trainer.scalars["fps"]]
    rate = (f"{E * TRAIN_STEPS / statistics.mean(epoch_s[1:]):.1f} "
            f"training env-steps/s after the first" if epochs > 1 else
            f"{E * TRAIN_STEPS / epoch_s[0]:.1f} training env-steps/s "
            f"(first epoch, builds included)")
    net = trainer.actor.mu_net
    phase("train", f"SHAC {name} E={E} x {TRAIN_STEPS} steps, {mm} "
          f"substeps, mm {mm}, actor {net.layer_dims} {net.activation}, "
          f"{epochs} epochs in {train_s:.2f} s: epoch seconds "
          + ", ".join(f"{t:.3f}" for t in epoch_s) + f" (first builds); "
          f"{rate}; peak memory per epoch " + ", ".join(
              f"{g:.3f}" for g in peaks_gb) + " GB; actor/value loss per "
          f"epoch " + ", ".join(
              f"{a:.4f}/{v:.4f}" for (_, _, a), (_, _, v) in zip(
                  trainer.scalars["actor_loss"],
                  trainer.scalars["value_loss"]))
          + f"; substep_forward/substep_vjp launches {launches} | {card}")
    return trainer, launches


def split_epoch(trainer):
    """One more epoch, phase by phase (the host waits for the device after
    each): the window's forward, its backward + actor step, the critic.
    Returns milliseconds of each."""
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    (loss, outs), fwd_ms = timed(trainer.rollout)
    _, bwd_ms = timed(lambda: trainer.actor_step(loss))
    _, critic_ms = timed(lambda: trainer.critic_step(outs))
    return fwd_ms, bwd_ms, critic_ms


def time_kernels(name, chk, card):
    """Device and per-call times of K1 and K2 and of their plain versions
    at the check's shapes, and each kernel's bound. Returns {kernel: dict}
    of the JSON line's numbers."""
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk

    fargs, vargs = chk["fargs"], chk["vargs"]
    model = fargs[0]
    calls = {
        "substep_forward": (lambda: sk.substep_forward(*fargs),
                            lambda: lb.substep_lb(*fargs)),
        "substep_vjp": (lambda: sk.substep_vjp(*vargs),
                        lambda: lb.substep_vjp_lb(*vargs)),
    }
    out = {}
    with torch.no_grad():
        for kname in KERNELS:
            kernel, plain = calls[kname]
            dev_ms = statistics.median(device_ms(kernel, 50)
                                       for _ in range(7))
            call_ms = statistics.median(event_times(kernel, 100))
            plain_ms = graph_ms(plain)
            plain_call = statistics.median(event_times(plain, 10))
            if kname == "substep_forward":
                nbytes = sk.substep_forward_bytes(model, E)
                flops = sk.substep_forward_flops(model, E)
            else:
                nbytes = sk.substep_vjp_bytes(model, E)
                flops = sk.substep_vjp_flops(model, E, chk["n_active"])
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            out[kname] = dict(ms=dev_ms, plain_ms=plain_ms,
                              bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes >= t_ops
                              else "operations")
            active = (f" with {chk['n_active']} contacts active"
                      if kname == "substep_vjp" else "")
            phase("timing", f"{name} {kname} kernel {dev_ms * 1e3:.2f} "
                  f"us/launch on the device (median of 7 x 50 launches), "
                  f"{call_ms * 1e3:.2f} us per call; bound "
                  f"{max(t_bytes, t_ops) * 1e3:.3f} us ({nbytes} B, {flops} "
                  f"flop{active}); plain version {plain_ms:.3f} ms device "
                  f"(one CUDA graph), {plain_call:.3f} ms per call | {card}")
    return out


def time_refresh(name, chk, card):
    """Device and per-call times of the plain refresh substep and of one
    block's refresh replay (forward + autograd) of the reverse pass.
    Returns (refresh per call, replay per call) in ms."""
    from diffrl_tpu_torch.sim import articulation_lb as lb

    model, _, _, jat, _, h, H, _ = chk["fargs"]
    s1 = chk["step_state"][0]
    q, qd = s1.joint_q.T.contiguous(), s1.joint_qd.T.contiguous()
    gq, gqd = chk["vargs"][8], chk["vargs"][9]
    gH = torch.randn_like(H)

    def refresh():
        lb.refresh_substep_lb(model, q, qd, jat, None, h)

    def replay():
        leaves = [t.detach().requires_grad_() for t in (q, qd, jat)]
        with torch.enable_grad():
            r1, rd1, rH, _ = lb.refresh_substep_lb(model, *leaves, None, h)
            torch.autograd.grad((r1, rd1, rH), leaves, (gq, gqd, gH))

    with torch.no_grad():
        r_dev, rp_dev = graph_ms(refresh), graph_ms(replay)
        r_call = statistics.median(event_times(refresh, 10))
        rp_call = statistics.median(event_times(replay, 5))
    phase("timing", f"{name} refresh substep {r_dev:.3f} ms device (one "
          f"CUDA graph), {r_call:.3f} ms per call; refresh replay (forward "
          f"+ autograd) {rp_dev:.3f} ms device (one CUDA graph), "
          f"{rp_call:.3f} ms per call | {card}")
    return r_call, rp_call


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

    # 2. build: every library in one build_all (one nvcc each, together)
    menvs = {name: envs.make(name, num_envs=E, seed=0, stochastic_init=True,
                             episode_length=1000,
                             MM_caching_frequency=spec["mm"], device=dev)
             for name, spec in MODELS.items()}
    pmodel = prismatic_model()
    order = [(name, k) for name in MODELS for k in KERNELS]
    built = _build.build_all(
        [sk.kernel_source(menvs[name].model, k) for name, k in order]
        + [sk.kernel_source(pmodel)])
    sk.prepare_substep_forward(pmodel, dev, built=built[-1])
    occupancy = {}
    for (name, kname), b in zip(order, built):
        k = sk._prepare(kname, menvs[name].model, dev, b)
        a = sk.kernel_attributes(k)
        blocks, warps = a.resident(E)
        occupancy[name, kname] = (a.threads_per_env, warps)
        phase("build", f"{kname} for {name}: {b.seconds:.2f} s nvcc (all "
              f"builds together), ptxas {b.registers} registers, "
              f"{b.spill_store_bytes} B spill stores, "
              f"{b.spill_load_bytes} B spill loads, {b.stack_bytes} B "
              f"stack; loaded: {a.registers} registers, {a.local_bytes} B "
              f"local per thread; {a.threads_per_env} threads per env, "
              f"{a.envs_per_block} envs per block, {a.smem_bytes} B shared "
              f"memory per block, at most {a.max_blocks_per_sm} blocks per "
              f"SM; at E={E} {-(-E // a.envs_per_block)} blocks over "
              f"{a.sm_count} SMs: {blocks:.3f} blocks and {warps:.3f} warps "
              f"resident per SM")
        if b.spill_store_bytes or b.spill_load_bytes:
            raise RuntimeError(f"{kname} for {name} spills registers")
        if warps < 4.0:
            raise RuntimeError(f"{kname} for {name}: {warps:.3f} warps per "
                               f"SM at E={E}, fewer than 4")

    # 3-4. both kernels against their plain versions, per model, on the
    # card; the prismatic + revolute model (limits, no ground) for K1
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    checks = {name: check_model(name, menvs[name], gen) for name in MODELS}
    pe = 256
    pq0 = torch.rand((2, pe), generator=gen, device=dev) * 3 - 1.5
    pqd0 = torch.rand((2, pe), generator=gen, device=dev) * 2 - 1
    pja = torch.rand((2, pe), generator=gen, device=dev) * 10 - 5
    ph = 1.0 / 60.0 / 4
    with torch.no_grad():
        _, _, pH, pHinv = lb.refresh_substep_lb(pmodel, pq0, pqd0, pja, None,
                                                ph)
        a = sk.substep_forward(pmodel, pq0, pqd0, pja, None, ph, pH, pHinv)
        b = lb.substep_lb(pmodel, pq0, pqd0, pja, None, ph, pH, pHinv)
        err_p = max(assert_close("prismatic q", a[0], b[0], 2e-5, 2e-6),
                    assert_close("prismatic qd", a[1], b[1], 2e-5, 2e-5))
    phase("kernel", f"prismatic+revolute without ground E={pe}: K1 vs plain "
          f"max err {err_p:.3e}")

    # 5. dflex golden fixtures through the kernel path
    for name in FIXTURES:
        check_fixture(name, menvs[name].model, dev)

    # 6. the rollout path: policy rollout through batched_eval
    env = menvs["Ant"]
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
    phase("main", f"batched_eval Ant E={E} {EVAL_STEPS} steps "
          f"deterministic: {eval_s:.3f} s, {E * EVAL_STEPS / eval_s:.1f} "
          f"env-steps/s, mean reward {mean_rew:.4f}, mean length "
          f"{mean_len:.2f}, substep_forward launches {launches} | {card}")

    # 7. the training paths, then one more epoch of Ant and of Humanoid
    # split into its phases
    train_launches, splits = {}, {}
    for name in MODELS:
        trainer, train_launches[name] = train(name, dev, card)
        if name in ("Ant", "Humanoid"):
            splits[name] = split_epoch(trainer)
        del trainer
        torch.cuda.empty_cache()

    # 8. timings at the main path's shapes: device time with the host
    # queued ahead (median of repeated batches), per-call time as a caller
    # sees it (CUDA events around each call, host launch overhead included)
    times = {name: time_kernels(name, checks[name], card) for name in MODELS}
    replay_call = {name: time_refresh(name, checks[name], card)[1]
                   for name in ("Ant", "Humanoid")}
    s1, ja, acts = checks["Ant"]["step_state"]
    with torch.no_grad():
        s_call, g_call = (statistics.median(event_times(fn, n)) for fn, n in (
            (lambda: env.step(s1, acts), 10),
            (lambda: step_grad(env.model, *checks["Ant"]["gargs"],
                               plain=False), 5)))
        v_call = {name: statistics.median(event_times(
            lambda: sk.substep_vjp(*checks[name]["vargs"]), 100))
            for name in ("Ant", "Humanoid")}
    phase("timing", f"Ant env step {s_call:.3f} ms per call = 1 refresh + "
          f"{MM - 1} kernel launches + obs/reward/reset; training env step "
          f"(forward and backward of simulate) {g_call:.3f} ms per call | "
          f"{card}")
    for name, (fwd_ms, bwd_ms, critic_ms) in splits.items():
        mm = MODELS[name]["mm"]
        n_win = TRAIN_STEPS * (mm - 1)
        phase("timing", f"one {name} training epoch (E={E}, {TRAIN_STEPS} "
              f"steps, {mm} substeps), host waiting after each phase: "
              f"window forward {fwd_ms:.1f} ms, backward + actor step "
              f"{bwd_ms:.1f} ms (K2 {n_win} launches x "
              f"{v_call[name]:.3f} ms per call = "
              f"{n_win * v_call[name]:.1f} ms; refresh replays "
              f"{TRAIN_STEPS} x {replay_call[name]:.3f} ms per call = "
              f"{TRAIN_STEPS * replay_call[name]:.1f} ms), critic "
              f"{critic_ms:.1f} ms | {card}")

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

    kernels = []
    for name in MODELS:
        for i, kname in enumerate(KERNELS):
            tpe, warps = occupancy[name, kname]
            kernels.append({
                "name": kname if name == "Ant" else f"{kname}[{name}]",
                "model": name,
                "route": "cuda",
                "source": f"diffrl_tpu_torch/csrc/{kname}.cu",
                "replaces": "diffrl_tpu/sim/pallas_substep.py:"
                            + ("243" if kname == "substep_forward"
                               else "298"),
                "launches": train_launches[name][i],
                "max_abs_err": checks[name]["err_fwd" if i == 0
                                            else "err_vjp"],
                **times[name][kname],
                "library_ms": None,
                "threads_per_env": tpe,
                "warps_per_sm": warps,
            })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

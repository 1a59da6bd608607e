#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (diffrl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (several for the per-model phases); any failure
raises and the script exits non-zero:

1. device  -- needs CUDA; prints the card's name and power limit
              (nvidia-smi).
2. build   -- builds the cached-substep forward kernel (K1) and its adjoint
              kernel (K2) for Ant, Humanoid, Hopper, Cheetah, CartPole and
              SNU Humanoid, and K1 for a prismatic + revolute model, from
              csrc/ with nvcc for sm_90a,
              one nvcc process per library, all started together: seconds,
              registers per thread, spill and stack bytes; threads per env,
              envs per block, shared memory per block, and the blocks and
              warps resident per SM at E = 4096 (the card's occupancy query
              and the grid). Fails on spills and under 4 warps per SM.
3. kernel  -- per model at E = 4096 on a settled state with ground contacts
              active (CartPole has no ground; SNU Humanoid's muscles at
              activations in (0, 1) x strength): one cached substep, K1
              against its plain version substep_lb and float64 (q rtol 2e-5
              atol 2e-6, qd rtol 2e-5 atol 2e-5) and K2 against
              substep_vjp_lb and float64 (rtol 2e-4, atol 1e-5), the
              muscle activations' cotangent dma included; how many envs
              have a select within testing.SELECT_ULPS float32 units of
              its boundary, and the plain path's float32 rounding of the
              select arguments in those units (what SELECT_ULPS is set
              from); plus the prismatic + revolute model without ground (K1
              elementwise).
4. adjoint -- per model on the same state: one whole env step (Ant,
              Hopper, Cheetah 16 substeps, mm 16; Humanoid 48, mm 48;
              CartPole 4, mm 4; SNU Humanoid 48, mm 8), kernel path against
              plain path and float64 (rtol/atol 1e-4), and its gradient of
              a fixed weighted sum of (q', qd') w.r.t. (q, qd, joint_act,
              muscle activations), kernel path against plain path and
              float64 (rtol 1e-3, atol 1e-4).
              The rules are diffrl_tpu_torch/testing.py's: entry by entry
              no further from float64 than twice the float32 plain
              version's error plus rtol and a floor (8, Humanoid 90, SNU
              Humanoid 60) times
              the plain version's largest error in that env, the distance
              to the plain version reported; an env that breaks the rule
              while one of its named selects lies within
              testing.SELECT_ULPS float32 units of its boundary is at that
              boundary, counted apart and named with the select and its
              margin (articulation_lb.select_margins); a failing check
              saves the env's inputs under build/witness/
              (tools/replay_witness.py replays them); a whole Humanoid env
              step,
              chaotic in float32, per env at the median and the 90th
              percentile, at most twice the plain path's error (SNU
              Humanoid's whole step too).
   repeat  -- Ant, Humanoid and SNU Humanoid at E = 4096: the plain
              refresh substep, cached substep and both their VJPs, run
              twice on the same inputs, give the same bits (fixed-order
              sums, testing.check_repeatable).
5. fixture -- the kernel path against the dflex golden trajectories
              tests/fixtures/env_ant_mjcf.npz (40 steps of 16 substeps;
              atol 1e-5 on the first 15, 1e-4 on all),
              env_humanoid_mjcf.npz (16 steps of 48 substeps, mm 48; atol
              1e-4 on the first 15, 1e-3 on all), env_cartpole_urdf.npz (60
              steps of 4 substeps, mm 4; 1e-5 and 1e-4) and
              env_snu_muscles.npz (16 steps of 48 substeps, mm 48, the 152
              muscles at 0.05 of their peak force; 1e-4 and 1e-3); and the
              seven articulation scenes of tests/parity_scenes.py
              (pendulum2, pendulum2_mm1 on the plain path alone, cartpole,
              ball_joint, freefall_box, muscle_pendulum, arm7) at E = 1 at
              tests/test_parity.py's tolerances; and through simulate
              (no kernel) the particle scenes spring_particles,
              particle_ground and fem_block, and tests/test_coupled.py's
              coupled scene (its first 30 steps at 2e-5, all 40 at 3e-5;
              SCENE_TOL says why).
   engine  -- the particle, cloth, FEM and coupled engine at full width
              (sim/articulation.simulate, its backward by autograd through
              torch.utils.checkpoint): a 60 x 60 cloth (3,721 particles,
              7,200 triangles, hashed self-collision, bending) at E = 32
              dropped on a dome for 60 steps of 16 substeps, finite and
              resting on the dome; hashed against all-pairs at env 0's last
              state and at the sheet folded in half; the forces and their
              VJP twice, the same bits; the gradient of the mean height
              w.r.t. the velocities through 8 steps twice (the same bits)
              and against float64 (GRAD_REL in the 2-norm); the draped
              sheet has no self-contact, so the forces, VJP and gradient
              (8 steps) are held again on 4 envs of the sheet folded with
              its layers in contact, which must stay in contact at every
              step of the window. A 20 x
              10 x 10 soft grid (2,541 particles, 10,000 tets) at E = 32
              dropped on the ground, checked likewise, and one window of
              32 steps of simulate_xpbd. The coupled scene at E = 1,024
              (joint angles perturbed but for env 0) for 40 steps, env 0
              against the E = 1 run, and its gradient finite.
   backward-- Ant at E = 4096 from the settled state: one env step's
              gradient on each reverse pass of BACKWARDS, "lb" (K1, K2,
              replay), "lb_ad" (autograd through K1/K2 nodes and the
              refresh, no replay), "pallas" (the JAX package's name for
              the kernel path: the replay with K1 and K2), "manual" (the
              hand-written pass over the plain substeps) and "remat"
              (simulate), each against "remat" and float64 by
              testing.py's rules; per pass the largest per-env error
              against float64, K1's and K2's launches per step (15 and
              15 on the kernel paths, 0 on the others), and the
              simulator's forward + backward of one step: device time (one
              CUDA graph), time per call, peak memory ("pallas" runs the
              simulator of "lb", whose times it reports).
   timing  -- per engine scene and Ant's remat simulate: one env step's
              forward and forward + backward, device time (one CUDA graph
              of the call) and per call, peak memory, particle-substeps
              per second.
6. main    -- the rollout path: Ant with 4096 envs, mm 16, stochastic init,
              the SHAC Ant actor (128/64/32, ELU + LayerNorm) and obs_rms,
              batched_eval for 64 env steps of deterministic actions.
7. train   -- the training paths, one table (TRAINERS) and one harness,
              each through the trainer's train() from
              examples/cfg/<algo>/<cfg>: SHAC from
              shac/{ant,humanoid,hopper,cheetah,cartpole_swing_up,
              snu_humanoid}.yaml at 4096 envs x 32 steps (1 epoch each; K1
              and K2 launch 32 x (substeps / mm) x (mm - 1) times each per
              epoch: Humanoid 1,504, CartPole 96, SNU Humanoid 1,344); BPTT
              from bptt/ant.yaml (32 envs, steps_num cut from 1,000 to 50:
              K1 and K2 750 each) and cartpole_swing_up.yaml (64 envs,
              steps_num cut from 240 to 120: 360 each); PPO from
              ppo/ant.yaml (2048 x 32, minibatches of 16,384, 5
              mini-epochs: K1 480, K2 0); SAC from sac/ant.yaml (128 x 128,
              batch 4,096, ring of 999,936; num_seed_steps cut from 5 to
              1, then one learning epoch: K1 1,920 and K2 0 per epoch);
              SHAC Ant with diff_env.sim_backward lb_ad (4096 x 32, 1
              epoch: K1 480, K2 480); BPTT CartPole with algo lbfgs
              (optax's L-BFGS and zoom line search, 64 envs, steps_num
              cut from 240 to 32, 2 epochs: K1 and K2 (1 + probes) x 96
              per epoch, the probes printed); PPO Ant with an LSTM of 256
              units after its MLP (the builder path, 2048 x 32, seq_length
              4: K1 480, K2 0).
              Per epoch: seconds, env-steps/s, peak memory, host syncs
              and launches; finite statistics, a changed policy. After
              each path's epochs, one launch of K1 and of K2 at the
              path's own E on the trainer's last env state, held against
              the plain versions and float64 as in phases 3-4. One more
              epoch of SHAC Ant, Humanoid and SNU Humanoid, BPTT Ant and
              PPO Ant split into its phases.
   bandit  -- PPO's builder path on the contextual bandit of
              tests/test_builders.py (ToyBandit) at E = 4096: a
              categorical head on the one-hot observation, a conv trunk on
              the 6 x 6 image and a GRU, each trained with that test's
              config and held to its threshold on the deterministic
              evaluation reward (6, 4 and 2; random play earns 2).
   multi   -- data-parallel training over torch.distributed
              (diffrl_tpu_torch.parallel, the trainers' multi_gpu): SHAC
              Ant from shac/ant.yaml at 4096 envs as 2 ranks x 2048 and PPO
              Ant from ppo/ant.yaml at 2048 as 2 x 1024, each rank a process
              of its own (python3 chip_smoke.py --multi-rank ...) on the one
              card, gloo on CUDA tensors (NCCL refuses two ranks on one
              device), one epoch through train(); the ranks' statistics and
              parameters bit for bit equal, the first epoch's actor loss
              (PPO: loss and critic loss) and the policy's parameters
              after it (2-norm) at MULTI's bounds against the
              train phase's one-process first epoch; K1 and K2 launches
              per rank (SHAC 480 and 480, PPO 480 and 0) and seconds per
              epoch; every rank's exit code checked. Then SHAC Ant with
              multi_gpu at world size 1 on NCCL in this process, two
              epochs: the first against the one-process run as above, no
              host sync in the second.
   serve   -- the trained SHAC Ant policy saved (Trainer.save), built by
              utils.export.shac_policy_fn, exported with torch.export on
              the card, loaded and served by serve_policy's HTTP server in
              a thread; batches of 1, 64 and 4096 observations POSTed to
              /act, the actions held at 1e-6 against the trainer's actor;
              ms per request; a bad path and body refused.
   profile -- one SHAC Ant epoch under utils.profiling.trace() (CPU and
              CUDA activity): the top 15 device ops by time
              (summarize_trace), K1's and K2's kernels found by name, and
              the device-busy share of the traced window.
   render  -- after the main phase, its policy for 64 steps from a reset,
              env 0 into a .usda stage (render.UsdRenderer) and an HTML
              viewer (viewer.HtmlViewer); 64 frames in each.
8. timing  -- per model, device time per launch of both kernels (CUDA
              events with the host queued ahead), per-call times, the plain
              versions as CUDA graphs; for Ant, Humanoid and SNU Humanoid
              the refresh substep and its replay; bench.py-style
              random-action env-steps/s on Ant.

Before the last line it prints the nvidia-smi line and one JSON line with
each kernel's launches per model (over its SHAC training path's epochs,
and over each training path's epochs, by its TRAINERS label, and for Ant
per env step gradient on each reverse pass, per rank of each multi path,
the profiled epoch and the rendered steps in launches_by_path), errors,
times, bound,
threads per env and warps per SM; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

E = 4096
# the models on the port's paths: substeps per env step and the mass-matrix
# period of each config, zero-action env steps from env.reset() until
# ground contacts are active (CartPole has no ground), and training epochs
# from examples/cfg/shac/<cfg>. The training paths' depth is cut to keep
# the script well inside its time limit with the multi, serve and profile
# phases (about 150 s): SHAC Ant and Humanoid 1 epoch (not 2), BPTT Ant
# steps_num 50 (not 100) and BPTT CartPole 120 (not 240).
MODELS = {
    "Ant": dict(substeps=16, mm=16, settle=14, cfg="ant.yaml", epochs=1),
    "Humanoid": dict(substeps=48, mm=48, settle=12, cfg="humanoid.yaml",
                     epochs=1),
    "Hopper": dict(substeps=16, mm=16, settle=8, cfg="hopper.yaml",
                   epochs=1),
    "Cheetah": dict(substeps=16, mm=16, settle=16, cfg="cheetah.yaml",
                    epochs=1),
    "CartPoleSwingUp": dict(substeps=4, mm=4, settle=4,
                            cfg="cartpole_swing_up.yaml", epochs=1),
    "SNUHumanoid": dict(substeps=48, mm=8, settle=6, cfg="snu_humanoid.yaml",
                        epochs=1),
}
# the models whose epoch is split into its phases and whose refresh is timed
SPLIT = ("Ant", "Humanoid", "SNUHumanoid")
MM = MODELS["Ant"]["mm"]
SETTLE_STEPS = MODELS["Ant"]["settle"]
EVAL_STEPS = 64
TRAIN_STEPS = 32
BENCH_WARMUP, BENCH_STEPS = 5, 50
# timed runs device_ms makes before it gives up on getting the host ahead
DEVICE_MS_TRIES = 6
# the dflex golden trajectories (tests/parity_scenes.py): file, substeps
# (= mm) per step, the constant joint torques [D], the constant muscle
# activations of the env (or None), atol on the first 15 steps and on all
FIXTURES = {
    "Ant": ("env_ant_mjcf.npz", 16,
            lambda D: np.r_[np.zeros(6), 40.0 * np.sin(np.arange(D - 6))],
            None, 1e-5, 1e-4),
    "Humanoid": ("env_humanoid_mjcf.npz", 48,
                 lambda D: np.r_[np.zeros(6), 25.0 * np.sin(np.arange(D - 6))],
                 None, 1e-4, 1e-3),
    "CartPoleSwingUp": ("env_cartpole_urdf.npz", 4,
                        lambda D: np.r_[120.0, np.zeros(D - 1)], None, 1e-5,
                        1e-4),
    "SNUHumanoid": ("env_snu_muscles.npz", 48, np.zeros,
                    lambda env: [0.05 * m.peak_force
                                 for m in env.skeleton.muscles], 1e-4, 1e-3),
}
# the dflex scenes of tests/parity_scenes.py, at tests/test_parity.py's
# tolerances (atol on the first 30 steps, on all; joint or particle
# velocities at 20 times the second): the seven articulation-only ones
# through simulate_batched_lb (K1 on the card), the three particle scenes
# and tests/test_coupled.py's scene (coupled_scene; its fixture holds every
# 5th of 40 steps) through simulate. The coupled scene's float32 rounding
# grows over its 40 steps: the port missed its fixture by 1.097e-5 over
# the first 30 steps and 2.027e-5 (CPU) and 1.989e-5 (NVIDIA H100 80GB
# HBM3, 700 W) over all 40 (its float64 run by 5.2e-5: the fixture itself
# is a float32 run), so the first 30 steps are held at test_coupled.py's
# 2e-5 and all 40 at 3e-5
SCENES = ("pendulum2", "pendulum2_mm1", "cartpole", "ball_joint",
          "freefall_box", "muscle_pendulum", "arm7")
PARTICLE_SCENES = ("spring_particles", "particle_ground", "fem_block",
                   "coupled_regression")
SCENE_TOL = {"freefall_box": (1e-4, 5e-3), "fem_block": (1e-4, 5e-3),
             "coupled_regression": (2e-5, 3e-5)}
# the engine's scenes at full width (cloth_scene, fem_scene): envs, substeps
# per step, forward steps and the gradient's window of steps
CLOTH = dict(envs=32, substeps=16, steps=60, grad_steps=8)
FEM = dict(envs=32, substeps=16, steps=60, grad_steps=8, xpbd_steps=32)
COUPLED_ENVS = 1024
COUPLED_GRAD_STEPS = 8
# env 0 of the coupled batch against the E = 1 run, over all 40 steps: the
# two batch sizes round apart by 1.943e-5 at most (1.109e-5 over the first
# 30 steps; NVIDIA H100 80GB HBM3, 700 W)
COUPLED_BATCH_ATOL = 3e-5
# the sheet folded in half (folded_state) for the gradient through
# self-contact: envs, hash bucket capacity (no particle dropped at the
# window's start) and the window's steps
FOLD = dict(envs=4, capacity=16, grad_steps=8)
# the dome of cloth_scene (its radius, m), the distance the cloth may sink
# into the dome or the ground (m), and the float64 rule of the engine's
# gradients: the float32 gradient within GRAD_REL of the float64 one in the
# 2-norm. Over a window of stiff contacts a contact can start a substep
# apart in float32 and float64, and the particles it touches then take
# other gradients: on an NVIDIA H100 (700 W) the 60 x 60 cloth's gradient
# over 8 steps lay under 1e-3 from float64 in the 2-norm and up to 1.3e-2
# of the largest entry at its worst entry, the FEM block's under 3e-5 and
# 1.1e-3; the rule, set from those, holds against a wrong or non-finite
# gradient
SPHERE_R = 3.0
CLOTH_MARGIN = 0.05
GRAD_REL = 5e-3
# the training paths, from examples/cfg/<algo>/<cfg> through the trainer's
# train(): the model they run, the config's entries set here, epochs (SAC:
# its seed epoch, then a learning epoch) and K1 and K2 launches per epoch
# (steps x substeps / mm x (mm - 1)). SHAC runs every model at E envs x
# TRAIN_STEPS; the others run at the config's widths (num_actors,
# networks, substeps, mm, batch sizes), with the cuts made. The epochs of
# the paths marked "split" are followed by one more, split into phases.
TRAINERS = {
    **{f"SHAC {name}": dict(
        algo="shac", model=name, cfg=spec["cfg"],
        config=dict(num_actors=E, steps_num=TRAIN_STEPS),
        epochs=spec["epochs"], split=name in SPLIT,
        launches=(TRAIN_STEPS * spec["substeps"] // spec["mm"]
                  * (spec["mm"] - 1),) * 2)
       for name, spec in MODELS.items()},
    "BPTT Ant": dict(algo="bptt", model="Ant", cfg="ant.yaml",
                     config=dict(steps_num=50), epochs=1, split=True,
                     launches=(750, 750)),
    "BPTT CartPole": dict(algo="bptt", model="CartPoleSwingUp",
                          cfg="cartpole_swing_up.yaml",
                          config=dict(steps_num=120), epochs=1,
                          split=False, launches=(360, 360)),
    "PPO Ant": dict(algo="ppo", model="Ant", cfg="ant.yaml", config={},
                    epochs=1, split=True, launches=(480, 0)),
    "SAC Ant": dict(algo="sac", model="Ant", cfg="ant.yaml",
                    config=dict(num_seed_steps=1), epochs=2, split=False,
                    launches=(1920, 0)),
    # SHAC on the residual reverse pass: each cached substep an autograd
    # node of K1 and K2, no replay
    "SHAC Ant lb_ad": dict(algo="shac", model="Ant", cfg="ant.yaml",
                           config=dict(num_actors=E, steps_num=TRAIN_STEPS),
                           diff_env=dict(sim_backward="lb_ad"), epochs=1,
                           split=False, launches=(480, 480)),
    # optax's L-BFGS: every line-search probe re-runs the window forward
    # and backward, so K1 and K2 launch (1 + probes) x steps x (mm - 1)
    # times per epoch; steps_num cut from 240 to 32 to keep the row near a
    # minute (a 240-step window took 26.8 s forward and backward on the
    # card, and a search may take 8 probes)
    "BPTT CartPole L-BFGS": dict(algo="bptt", model="CartPoleSwingUp",
                                 cfg="cartpole_swing_up.yaml",
                                 config=dict(steps_num=32),
                                 algo_name="lbfgs", epochs=2, split=False,
                                 launches=(96, 96), per_probe=True),
    # the builder path: an LSTM of 256 units after ppo/ant.yaml's MLP,
    # minibatches of 4-step chunks
    "PPO Ant LSTM": dict(algo="ppo", model="Ant", cfg="ant.yaml",
                         config=dict(seq_length=4),
                         network=dict(rnn=dict(name="lstm", units=256,
                                               layers=1)),
                         epochs=1, split=False, launches=(480, 0)),
}
# the env's reverse passes (envs/base.DiffEnv): the replay pass through K1
# and K2 ("lb", and "pallas", the name of the JAX package's Pallas path,
# which takes it too), autograd through K1/K2 nodes and the refresh
# ("lb_ad"), the hand-written pass over the plain substeps ("manual") and
# checkpointed plain substeps ("remat")
BACKWARDS = ("lb", "lb_ad", "pallas", "manual", "remat")
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
    the device and not the host's launch overhead. When the device caught
    up all the same (a host slowed by other work), it tries again with a
    head start at least twice as long and twice the slowest issue seen, up
    to DEVICE_MS_TRIES times. Raises if the host never got ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    head_ms = 2.0 * (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 6)
    b.record()
    torch.cuda.synchronize()
    per_cycle = a.elapsed_time(b) / 10 ** 6
    for _ in range(DEVICE_MS_TRIES):
        torch.cuda._sleep(int(head_ms / per_cycle) + 10 ** 6)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        caught_up = b.query()
        torch.cuda.synchronize()
        if not caught_up:
            return a.elapsed_time(b) / n
        head_ms = 2.0 * max(head_ms, 2.0 * issue_ms)
    raise RuntimeError("device_ms: the device caught up with the host")


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


def plain_step(model, q, qd, ja, ma, h, mm, substeps):
    """One env step on the plain path only: per mass-matrix period, a
    refresh + (mm - 1) substep_lb (env-minor inputs; ma may be None)."""
    from diffrl_tpu_torch.sim.articulation_lb import (refresh_substep_lb,
                                                      substep_lb)
    for _ in range(substeps // mm):
        q, qd, H, Hinv = refresh_substep_lb(model, q, qd, ja, ma, h)
        for _ in range(mm - 1):
            q, qd = substep_lb(model, q, qd, ja, ma, h, H, Hinv)
    return q, qd


def settled_state(env, steps):
    """Joint coordinates after zero-action env steps from env.reset()."""
    s = env.reset()
    zero = torch.zeros((env.num_envs, env.num_acts), device=env.device)
    with torch.no_grad():
        for _ in range(steps):
            s, *_ = env.step(s, zero)
    return s


def controls(env, acts):
    """(joint_act [E, D], muscle activations [E, M] or None) of actions: a
    model driven by muscles alone gets zero joint torques, as the
    simulator fills them in."""
    ja, ma = env.action_to_controls(acts)
    if ja is None:
        ja = acts.new_zeros((acts.shape[0], env.model.dof_count))
    return ja, ma


def step_grad(model, q, qd, ja, ma, w_q, w_qd, mm, substeps, plain):
    """d/d(q, qd, joint_act[, muscle activations]) of <w_q, q'> +
    <w_qd, qd'> over one env step (env-leading [E, .] inputs), through
    simulate_batched_lb (K1 forward, K2 reverse) or, with ``plain``,
    autograd through refresh_substep_lb and substep_lb alone."""
    from diffrl_tpu_torch.sim.articulation_lb import simulate_batched_lb
    leaves = [x.detach().clone().requires_grad_()
              for x in (q, qd, ja, ma) if x is not None]
    lm = leaves[3] if ma is not None else None
    with torch.enable_grad():
        if plain:
            qt, qdt = plain_step(model, leaves[0].T, leaves[1].T,
                                 leaves[2].T, None if lm is None else lm.T,
                                 1.0 / 60.0 / substeps, mm, substeps)
            qn, qdn = qt.T, qdt.T
        else:
            qn, qdn = simulate_batched_lb(model, *leaves[:3], lm,
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


def hold(name, what, got, plain, exact, rtol, atol, whole_step=False,
         margins=None, witness=None):
    """A kernel's output against its plain version and float64 by the rules
    of diffrl_tpu_torch/testing.py: check_kernel (with the model's floor,
    the select margins that set envs at a select's boundary apart, and a
    witness of the inputs that a failure saves under build/witness/), and
    for a whole Humanoid or SNU Humanoid env step, whose float32 results
    are chaotic, check_env_distribution. Returns (max |got - plain|, a
    summary: entries off the plain version by check_vjp's bound, entries
    outside rtol/atol vs float64 kernel/plain, max error vs float64
    kernel/plain, least floor of the float64 rule, envs at a select's
    boundary with their selects and margins; or the per-env error
    quantiles)."""
    from diffrl_tpu_torch.testing import (check_env_distribution,
                                          check_kernel, f64_floor)

    if whole_step and name in ("Humanoid", "SNUHumanoid"):
        qs = check_env_distribution(f"{name} {what}", got, plain, exact)
        return float((got - plain).abs().max()), f"{what} per-env error " \
            "kernel/plain " + ", ".join(f"q{q:g} {k:.2e}/{p:.2e}"
                                        for q, (k, p) in qs.items())
    apart = []
    err, off, (a, b, c, d, n, nb) = check_kernel(
        f"{name} {what}", got, plain, exact, rtol, atol, f64_floor(name),
        margins, witness, apart)
    at = f" ({'; '.join(apart)})" if apart else ""
    return err, f"{what} {off} {a}/{b} {c:.2e}/{d:.2e} {n:.1e} {nb}{at}"


def hold_kernels(name, env, s, gen, what):
    """One launch each of K1 and K2 at ``env``'s own E, held against their
    plain versions and float64 by ``hold`` (the select margins and a
    witness passed): the plain refresh substep at the env state ``s`` under
    random actions from ``gen``, then one cached substep and its VJP under
    random cotangents from ``gen``. Also measures how near the selects lie
    to their boundaries: the envs with a select within SELECT_ULPS units,
    and the plain path's float32 rounding of the select arguments
    (articulation_lb.select_rounding, what SELECT_ULPS is set from).
    Prints one line; returns what the callers reuse."""
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.testing import substep_witness as witness

    model, n, ulps = env.model, env.num_envs, lb.SELECT_ULPS
    h = env.dt / env.sim_substeps
    acts = torch.rand((n, env.num_acts), generator=gen,
                      device=env.device) * 2 - 1
    ja, ma = controls(env, acts)
    jat = ja.T.contiguous()
    mat = ma.T.contiguous() if ma is not None else None
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()

    def f64(*xs):
        return [None if x is None else x.double() for x in xs]

    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(model, q, qd, jat, mat, h)
    gq = torch.randn(q1.shape, generator=gen, device=env.device)
    gqd = torch.randn(qd1.shape, generator=gen, device=env.device)
    fargs = (model, q1, qd1, jat, mat, h, H, Hinv)
    vargs = fargs + (gq, gqd)
    with torch.no_grad():
        n0 = (sk.substep_forward.launches, sk.substep_vjp.launches)
        kf = sk.substep_forward(*fargs)
        kv = sk.substep_vjp(*vargs)
        if (sk.substep_forward.launches, sk.substep_vjp.launches) != (
                n0[0] + 1, n0[1] + 1):
            raise RuntimeError(f"{name} {what}: the kernels did not launch")
        pf, pv = lb.substep_lb(*fargs), lb.substep_vjp_lb(*vargs)
        xf = lb.substep_lb(model, *f64(q1, qd1, jat, mat), h, *f64(H, Hinv))
        xv = lb.substep_vjp_lb(model, *f64(q1, qd1, jat, mat), h,
                               *f64(H, Hinv, gq, gqd))
    torch.cuda.synchronize()
    margins = lb.select_margins(model, q1, qd1)
    rounding = lb.select_rounding(model, q1, qd1)
    least = torch.stack(list(margins.values())).amin(0)
    near = {k: int((v <= ulps).sum()) for k, v in margins.items()
            if bool(torch.isfinite(v).any())}
    fwd = [hold(name, f"substep {lab}", k, p, x, 2e-5, atol, margins=margins,
                witness=witness(name, "substep_forward", i, fargs))
           for i, (lab, k, p, x, atol) in enumerate((
               ("q", kf[0], pf[0], xf[0], 2e-6),
               ("qd", kf[1], pf[1], xf[1], 2e-5)))]
    labs = ("dq", "dqd", "djoint_act", "dma", "dH")
    vjp = [hold(name, f"substep_vjp {lab}", kx, px, xx, 2e-4, 1e-5,
                margins=margins,
                witness=witness(name, "substep_vjp", i, vargs))
           for i, (lab, kx, px, xx) in enumerate(zip(labs, kv, pv, xv))
           if kx is not None]
    out = dict(fargs=fargs, vargs=vargs, acts=acts, ja=ja, ma=ma,
               n_active=sk.active_contacts(model, q1), near=near,
               n_near=int((least <= ulps).sum()), rounding=rounding,
               err_fwd=max(e for e, _ in fwd), err_vjp=max(e for e, _ in vjp))
    phase("kernel", f"{name} {what} E={n}, {out['n_active']} contacts "
          f"active: one cached substep, K1 vs plain max err "
          f"{out['err_fwd']:.3e} (rtol 2e-5, atol 2e-6/2e-5) and K2 vs plain "
          f"max err {out['err_vjp']:.3e} (rtol 2e-4, atol 1e-5); per output: "
          f"entries off the plain version by check_vjp's bound, vs float64 "
          f"entries outside rtol/atol kernel/plain, max err kernel/plain, "
          f"least floor of the 2x-plain rule, envs at a select's boundary: "
          + "; ".join(t for _, t in fwd + vjp) + f" | envs with a select "
          f"within SELECT_ULPS = {ulps:g} units: {out['n_near']} of "
          f"{n} (" + ", ".join(f"{k} {v}" for k, v in near.items())
          + "); the plain path's float32 rounding of the select arguments, "
          "max units: " + (", ".join(f"{k} {v:.2f}"
                                     for k, v in rounding.items()) or "none"))
    return out


def check_model(name, env, gen):
    """K1 and K2 against their plain versions on ``env`` (E envs) at a
    settled state with ground contacts active (where the model has a
    ground; hold_kernels), and one whole env step's values and gradient,
    kernel path against plain path. Returns what the timing phase reuses
    and the largest errors."""
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk

    model, mm = env.model, MODELS[name]["mm"]
    substeps = env.sim_substeps
    h = env.dt / substeps
    K = len(lb._plan_for(model, env.device).contact_rows)
    s1 = settled_state(env, MODELS[name]["settle"])
    chk = hold_kernels(name, env, s1, gen,
                       f"settled {MODELS[name]['settle']} steps")
    if K and chk["n_active"] < E:
        raise RuntimeError(f"{name}: only {chk['n_active']} ground contacts "
                           f"active over {E} envs: not settled")
    ja, ma, acts = chk["ja"], chk["ma"], chk["acts"]
    jat, mat = chk["fargs"][3], chk["fargs"][4]
    q, qd = s1.joint_q.T.contiguous(), s1.joint_qd.T.contiguous()

    def f64(*xs):
        return [None if x is None else x.double() for x in xs]

    with torch.no_grad():
        sq, sqd = lb.simulate_batched_lb(
            model, s1.joint_q, s1.joint_qd, ja, ma, dt=env.dt,
            substeps=substeps, mass_matrix_freq=mm)
        rs = plain_step(model, q, qd, jat, mat, h, mm, substeps)
        xs = plain_step(model, *f64(q, qd, jat, mat), h, mm, substeps)
    torch.cuda.synchronize()
    step = [hold(name, f"step {lab}", k, p, x, 1e-4, 1e-4, whole_step=True)
            for lab, k, p, x in (("q", sq.T, rs[0], xs[0]),
                                 ("qd", sqd.T, rs[1], xs[1]))]
    w_q = torch.randn(s1.joint_q.shape, generator=gen, device=env.device)
    w_qd = torch.randn(s1.joint_qd.shape, generator=gen, device=env.device)
    gargs = (s1.joint_q, s1.joint_qd, ja, ma, w_q, w_qd, mm, substeps)
    n0 = sk.substep_vjp.launches
    kg = step_grad(model, *gargs, plain=False)
    want = (substeps // mm) * (mm - 1)
    if sk.substep_vjp.launches - n0 != want:
        raise RuntimeError(f"{name}: the env step's reverse pass launched "
                           f"substep_vjp {sk.substep_vjp.launches - n0} "
                           f"times, expected {want}")
    pg = step_grad(model, *gargs, plain=True)
    xg = step_grad(model, *f64(*gargs[:6]), mm, substeps, plain=True)
    torch.cuda.synchronize()
    grad = [hold(name, f"env step {lab}", kx.T, px.T, xx.T, 1e-3, 1e-4,
                 whole_step=True)
            for lab, kx, px, xx in zip(("dq", "dqd", "djoint_act", "dma"),
                                       kg, pg, xg)]
    phase("adjoint", f"{name} E={E}: one env step ({substeps} substeps, mm "
          f"{mm}) kernel path vs plain max err "
          f"{max(e for e, _ in step):.3e}; vs float64 (rtol/atol 1e-4): "
          + "; ".join(t for _, t in step) + " | one env step grad kernel "
          f"path vs plain max err {max(e for e, _ in grad):.3e}; vs "
          f"float64 (rtol 1e-3 atol 1e-4): " + "; ".join(t for _, t in grad))
    return dict(chk, step_state=(s1, ja, acts), gargs=gargs)


def check_fixture(name, env, dev):
    """The kernel path (E = 1) against the dflex golden trajectory of
    ``name``: the fixture scene keeps the builder's gravity (-9.8), constant
    joint torques and, for SNU Humanoid, constant muscle activations."""
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk

    fname, ss, torques, muscles, early, full = FIXTURES[name]
    model = env.model
    fix = np.load(os.path.join(ROOT, "tests", "fixtures", fname))
    fmodel = dataclasses.replace(
        model, gravity=np.array([0.0, -9.8, 0.0], np.float32))
    D = model.dof_count
    fq = torch.as_tensor(model.joint_q_init, device=dev)[None]
    fqd = torch.zeros((1, D), device=dev)
    fja = torch.as_tensor(torques(D), dtype=torch.float32, device=dev)[None]
    fma = None if muscles is None else torch.as_tensor(
        muscles(env), dtype=torch.float32, device=dev)[None]
    traj = []
    launches0 = sk.substep_forward.launches
    with torch.no_grad():
        for _ in range(fix["joint_q"].shape[0]):
            fq, fqd = lb.simulate_batched_lb(fmodel, fq, fqd, fja, fma,
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


def coupled_scene():
    """tests/test_coupled.py's scene built with the port's builder: a
    2-link capsule pendulum with a 3 x 3 particle grid dropped onto it."""
    from diffrl_tpu_torch.sim.model import JOINT_REVOLUTE, ModelBuilder
    qi = (0.0, 0.0, 0.0, 1.0)
    b = ModelBuilder()
    b.add_articulation()
    parent = -1
    for X_pj in ((0.0, 1.0, 0.0, *qi), (0.6, 0.0, 0.0, *qi)):
        parent = b.add_link(parent, np.array(X_pj), axis=(0.0, 0.0, 1.0),
                            type=JOINT_REVOLUTE, damping=0.1)
        b.add_shape_capsule(parent, pos=(0.3, 0.0, 0.0), radius=0.08,
                            half_width=0.3, density=800.0, ke=1.0e4,
                            kd=100.0, kf=100.0, mu=0.5)
    b.joint_q[0] = 0.15
    b.joint_q[1] = -0.1
    for ix in range(3):
        for iz in range(3):
            b.add_particle((0.2 + 0.2 * ix, 1.35, -0.1 + 0.1 * iz),
                           (0.0, 0.0, 0.0), 0.1)
    return dataclasses.replace(b.finalize(), ground=True, contact_ke=1.0e4,
                               contact_kd=100.0, contact_kf=100.0,
                               contact_mu=0.5)


def _parity_scenes():
    spec_ = importlib.util.spec_from_file_location(
        "parity_scenes", os.path.join(ROOT, "tests", "parity_scenes.py"))
    scenes = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(scenes)
    return scenes.SCENES


def scene_run(name, device):
    """The dflex scene ``name`` of tests/parity_scenes.py (or
    "coupled_regression", tests/test_coupled.py's scene) built with the
    port's ModelBuilder and run at E = 1, against its golden trajectory at
    SCENE_TOL: the articulation scenes through simulate_batched_lb (its
    cached substeps through K1 on CUDA), the particle and coupled scenes
    through simulate. Returns (max error of joint_q or particle_q over the
    first 30 steps, over all, max error of the velocities the fixture
    holds, forward kernel launches)."""
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.sim.articulation import simulate
    from diffrl_tpu_torch.sim.articulation_lb import simulate_batched_lb
    from diffrl_tpu_torch.sim.model import ModelBuilder

    fix = np.load(os.path.join(ROOT, "tests", "fixtures", f"{name}.npz"))
    if name == "coupled_regression":
        scene = dict(substeps=4, steps=40, record=5)
        model, extra = coupled_scene(), {}
    else:
        scene = _parity_scenes()[name]
        b = ModelBuilder()
        extra = scene["build"](b, lambda p, q: np.concatenate(
            [np.asarray(p, float), np.asarray(q, float)]))
        model = dataclasses.replace(b.finalize(),
                                    ground=scene.get("ground", False),
                                    **scene.get("materials", {}))
    ma = extra.get("muscle_activation")
    ma = None if ma is None else torch.as_tensor(
        ma, dtype=torch.float32, device=device)[None]
    ss = scene.get("substeps", 4)
    mm = scene.get("mm_freq", ss)
    dt = scene.get("dt", 1.0 / 60.0)
    every = scene.get("record", 1)
    state = model.state(1, device)
    traj = {k: [] for k in fix.files}
    n0 = sk.substep_forward.launches
    with torch.no_grad():
        for i in range(scene.get("steps", 60)):
            if name in PARTICLE_SCENES:
                state = simulate(model, state, muscle_act=ma, dt=dt,
                                 substeps=ss, mass_matrix_freq=mm)
            else:
                q, qd = simulate_batched_lb(
                    model, state.joint_q, state.joint_qd, None, ma, dt=dt,
                    substeps=ss, mass_matrix_freq=mm)
                state = dataclasses.replace(state, joint_q=q, joint_qd=qd)
            if (i + 1) % every == 0:
                for k in traj:
                    traj[k].append(getattr(state, k)[0])
    early, full = SCENE_TOL.get(name, (1e-5, 1e-4))
    n_early = 30 // every
    errs = {}
    for k, v in traj.items():
        got = torch.stack(v).cpu().numpy()
        tol = (early, full) if k.endswith("_q") else (None, 20 * full)
        if tol[0] is not None:
            np.testing.assert_allclose(got[:n_early], fix[k][:n_early],
                                       atol=tol[0], err_msg=f"{name} {k}")
        np.testing.assert_allclose(got, fix[k], atol=tol[1],
                                   err_msg=f"{name} {k}")
        errs[k] = (float(np.abs(got[:n_early] - fix[k][:n_early]).max()),
                   float(np.abs(got - fix[k]).max()))
    pos = [e for k, e in errs.items() if k.endswith("_q")]
    vel = [e[1] for k, e in errs.items() if k.endswith("_qd")]
    return (max(e[0] for e in pos), max(e[1] for e in pos),
            max(vel, default=0.0), sk.substep_forward.launches - n0)


def host_syncs(fn):
    """(fn(), the host syncs torch's sync debug mode saw during it)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


class ToyBandit:
    """The contextual bandit of tests/test_builders.py (_ToyDiscreteEnv),
    in torch: each env's observation one-hot encodes which of 4 actions
    pays 1 (else 0) for 8 steps; then a new target. With ``image`` the
    one-hot is painted into the quadrants of a 6 x 6 x 1 image (NHWC).
    Targets are drawn from the env's generator. A random policy earns 2
    per episode, the best 8."""

    num_obs = 4
    num_acts = 4
    episode_length = 8

    def __init__(self, num_envs=16, image=False, seed=0, device="cuda"):
        self.num_envs = num_envs
        self.image = image
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if image:
            self.obs_shape = (6, 6, 1)

    def _targets(self):
        return torch.randint(0, self.num_acts, (self.num_envs,),
                             generator=self.generator, device=self.device)

    def reset(self):
        return dict(target=self._targets(),
                    progress=torch.zeros(self.num_envs, dtype=torch.int32,
                                         device=self.device))

    def batch_observations(self, state):
        onehot = torch.nn.functional.one_hot(
            state["target"], self.num_acts).to(torch.float32)
        if not self.image:
            return onehot
        quads = onehot.reshape(self.num_envs, 2, 1, 2, 1).expand(
            self.num_envs, 2, 3, 2, 3)
        return quads.reshape(self.num_envs, 6, 6, 1)

    def step(self, state, actions):
        rew = (actions == state["target"]).to(torch.float32)
        progress = state["progress"] + 1
        done = progress >= self.episode_length
        state = dict(target=torch.where(done, self._targets(),
                                        state["target"]),
                     progress=torch.where(done, torch.zeros_like(progress),
                                          progress))
        return state, self.batch_observations(state), rew, done, {}


def toy_ppo_cfg(network, num_envs=16, steps=8, epochs=30, **config_extra):
    """tests/test_builders.py's _ppo_cfg: PPO on ToyBandit."""
    config = dict(
        name="toy", num_actors=num_envs, steps_num=steps,
        minibatch_size=num_envs * steps // 2, mini_epochs=2,
        learning_rate=5e-3, lr_schedule="constant", gamma=0.9, tau=0.95,
        normalize_input=False, normalize_value=False, save_frequency=0,
        max_epochs=epochs, **config_extra)
    return {"params": {"diff_env": {"name": "unused"}, "network": network,
                       "config": config,
                       "general": {"logdir": tempfile.mkdtemp(
                           prefix="chip_smoke_toy_"), "seed": 0}}}


# the bandit smokes of tests/test_builders.py: the network, the envs and
# epochs there, and the least deterministic evaluation reward it holds the
# JAX trainer to
BANDITS = {
    "discrete": ({"mlp": {"units": [32]}, "space": {"discrete": {}}},
                 dict(num_envs=16, epochs=30), False, 6.0),
    "cnn": ({"cnn": {"convs": [{"filters": 4, "kernel_size": 3,
                                "strides": 2}], "activation": "relu"},
             "mlp": {"units": [16]}, "space": {"discrete": {}}},
            dict(num_envs=8, epochs=25), True, 4.0),
    "gru": ({"mlp": {"units": [16]}, "rnn": {"name": "gru", "units": 8},
             "space": {"discrete": {}}},
            dict(num_envs=8, epochs=10, seq_length=4), False, 2.0),
}


def bandit(kind, device, num_envs=None):
    """PPO with BANDITS[kind]'s network trained on ToyBandit (at
    ``num_envs`` envs when given); returns (trainer, deterministic
    evaluation reward, seconds). Raises below the threshold."""
    from diffrl_tpu_torch.algorithms import PPO

    net, kw, image, least = BANDITS[kind]
    kw = dict(kw, num_envs=num_envs or kw["num_envs"])
    cfg = toy_ppo_cfg(net, **kw)
    t0 = time.perf_counter()
    ppo = PPO(cfg, env=ToyBandit(kw["num_envs"], image=image, device=device))
    ppo.train()
    rew, _ = ppo.evaluate_policy(1, deterministic=True)
    shutil.rmtree(cfg["params"]["general"]["logdir"])
    if not rew > least:
        raise RuntimeError(f"PPO {kind} on the bandit: evaluation reward "
                           f"{rew} (JAX's test holds {least}; random 2)")
    return ppo, rew, time.perf_counter() - t0


def trainer_params(trainer):
    for attr in ("actor", "network"):
        if hasattr(trainer, attr):
            return list(getattr(trainer, attr).parameters())
    raise AttributeError("no actor")


def trainer_cfg(label, **extra):
    """The config of TRAINERS[label] (examples/cfg/<algo>/<cfg> with the
    row's entries set, a fresh log directory, seed 0, no checkpoints but
    the final one) with ``extra``'s config entries; and the entries changed
    from the file."""
    import yaml

    spec = TRAINERS[label]
    with open(os.path.join(ROOT, "examples", "cfg", spec["algo"],
                           spec["cfg"])) as f:
        cfg = yaml.safe_load(f)
    config = cfg["params"]["config"]
    changed = [f"{k} {config.get(k)} -> {v}"
               for k, v in spec["config"].items() if config.get(k) != v]
    for key in ("diff_env", "network"):
        for k, v in spec.get(key, {}).items():
            changed.append(f"{key}.{k} {cfg['params'][key].get(k)} -> {v}")
            cfg["params"][key][k] = v
    if "algo_name" in spec:
        changed.append(f"algo.name {cfg['params']['algo']['name']} -> "
                       f"{spec['algo_name']}")
        cfg["params"]["algo"]["name"] = spec["algo_name"]
    cfg["params"]["general"] = {
        "logdir": tempfile.mkdtemp(prefix="chip_smoke_trainer_"), "seed": 0}
    config.update(max_epochs=spec["epochs"], save_interval=0,
                  save_frequency=0, **spec["config"])
    config.update(extra)
    return cfg, changed


def make_trainer(label, cfg, dev):
    from diffrl_tpu_torch.algorithms import BPTT, PPO, SAC, SHAC

    cls = {"shac": SHAC, "bptt": BPTT, "ppo": PPO,
           "sac": SAC}[TRAINERS[label]["algo"]]
    return cls(cfg, device=dev)


def flat_params(trainer):
    return torch.cat([p.detach().reshape(-1)
                      for p in trainer_params(trainer)])


def train(label, dev, card, gen):
    """The epochs of TRAINERS[label] through the trainer's train(), with the
    launch counts set to 0 just before and read just after, and read per
    epoch as well; then K1 and K2 held against their plain versions at the
    trainer's own E on its last env state (hold_kernels). Returns (trainer,
    [per epoch: dict of seconds, peak GB, host syncs, launches, the policy's
    parameters after it and its statistics]) and checks the launch counts,
    finite statistics and a changed policy."""
    from diffrl_tpu_torch.sim import substep_kernels as sk

    spec = TRAINERS[label]
    cfg, changed = trainer_cfg(label)
    logdir = cfg["params"]["general"]["logdir"]
    trainer = make_trainer(label, cfg, dev)
    before = [p.detach().clone() for p in trainer_params(trainer)]
    train_epoch = trainer.train_epoch
    records = []

    def recorded(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n = (sk.substep_forward.launches, sk.substep_vjp.launches)
        t = time.perf_counter()
        out, syncs = host_syncs(lambda: train_epoch(*args, **kwargs))
        torch.cuda.synchronize()
        records.append(dict(
            s=time.perf_counter() - t,
            gb=torch.cuda.max_memory_allocated() / 1e9, syncs=syncs,
            launches=(sk.substep_forward.launches - n[0],
                      sk.substep_vjp.launches - n[1]),
            params=flat_params(trainer).clone(),
            probes=getattr(getattr(trainer, "actor_opt", None),
                           "linesearch_steps", None)))
        return out

    trainer.train_epoch = recorded
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
    trainer.train()
    launches = (sk.substep_forward.launches, sk.substep_vjp.launches)
    trainer.train_epoch = train_epoch
    shutil.rmtree(logdir)
    expected = [tuple((1 + r["probes"] if spec.get("per_probe") else 1) * n
                      for n in spec["launches"]) for r in records]
    if [r["launches"] for r in records] != expected or launches != tuple(
            map(sum, zip(*expected))):
        raise RuntimeError(f"{label} launched (substep_forward, substep_vjp) "
                           f"{[r['launches'] for r in records]} per epoch, "
                           f"expected {expected}")
    stats = {k: [v for _, _, v in trainer.scalars[k]]
             for k in ("actor_loss", "value_loss", "loss", "a_loss",
                       "c_loss", "kl", "lr", "alpha") if k in trainer.scalars}
    for i, r in enumerate(records):
        r["stats"] = {k: v[i] for k, v in stats.items()}
    if not stats or not all(math.isfinite(v) for vs in stats.values()
                            for v in vs):
        raise RuntimeError(f"{label} statistics {stats}")
    if "lr" in stats and not 1e-6 <= stats["lr"][-1] <= 1e-2:
        raise RuntimeError(f"{label} learning rate {stats['lr']}")
    if all(torch.equal(a, b) for a, b in zip(before,
                                             trainer_params(trainer))):
        raise RuntimeError(f"{label} training left the policy unchanged")
    E_, H_ = trainer.num_envs, getattr(trainer, "steps_num", None) or \
        trainer.steps_per_epoch
    env = trainer.env
    phase("train", f"{label} from examples/cfg/{spec['algo']}/{spec['cfg']}"
          f" E={E_} x {H_} steps, {env.sim_substeps} substeps, mm "
          f"{env.mm_caching_frequency}" + (f", config changed: "
                                           f"{', '.join(changed)}"
                                           if changed else "")
          + f", {spec['epochs']} epochs (the first builds): per epoch "
          + "; ".join(
              f"{r['s']:.3f} s, {E_ * H_ / r['s']:.1f} env-steps/s, peak "
              f"{r['gb']:.3f} GB, {r['syncs']} host syncs in train_epoch "
              f"(+1 for its statistics), launches {r['launches']}"
              + (f", {r['probes']} line-search probes" if spec.get(
                  "per_probe") else "")
              for r in records) + "; " + ", ".join(
              f"{k} {v[-1]:.5g}" for k, v in stats.items())
          + f" | {card}")
    with torch.no_grad():
        hold_kernels(spec["model"], env, trainer.env_state.detach(), gen,
                     f"{label} after training")
    return trainer, records


def split(label, trainer):
    """One more epoch of a trainer, phase by phase (the host waits for the
    device after each): SHAC's window forward, its backward + actor step
    and the critic; BPTT's window forward and its backward + optimizer
    step; PPO's rollout and its update. Returns {phase: ms} and the host
    syncs in the phases (the model's plan and kernel constants are built by
    now: the first epoch's syncs upload them)."""
    syncs = []

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, n = host_syncs(fn)
        torch.cuda.synchronize()
        syncs.append(n)
        return out, (time.perf_counter() - t) * 1e3

    algo = TRAINERS[label]["algo"]
    if algo == "shac":
        (loss, outs), fwd = timed(trainer.rollout)
        _, bwd = timed(lambda: trainer.actor_step(loss))
        _, critic = timed(lambda: trainer.critic_step(outs))
        parts = {"window forward": fwd, "backward + actor step": bwd,
                 "critic": critic}
    elif algo == "bptt":
        (loss, _), fwd = timed(trainer.rollout)

        def backward():
            trainer.actor_opt.zero_grad(set_to_none=True)
            loss.backward()
            trainer.apply_actor_grads()
        _, bwd = timed(backward)
        parts = {"window forward": fwd, "backward + Adam step": bwd}
    else:
        (outs, last), roll = timed(trainer.play_steps)
        _, upd = timed(lambda: trainer.update(outs, last))
        parts = {"rollout": roll, "GAE + minibatch updates": upd}
    return parts, sum(syncs)


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

    model, _, _, jat, mat, h, H, _ = chk["fargs"]
    s1 = chk["step_state"][0]
    q, qd = s1.joint_q.T.contiguous(), s1.joint_qd.T.contiguous()
    gq, gqd = chk["vargs"][8], chk["vargs"][9]
    gH = torch.randn_like(H)

    def refresh():
        lb.refresh_substep_lb(model, q, qd, jat, mat, h)

    def replay():
        leaves = [t.detach().requires_grad_() for t in (q, qd, jat, mat)
                  if t is not None]
        with torch.enable_grad():
            r1, rd1, rH, _ = lb.refresh_substep_lb(
                model, *leaves[:3], leaves[3] if mat is not None else None,
                h)
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


def cloth_scene(dim=60, cell=0.2):
    """A dim x dim cloth of cell-m squares (at 60: 3,721 particles, 7,200
    triangles) with bending and hashed self-collision, 0.2 m above a static
    dome (a sphere of radius 3 m centred on the ground) and the ground. The
    cells stay wider than the self-collision radius (0.1 m) times sqrt(2),
    so a flat sheet does not collide with itself; the hash cell (0.3 m) is
    at least 0.1 m plus the triangles' centroid-to-vertex distance, so the
    hashed forces equal all-pairs while no bucket overflows."""
    from diffrl_tpu_torch.sim.model import ModelBuilder
    half = dim * cell / 2
    b = ModelBuilder()
    b.add_cloth_grid(pos=(-half, SPHERE_R + 0.2, half),
                     rot=(-math.sqrt(0.5), 0.0, 0.0, math.sqrt(0.5)),
                     vel=(0.0, 0.0, 0.0), dim_x=dim, dim_y=dim, cell_x=cell,
                     cell_y=cell, mass=0.2)
    b.add_shape_sphere(-1, radius=SPHERE_R, density=0.0)
    return dataclasses.replace(
        b.finalize(), tri_ke=1e4, tri_ka=1e4, edge_ke=100.0, edge_kd=1.0,
        enable_tri_collisions="hashed", tri_collision_cell_size=0.3,
        tri_collision_buckets=32768, tri_collision_capacity=8)


def fem_scene(dims=(20, 10, 10)):
    """A soft grid of 0.1 m cells (at 20 x 10 x 10: 2,541 particles, 10,000
    tets, 2,000 surface triangles) dropped from 0.2 m onto the ground, with
    tests/parity_scenes.py's fem_block materials."""
    from diffrl_tpu_torch.sim.model import ModelBuilder
    b = ModelBuilder()
    b.add_soft_grid(pos=(-0.05 * dims[0], 0.2, -0.05 * dims[2]),
                    rot=(0.0, 0.0, 0.0, 1.0), vel=(0.0, 0.0, 0.0),
                    dim_x=dims[0], dim_y=dims[1], dim_z=dims[2], cell_x=0.1,
                    cell_y=0.1, cell_z=0.1, density=100.0, k_mu=1000.0,
                    k_lambda=1000.0, k_damp=5.0)
    return dataclasses.replace(b.finalize(), ground=True, contact_ke=1.0e3,
                               contact_kd=10.0, contact_kf=100.0,
                               contact_mu=0.5)


def run_steps(model, state, steps, substeps, xpbd=False, mm=None):
    """``steps`` env steps of simulate (or simulate_xpbd) without
    gradients."""
    from diffrl_tpu_torch.sim.articulation import simulate, simulate_xpbd
    with torch.no_grad():
        for _ in range(steps):
            state = (simulate_xpbd(model, state, substeps=substeps) if xpbd
                     else simulate(model, state, substeps=substeps,
                                   mass_matrix_freq=mm or substeps))
    return state


def loss_grad(model, state, steps, substeps, leaves, act=None, mm=None):
    """The mean final particle height plus the sum of the final joint
    angles over ``steps`` steps of simulate (its remat backward), and its
    gradient w.r.t. the State fields named in ``leaves`` (and the joint
    torques ``act``, when given), in state's dtype."""
    from diffrl_tpu_torch.sim.articulation import simulate
    xs = [getattr(state, k).detach().clone().requires_grad_()
          for k in leaves]
    if act is not None:
        xs.append(act.detach().clone().requires_grad_())
    s = dataclasses.replace(state, **dict(zip(leaves, xs)))
    with torch.enable_grad():
        for _ in range(steps):
            s = simulate(model, s, joint_act=None if act is None else xs[-1],
                         substeps=substeps, mass_matrix_freq=mm or substeps)
        loss = s.joint_q.sum()
        if s.particle_q is not None:
            loss = loss + s.particle_q[..., 1].mean()
        return loss.detach(), torch.autograd.grad(loss, xs)


def to_dtype(state, dtype):
    return dataclasses.replace(state, **{
        k: getattr(state, k).to(dtype)
        for k in ("joint_q", "joint_qd", "particle_q", "particle_qd")})


def hold_grad(label, model, state, steps, substeps, leaves, act=None,
              mm=None):
    """The gradient of loss_grad twice (the same bits) and in float64:
    finite, and its error within GRAD_REL of the float64 gradient in the
    2-norm. Returns (loss, that relative error, the largest entry's error
    over the largest float64 entry, seconds)."""
    t0 = time.perf_counter()
    loss, g1 = loss_grad(model, state, steps, substeps, leaves, act, mm)
    _, g2 = loss_grad(model, state, steps, substeps, leaves, act, mm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
        raise RuntimeError(f"{label}: two gradient runs differ")
    _, g64 = loss_grad(model, to_dtype(state, torch.float64), steps,
                       substeps, leaves,
                       None if act is None else act.double(), mm)
    diff = torch.cat([(a.double() - x).reshape(-1) for a, x in zip(g1, g64)])
    ref = torch.cat([x.reshape(-1) for x in g64])
    rel = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref))
    worst = float(diff.abs().max() / ref.abs().max())
    if not all(torch.isfinite(a).all() for a in g1) or rel > GRAD_REL:
        raise RuntimeError(f"{label}: gradient off float64 by {rel:.3e} "
                           f"in the 2-norm (rel {GRAD_REL}); the largest "
                           f"entry by {worst:.3e} of the largest")
    return float(loss), rel, worst, time.perf_counter() - t0


def timed_ms(fn, n):
    """(device ms per call, ms per call as a caller sees it) of one engine
    call. The device time is always one CUDA graph of the call (graph_ms),
    whatever the host's speed in this run: the engine's calls are hundreds
    of launches each, and the FEM, coupled and Ant steps launch-bound. A
    call that cannot be captured raises."""
    call = statistics.median(event_times(fn, n, warmup=1))
    return graph_ms(fn, reps=n), call


def time_engine(label, model, state, substeps, leaves, card, n=3, mm=None,
                act=None):
    """One env step's forward and forward + backward (loss_grad over one
    step): device and per-call ms, peak memory of the backward, and
    particle-substeps per second of the forward. Prints one line."""
    E = state.joint_q.shape[0]
    P = 0 if state.particle_q is None else state.particle_q.shape[1]
    fwd = timed_ms(lambda: run_steps(model, state, 1, substeps, mm=mm), n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bwd = timed_ms(lambda: loss_grad(model, state, 1, substeps, leaves, act,
                                     mm), n)
    gb = torch.cuda.max_memory_allocated() / 1e9
    phase("timing", f"{label} E={E}, {substeps} substeps: one env step "
          f"forward {fwd[0]:.3f} ms device (one CUDA graph), {fwd[1]:.3f} "
          f"ms per call" + (f", {E * P * substeps / fwd[0] * 1e3:.4g} "
                            f"particle-substeps/s" if P else "")
          + f"; forward + backward {bwd[0]:.3f} ms device (one CUDA graph), "
          f"{bwd[1]:.3f} ms per call, peak {gb:.3f} GB | {card}")
    return dict(fwd=fwd, bwd=bwd, gb=gb)


def time_hashed(model, state, substeps, card):
    """The hashed self-collision's share of a cloth substep: device ms of
    eval_triangles_contact_hashed, of particle_forces (every force
    family) and of one substep (forces and integration), forward only."""
    from diffrl_tpu_torch.sim import particles as part
    x, v = state.particle_q, state.particle_qd
    with torch.no_grad():
        ms = [timed_ms(fn, 5)[0] for fn in (
            lambda: part.eval_triangles_contact_hashed(model, x, v),
            lambda: part.particle_forces(model, x, v),
            lambda: run_steps(model, state, 1, 1))]
    phase("timing", f"cloth E={x.shape[0]} one substep {ms[2]:.3f} ms "
          f"device (one CUDA graph each): particle forces {ms[1]:.3f} "
          f"ms, of which the hashed self-collision {ms[0]:.3f} ms "
          f"({100 * ms[0] / ms[2]:.1f} % of the substep) | {card}")
    return ms


def with_velocities(model, n, dev, gen, sigma):
    """``n`` envs at the Model's initial state, the particle velocities drawn
    N(0, sigma) from ``gen``."""
    s = model.state(n, dev)
    noise = torch.randn(s.particle_qd.shape, generator=gen, device=dev)
    return dataclasses.replace(s, particle_qd=s.particle_qd + sigma * noise)


def fold(model, x, gen):
    """The sheet x [P, 3] folded in half across its middle with its layers
    apart by up to 0.04 m (tools/bench_tri_collision.py's fold): cells stay
    cloth-sized while the layers lie inside each other's contact radius."""
    x0 = torch.as_tensor(model.particle_q_init, device=x.device)
    mid = (x0[:, 0].max() + x0[:, 0].min()) / 2
    out = x0.clone()
    out[:, 0] = (x0[:, 0] - mid).abs()
    out[:, 1] += 0.03 * torch.sin(x0[:, 2] * 17.0) + 0.01 * torch.randn(
        x0.shape[0], generator=gen, device=x.device)
    return out


def folded_state(model, n, dev, gen, sigma=0.1):
    """``n`` envs of the sheet folded in half across its middle, the
    folded half one self-collision radius (0.1 m) above the other, so that
    the layers start in contact and the fold's crease presses them
    together; the particle velocities drawn N(0, sigma) from ``gen``."""
    s = with_velocities(model, n, dev, gen, sigma)
    x0 = s.particle_q[0]
    mid = (x0[:, 0].max() + x0[:, 0].min()) / 2
    x = x0.clone()
    x[:, 0] = (x0[:, 0] - mid).abs()
    x[:, 1] += torch.where(x0[:, 0] < mid, 0.1, 0.0)
    return dataclasses.replace(s, particle_q=x.expand(n, -1, -1).clone())


def self_contacts(model, state):
    """Particles with a nonzero hashed self-collision force, over all envs
    of ``state``."""
    from diffrl_tpu_torch.sim import particles as part
    with torch.no_grad():
        f = part.eval_triangles_contact_hashed(model, state.particle_q,
                                               state.particle_qd)
    return int((f.abs().amax(-1) > 0).sum())


def check_cloth(dev, card, gen, dim=60, envs_=None, steps=None):
    """Phase 2: the cloth at full width (cloth_scene) for CLOTH's steps at
    E envs, finite and resting on the dome; the hashed self-collision
    against all-pairs at the last state of env 0 and at the sheet folded in
    half (``fold``, many contacts; capacity 27 so that no bucket
    overflows), the particle forces and their VJP twice (the same bits),
    and the gradient of the mean height through CLOTH's window
    (hold_grad). The draped sheet has no self-contact, so the forces, the
    VJP and the gradient are held again on FOLD's envs of the sheet folded
    with its layers in contact (folded_state), which must keep particles
    in contact at every step of the gradient's window."""
    from diffrl_tpu_torch.sim import particles as part
    E_ = envs_ or CLOTH["envs"]
    model = cloth_scene(dim)
    state = with_velocities(model, E_, dev, gen, 0.1)
    t0 = time.perf_counter()
    state = run_steps(model, state, steps or CLOTH["steps"],
                      CLOTH["substeps"])
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    x = state.particle_q
    r = torch.linalg.vector_norm(x, dim=-1)
    if not (torch.isfinite(x).all() and torch.isfinite(state.particle_qd)
            .all()):
        raise RuntimeError("cloth: non-finite state")
    depth, top = float((SPHERE_R - r).max()), float(x[..., 1].amax(1).min())
    if depth > CLOTH_MARGIN or top < SPHERE_R - CLOTH_MARGIN or \
            float(x[..., 1].min()) < -CLOTH_MARGIN:
        raise RuntimeError(f"cloth: not resting on the dome: {depth:.4f} m "
                           f"inside it, highest particle {top:.4f} m, "
                           f"lowest {float(x[..., 1].min()):.4f} m")
    table = part.hash_table(model, x)[0]
    kept = int((table < x.shape[1]).sum())
    folded = fold(model, x[0], gen)
    wide = dataclasses.replace(model, tri_collision_capacity=27)
    hashed = []
    for m, x0 in ((model, x[:1]), (wide, folded[None])):
        kept0 = int((part.hash_table(m, x0)[0] < x0.shape[1]).sum())
        if m is wide and kept0 < x0.shape[1]:
            raise RuntimeError(f"cloth: the folded sheet overflows the "
                               f"hash table ({kept0} of {x0.shape[1]} kept)")
        with torch.no_grad():
            f_hash = part.eval_triangles_contact_hashed(m, x0, state
                                                        .particle_qd[:1])
            f_all = part.eval_triangles_contact(m, x0, state.particle_qd[:1])
        torch.cuda.synchronize()
        np.testing.assert_allclose(f_hash.cpu().numpy(),
                                   f_all.cpu().numpy(), rtol=1e-3,
                                   atol=1e-2, err_msg="cloth hashed")
        hashed.append((float((f_hash - f_all).abs().max()),
                       int((f_all.abs().amax(-1) > 0).sum()), kept0))
    if hashed[1][1] == 0:
        raise RuntimeError("cloth: no self-contact on the folded sheet")
    fmodel = dataclasses.replace(model, tri_collision_capacity=FOLD[
        "capacity"])
    fstate = folded_state(fmodel, FOLD["envs"], dev, gen)
    kept_f = int((part.hash_table(fmodel, fstate.particle_q)[0]
                  < fstate.particle_q.shape[1]).sum())
    if kept_f < fstate.particle_q.numel() // 3:
        raise RuntimeError(f"cloth: the folded sheets overflow the hash "
                           f"table ({kept_f} kept)")
    for m, st in ((model, state), (fmodel, fstate)):
        reps = []
        for _ in range(2):
            xs = [t.detach().clone().requires_grad_()
                  for t in (st.particle_q, st.particle_qd)]
            with torch.enable_grad():
                f = part.particle_forces(m, *xs)
                reps.append((f.detach(),) + torch.autograd.grad(
                    f, xs, torch.ones_like(f)))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*reps)):
            raise RuntimeError("cloth: particle forces or their VJP differ "
                               "run to run")
    checks_s = time.perf_counter() - t0 - fwd_s
    g = hold_grad("cloth", model, state, CLOTH["grad_steps"],
                  CLOTH["substeps"], ("particle_qd",))
    contacts, s_ = [self_contacts(fmodel, fstate)], fstate
    for _ in range(FOLD["grad_steps"]):
        s_ = run_steps(fmodel, s_, 1, CLOTH["substeps"])
        contacts.append(self_contacts(fmodel, s_))
    if min(contacts) == 0:
        raise RuntimeError(f"cloth: the folded sheets lose their "
                           f"self-contact in the gradient's window: "
                           f"{contacts} particles in contact per step")
    g_f = hold_grad("folded cloth", fmodel, fstate, FOLD["grad_steps"],
                    CLOTH["substeps"], ("particle_qd",))
    phase("engine", f"cloth {dim}x{dim} ({x.shape[1]} particles, "
          f"{model.tri_indices.shape[0]} triangles, hashed self-collision, "
          f"bending, dome, ground) E={E_}: {steps or CLOTH['steps']} steps of "
          f"{CLOTH['substeps']} substeps in {fwd_s:.3f} s, finite, depth "
          f"into the dome {depth:.4f} m (< 0: none), highest particle "
          f"{top:.4f} m "
          f"(dome top {SPHERE_R} m, margin {CLOTH_MARGIN} m); hash table "
          f"keeps {kept} of {x.numel() // 3} particles; hashed vs "
          f"all-pairs (rtol 1e-3, atol 1e-2) at env 0's last state max |df| "
          f"{hashed[0][0]:.3e} over {hashed[0][1]} particles in contact "
          f"({hashed[0][2]} kept), at the sheet folded in half (capacity 27) "
          f"{hashed[1][0]:.3e} over {hashed[1][1]} particles in contact "
          f"({hashed[1][2]} kept); forces and VJP twice: the same "
          f"bits ({checks_s:.2f} s); d mean height / d velocities over "
          f"{CLOTH['grad_steps']} steps: twice the same bits, vs float64 "
          f"{g[1]:.3e} in the 2-norm (rel {GRAD_REL}), the largest entry "
          f"{g[2]:.3e} of the largest, {g[3]:.2f} s; folded in half "
          f"(E={FOLD['envs']}, capacity {FOLD['capacity']}, {kept_f} "
          f"kept): forces and VJP twice the same bits; particles in "
          f"self-contact at the start of each of {FOLD['grad_steps']} "
          f"steps and at the end {contacts}; d mean height / d velocities "
          f"over them: twice the same bits, vs float64 {g_f[1]:.3e} in the "
          f"2-norm (rel {GRAD_REL}), the largest entry {g_f[2]:.3e} of the "
          f"largest, {g_f[3]:.2f} s")
    return model, state


def check_fem(dev, card, gen, dims=(20, 10, 10), envs_=None, steps=None):
    """Phase 3: the FEM block at full width (fem_scene) for FEM's steps,
    finite and on the ground; its gradient as the cloth's; one window of
    simulate_xpbd from the drop, finite and above the ground."""
    E_ = envs_ or FEM["envs"]
    model = fem_scene(dims)
    start = with_velocities(model, E_, dev, gen, 0.1)
    state = run_steps(model, start, steps or FEM["steps"], FEM["substeps"])
    x = state.particle_q
    low = float(x[..., 1].min())
    if not torch.isfinite(x).all() or low < -CLOTH_MARGIN:
        raise RuntimeError(f"fem: non-finite or through the ground ({low})")
    g = hold_grad("fem", model, state, FEM["grad_steps"], FEM["substeps"],
                  ("particle_qd",))
    xp = run_steps(model, start, FEM["xpbd_steps"], FEM["substeps"],
                   xpbd=True).particle_q
    low_x = float(xp[..., 1].min())
    if not torch.isfinite(xp).all() or low_x < -CLOTH_MARGIN:
        raise RuntimeError(f"fem xpbd: non-finite or through the ground "
                           f"({low_x})")
    phase("engine", f"fem {dims[0]}x{dims[1]}x{dims[2]} ({x.shape[1]} "
          f"particles, {model.tet_indices.shape[0]} tets, "
          f"{model.tri_indices.shape[0]} surface triangles) E={E_}: "
          f"{steps or FEM['steps']} steps of {FEM['substeps']} substeps, "
          f"finite, lowest particle {low:.4f} m; d mean height / d "
          f"velocities over {FEM['grad_steps']} steps: twice the same bits, "
          f"vs float64 {g[1]:.3e} in the 2-norm (rel {GRAD_REL}), the "
          f"largest entry {g[2]:.3e} of the largest, {g[3]:.2f} s; "
          f"simulate_xpbd {FEM['xpbd_steps']} steps from the "
          f"drop: finite, lowest particle {low_x:.4f} m")
    return model, state


def check_coupled(dev, card, gen, envs_=COUPLED_ENVS):
    """Phase 4: the coupled scene at E envs, joint angles perturbed
    N(0, 0.05) but for env 0, for the fixture's 40 steps; env 0 against
    the E = 1 run within COUPLED_BATCH_ATOL (the float32 rounding of
    another batch size), every state finite, and the gradient through
    COUPLED_GRAD_STEPS steps finite."""
    model = coupled_scene()
    s = model.state(envs_, dev)
    dq = 0.05 * torch.randn(s.joint_q.shape, generator=gen, device=dev)
    dq[0] = 0.0
    runs = {1: model.state(1, dev),
            envs_: dataclasses.replace(s, joint_q=s.joint_q + dq)}
    traj = {n: [] for n in runs}
    t0 = time.perf_counter()
    for i in range(40):
        for n in runs:
            runs[n] = run_steps(model, runs[n], 1, 4)
            if (i + 1) % 5 == 0:
                traj[n].append(torch.cat([runs[n].joint_q[0],
                                          runs[n].particle_q[0].reshape(-1)]))
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    s = runs[envs_]
    if not all(torch.isfinite(getattr(s, k)).all()
               for k in ("joint_q", "joint_qd", "particle_q")):
        raise RuntimeError("coupled: non-finite state")
    err = (torch.stack(traj[envs_]) - torch.stack(traj[1])).abs().amax(1)
    if float(err.max()) > COUPLED_BATCH_ATOL:
        raise RuntimeError(f"coupled: env 0 of {envs_} off the E=1 run by "
                           f"{err.tolist()} every 5 steps")
    act = torch.zeros_like(s.joint_qd)
    loss, grads = loss_grad(model, s, COUPLED_GRAD_STEPS, 4,
                            ("joint_q", "particle_qd"), act)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in grads):
        raise RuntimeError("coupled: non-finite gradient")
    phase("engine", f"coupled E={envs_}: 40 steps of 4 substeps (mm 4) "
          f"beside the E=1 run in {fwd_s:.3f} s, finite; env 0 vs the E=1 "
          f"run max err {float(err[:6].max()):.3e} (30 steps), "
          f"{float(err.max()):.3e} (40 steps, atol {COUPLED_BATCH_ATOL:g}); "
          f"gradient over {COUPLED_GRAD_STEPS} steps finite, largest "
          + ", ".join(f"{k} {float(g.abs().max()):.3e}" for k, g in zip(
              ("d/d joint_q", "d/d particle_qd", "d/d joint_act"), grads)))
    return model, s, act


def env_step_grad(env, s1, acts, w, dtype):
    """The gradient of <w, obs before reset> + sum(reward) over one env
    step w.r.t. (actions, joint_q, joint_qd) at s1, in ``dtype``."""
    from diffrl_tpu_torch.envs.base import EnvState
    leaves = [t.detach().to(dtype).clone().requires_grad_()
              for t in (acts, s1.joint_q, s1.joint_qd)]
    with torch.enable_grad():
        _, obs, rew, _, info = env.step(EnvState(
            leaves[1], leaves[2], s1.actions.to(dtype), s1.progress),
            leaves[0])
        loss = rew.sum() + (info["obs_before_reset"] * w.to(dtype)).sum()
        return torch.autograd.grad(loss, leaves)


def sim_grad(env, s1, ja, ma, w_q, w_qd):
    """d/d(joint_q, joint_qd, joint_act) of <w_q, q'> + <w_qd, qd'> over
    one step of the env's simulator on its reverse pass (env.simulate, what
    env.step runs between its controls and its observations)."""
    leaves = [x.detach().clone().requires_grad_()
              for x in (s1.joint_q, s1.joint_qd, ja)]
    with torch.enable_grad():
        q, qd = env.simulate(*leaves, ma)
        return torch.autograd.grad(
            torch.sum(q * w_q) + torch.sum(qd * w_qd), leaves)


def check_backwards(envs_, s1, acts, gen, card):
    """Phase 5: one env step's gradient on each reverse pass of BACKWARDS
    (envs_[name] an Ant env on it, at E), from the same settled state and
    actions, each held by ``hold``'s rules against the float64 answer of
    the remat env run in float64 (the float32 remat gradient as the plain
    path); then per pass, the simulator's forward + backward alone
    (sim_grad): device ms (one CUDA graph of the call), ms per call, peak
    memory and K1's and K2's launches per call ("pallas" runs lb's
    simulator, so it is not timed again). Returns {pass: (largest
    per-env error against float64, device ms, per-call ms, peak GB,
    launches)} and hold's summaries."""
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.testing import env_errors

    w = torch.randn((acts.shape[0], envs_["lb"].num_obs), generator=gen,
                    device=acts.device)
    grads = {b: env_step_grad(envs_[b], s1, acts, w, torch.float32)
             for b in BACKWARDS}
    exact = env_step_grad(envs_["remat"], s1, acts, w, torch.float64)
    torch.cuda.synchronize()
    summaries, out = [], {}
    for b in BACKWARDS:
        if b != "remat":
            summaries += [hold("Ant", f"env step grad {lab} {b} vs remat",
                               g.T, p.T, x.T, 1e-3, 1e-4, whole_step=True)[1]
                          for lab, g, p, x in zip(
                              ("dactions", "djoint_q", "djoint_qd"),
                              grads[b], grads["remat"], exact)]
        per_env = max(float(env_errors(g.T, x.T).max())
                      for g, x in zip(grads[b], exact))
        env = envs_[b]
        ja, ma = controls(env, acts)
        wq = torch.randn(s1.joint_q.shape, generator=gen, device=acts.device)
        wqd = torch.randn(s1.joint_qd.shape, generator=gen,
                          device=acts.device)
        n0 = (sk.substep_forward.launches, sk.substep_vjp.launches)
        sim_grad(env, s1, ja, ma, wq, wqd)
        launches = (sk.substep_forward.launches - n0[0],
                    sk.substep_vjp.launches - n0[1])
        if b == "pallas":
            # DiffEnv.simulate runs the same code for "pallas" as for "lb":
            # its gradient is held above, its times are lb's
            out[b] = (per_env, *out["lb"][1:4], launches)
            phase("backward", f"Ant E={E} sim_backward 'pallas': the "
                  f"simulator of 'lb' (times as there), K1 and K2 launches "
                  f"per step {launches}; the env step's gradient against "
                  f"float64: largest per-env error {per_env:.3e} | {card}")
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev_ms, call_ms = timed_ms(
            lambda: sim_grad(env, s1, ja, ma, wq, wqd), 2)
        gb = torch.cuda.max_memory_allocated() / 1e9
        out[b] = (per_env, dev_ms, call_ms, gb, launches)
        phase("backward", f"Ant E={E} sim_backward {b!r}: one env step's "
              f"forward + backward of the simulator {dev_ms:.3f} ms device "
              f"(one CUDA graph), {call_ms:.3f} ms per call, peak "
              f"{gb:.3f} GB, K1 and K2 launches per step {launches}; the "
              f"env step's gradient against float64: largest per-env "
              f"error {per_env:.3e} | {card}")
    return out, summaries


# the multi phase's data-parallel runs: the TRAINERS rows repeated with
# multi_gpu over two ranks on the one card (gloo: NCCL refuses two ranks on
# one device), each with the first-epoch statistics held against the
# one-process run, and how far the two ranks may lie from it: those
# statistics at a relative bound, every parameter of the policy after the
# epoch at a relative bound in the 2-norm. The ranks sum in another order
# (each its half of the envs, then the all-reduce) than one process. SHAC:
# the actor's loss before its step and its one Adam step (1e-5 and 1e-4,
# the bounds of reordered float32 sums). PPO: the epoch's mean loss and
# critic loss over 20 minibatch steps whose KL adapts the learning rate
# (x 1.5 or / 1.5 at a threshold, so a reordered sum can move a step's
# rate): 1e-4 and 1e-3 (on an NVIDIA H100 80GB HBM3 at 700 W the two
# lay 2.5e-6 and 8.2e-5 apart).
MULTI = {"SHAC Ant": (("actor_loss",), 1e-5, 1e-4),
         "PPO Ant": (("loss", "c_loss"), 1e-4, 1e-3)}
RANK_TIMEOUT_S = 600


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multi_rank(label, rank, world, port, out):
    """One rank of a multi-phase run, in a process of its own (``python3
    chip_smoke.py --multi-rank LABEL RANK WORLD PORT OUT``): joins the gloo
    group on localhost:PORT, trains TRAINERS[LABEL]'s config with
    multi_gpu for one epoch through train(), with the launch counts set to
    0 just before and read just after, and saves its statistics, the
    policy's parameters, launches and seconds to OUT."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from diffrl_tpu_torch.parallel import mesh as mesh_lib
    from diffrl_tpu_torch.sim import substep_kernels as sk

    rank, world = int(rank), int(world)
    mesh_lib.init_distributed(f"localhost:{port}", world, rank,
                              backend="gloo", device="cuda",
                              timeout_s=RANK_TIMEOUT_S)
    cfg, _ = trainer_cfg(label, multi_gpu=True, max_epochs=1)
    trainer = make_trainer(label, cfg, "cuda")
    torch.cuda.synchronize()
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
    t = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    torch.save(dict(
        stats={k: v[0][2] for k, v in trainer.scalars.items()},
        params=flat_params(trainer).cpu(), seconds=seconds,
        launches=(sk.substep_forward.launches, sk.substep_vjp.launches),
        device=str(trainer.device), envs=trainer.env.num_envs), out)
    torch.distributed.destroy_process_group()
    shutil.rmtree(cfg["params"]["general"]["logdir"], ignore_errors=True)
    return 0


def run_ranks(label, world):
    """Starts ``world`` processes of multi_rank for TRAINERS[label] at once
    (LOCAL_RANK set as torchrun sets it), waits for each with a timeout,
    fails on any exit code but 0, and returns their records."""
    port = str(free_port())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    outs = [os.path.join(tmp, f"{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multi-rank", label,
         str(r), str(world), port, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, LOCAL_RANK=str(r))) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{label} rank {r} of {world} exited with "
                               f"{p.returncode}:\n{log[-6000:]}")
    recs = [torch.load(o) for o in outs]
    shutil.rmtree(tmp)
    return recs


def against_one_process(label, recs, one):
    """The ranks' first epoch against the one-process run's first epoch
    (``one``, a train() record): the ranks' statistics and parameters bit
    for bit, the statistics and the parameters (2-norm) of MULTI[label]
    at its bounds. Returns (largest relative
    difference of those statistics, relative 2-norm of the parameters'
    difference)."""
    def same(a, b):          # the host's fps aside; nan equals nan
        return a.keys() == b.keys() and all(
            k == "fps" or a[k] == b[k] or (math.isnan(a[k])
                                           and math.isnan(b[k])) for k in a)

    for r in recs[1:]:
        if not same(r["stats"], recs[0]["stats"]) or not torch.equal(
                r["params"], recs[0]["params"]):
            raise RuntimeError(f"{label}: the ranks disagree: "
                               f"{[x['stats'] for x in recs]}")
    keys, stat_bound, par_bound = MULTI[label]
    stat_rel = max(abs(recs[0]["stats"][k] - one["stats"][k])
                   / abs(one["stats"][k]) for k in keys)
    want = one["params"].cpu()
    par_rel = float((recs[0]["params"] - want).norm() / want.norm())
    if not (stat_rel <= stat_bound and par_rel <= par_bound):
        raise RuntimeError(f"{label}: two ranks against one process: "
                           f"statistics {recs[0]['stats']} vs "
                           f"{one['stats']} (relative {stat_rel:.3e}, "
                           f"bound {stat_bound}), parameters relative "
                           f"{par_rel:.3e} (bound {par_bound})")
    return stat_rel, par_rel


def check_multi(records, card):
    """The multi phase: (a) SHAC Ant and (c) PPO Ant over two gloo ranks on
    the one card, each rank half the envs, against the train phase's
    one-process first epoch; (b) SHAC Ant with multi_gpu at world size 1 on
    NCCL in this process, two epochs, against the same first epoch, with
    the host syncs of its second epoch. Returns {path: (K1, K2) launches}
    (per rank)."""
    from diffrl_tpu_torch.parallel import mesh as mesh_lib
    from diffrl_tpu_torch.sim import substep_kernels as sk

    launches = {}
    for label in MULTI:
        t0 = time.perf_counter()
        recs = run_ranks(label, 2)
        stat_rel, par_rel = against_one_process(label, recs,
                                                records[label][0])
        want = TRAINERS[label]["launches"]
        if any(tuple(r["launches"]) != tuple(want) for r in recs):
            raise RuntimeError(f"multi {label}: launches per rank "
                               f"{[r['launches'] for r in recs]}, expected "
                               f"{want}")
        for r, rec in enumerate(recs):
            launches[f"multi {label} rank {r} of 2"] = tuple(rec["launches"])
        keys, stat_bound, par_bound = MULTI[label]
        values = ", ".join(f"{k} {recs[0]['stats'][k]:.6g}" for k in keys)
        phase("multi", f"{label} multi_gpu, 2 ranks (gloo) x {recs[0]['envs']}"
              f" envs on {recs[0]['device']}: seconds per epoch (the first, "
              f"it builds nothing) " + ", ".join(
                  f"{r['seconds']:.3f}" for r in recs) + f" (one process "
              f"{records[label][0]['s']:.3f}); ranks bit for bit equal; "
              f"{values} vs one process, max relative {stat_rel:.3e} "
              f"(bound {stat_bound}), parameters after the epoch relative "
              f"{par_rel:.3e} in the 2-norm (bound {par_bound}); K1, K2 "
              f"launches per rank {[tuple(r['launches']) for r in recs]}; "
              f"{time.perf_counter() - t0:.1f} s with the processes' start "
              f"| {card}")

    # (b) one rank on NCCL, in this process, two epochs (the first against
    # the one-process run's, the second for its host syncs)
    label = "SHAC Ant"
    mesh_lib.init_distributed(f"localhost:{free_port()}", 1, 0,
                              backend="nccl", device="cuda")
    try:
        cfg, _ = trainer_cfg(label, multi_gpu=True, max_epochs=2)
        trainer = make_trainer(label, cfg, "cuda")
        if torch.distributed.get_backend(trainer.mesh.group) != "nccl":
            raise RuntimeError("multi: the world of one is not on NCCL")
        inner, recs = trainer.train_epoch, []

        def recorded():
            torch.cuda.synchronize()
            n = (sk.substep_forward.launches, sk.substep_vjp.launches)
            t = time.perf_counter()
            out, syncs = host_syncs(inner)
            torch.cuda.synchronize()
            recs.append(dict(s=time.perf_counter() - t, syncs=syncs,
                             launches=(sk.substep_forward.launches - n[0],
                                       sk.substep_vjp.launches - n[1]),
                             params=flat_params(trainer).cpu()))
            return out

        trainer.train_epoch = recorded
        sk.substep_forward.launches = sk.substep_vjp.launches = 0
        trainer.train()
        recs[0]["stats"] = {"actor_loss": trainer.scalars["actor_loss"][0][2]}
        stat_rel, par_rel = against_one_process(label, recs[:1],
                                                records[label][0])
        if any(r["launches"] != TRAINERS[label]["launches"] for r in recs):
            raise RuntimeError(f"multi: the NCCL world of one launched "
                               f"{[r['launches'] for r in recs]}")
        if recs[1]["syncs"]:
            raise RuntimeError(f"multi: {recs[1]['syncs']} host syncs in "
                               f"the NCCL world of one's second epoch")
        launches[f"multi {label} NCCL world of 1"] = tuple(
            map(sum, zip(*(r["launches"] for r in recs))))
        shutil.rmtree(cfg["params"]["general"]["logdir"], ignore_errors=True)
        del trainer
    finally:
        torch.distributed.destroy_process_group()
    phase("multi", f"{label} multi_gpu at world size 1 on NCCL (this "
          f"process), {len(recs)} epochs: seconds per epoch "
          + ", ".join(f"{r['s']:.3f}" for r in recs) + "; host syncs in "
          f"train_epoch " + ", ".join(str(r["syncs"]) for r in recs)
          + f"; first epoch's actor loss vs one process relative "
          f"{stat_rel:.3e}, parameters {par_rel:.3e} (bounds "
          f"{MULTI[label][1]}, {MULTI[label][2]}) | {card}")
    return launches


def check_serve(trainer, dev, gen, card):
    """The serve phase: the trained SHAC Ant policy saved as a checkpoint
    (Trainer.save), built by utils.export.shac_policy_fn, exported with
    export_fn on the card, loaded and served by serve_policy's server in a
    thread; batches of 1, 64 and 4096 observations POSTed to /act, the
    actions held at 1e-6 against the trainer's actor (obs normalized ->
    mean -> tanh); then a 404 and a 400. Returns ms per request by
    batch."""
    import threading
    import urllib.error
    import urllib.request

    from diffrl_tpu_torch.serve_policy import make_server
    from diffrl_tpu_torch.utils.export import (export_fn, load_exported,
                                               shac_policy_fn)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    trainer.log_dir = tmp
    trainer.save("final_policy")
    cfg, _ = trainer_cfg("SHAC Ant")
    policy, obs_dim, act_dim = shac_policy_fn(
        os.path.join(tmp, "final_policy.pt"), cfg, device=dev)
    artifact = os.path.join(tmp, "policy.pt2")
    t0 = time.perf_counter()
    export_fn(policy, (torch.zeros((2, obs_dim), device=dev),),
              path=artifact)
    export_s = time.perf_counter() - t0
    server = make_server(load_exported(artifact), 0, dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    ms, errs = {}, {}
    try:
        for batch in (1, 64, 4096):
            obs = torch.randn((batch, obs_dim), generator=gen, device=dev)
            with torch.no_grad():
                want = torch.tanh(trainer.actor(
                    trainer.obs_rms.normalize(obs), deterministic=True))
            body = json.dumps({"obs": obs.cpu().tolist()}).encode()
            times = []
            for _ in range(3):
                t = time.perf_counter()
                code, reply = post("/act", body)
                times.append((time.perf_counter() - t) * 1e3)
                if code != 200:
                    raise RuntimeError(f"serve: /act answered {code} "
                                       f"{reply[:500]}")
            got = torch.tensor(json.loads(reply)["actions"],
                               dtype=torch.float32)
            errs[batch] = assert_close(f"serve batch {batch}", got,
                                       want.cpu(), 1e-6, 1e-6)
            ms[batch] = statistics.median(times)
        if post("/other", b"{}")[0] != 404 or post("/act", b"x")[0] != 400:
            raise RuntimeError("serve: a bad path or body was not refused")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    phase("serve", f"SHAC Ant policy ({obs_dim} obs -> {act_dim} actions) "
          f"exported with torch.export on {dev} in {export_s:.2f} s, served "
          f"over HTTP: " + ", ".join(
              f"batch {b} {ms[b]:.2f} ms per request (median of 3), max err "
              f"{errs[b]:.2e}" for b in ms) + f" (held at 1e-6) | {card}")
    return ms


def check_profile(trainer, card):
    """The profile phase: one SHAC Ant epoch (train_epoch) under
    utils.profiling.trace() on the card; the top 15 device ops by time
    (profiling.summarize over the trace's device events), K1's and K2's
    kernels found among them by name with their rank, and the device-busy
    share of the traced window. Returns (busy share, rows, launches)."""
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.utils import profiling

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    torch.cuda.synchronize()
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
    t0 = time.perf_counter()
    with profiling.trace(log_dir, device=trainer.device):
        trainer.train_epoch()
    traced_s = time.perf_counter() - t0
    launches = (sk.substep_forward.launches, sk.substep_vjp.launches)
    size = sum(os.path.getsize(os.path.join(log_dir, f))
               for f in os.listdir(log_dir))
    t0 = time.perf_counter()
    events = profiling.load_trace(log_dir)
    rows = profiling.summarize(events, None, profiling.DEVICE_CATEGORIES)
    busy = profiling.device_busy_share(events)
    read_s = time.perf_counter() - t0
    shutil.rmtree(log_dir)
    if launches != TRAINERS["SHAC Ant"]["launches"]:
        raise RuntimeError(f"profile: launches {launches}")
    found = {}
    for k in ("substep_forward_kernel", "substep_vjp_kernel"):
        hits = [(i, r) for i, r in enumerate(rows) if k in r[2]]
        if len(hits) != 1 or hits[0][1][1] != TRAINERS["SHAC Ant"][
                "launches"][0]:
            raise RuntimeError(f"profile: {k} in the trace's device ops: "
                               f"{hits}")
        found[k] = hits[0]
    device_ms = sum(ms for ms, _, _ in rows)
    phase("profile", f"one SHAC Ant epoch (E={E}) under torch.profiler: "
          f"{traced_s:.1f} s traced (the trace's export included), a "
          f"{size / 1e6:.1f} MB trace of {len(events)} events read in "
          f"{read_s:.1f} s; {len(rows)} device op names, "
          f"{sum(c for _, c, _ in rows)} device ops, {device_ms:.1f} ms; "
          f"device busy {100 * busy:.2f} % of the traced window; "
          + "; ".join(f"{k} #{i + 1} {ms:.2f} ms x{c}"
                      for k, (i, (ms, c, _)) in found.items())
          + "; top 15 device ops: "
          + "; ".join(f"{n[:70]} {ms:.1f} ms x{c}" for ms, c, n in rows[:15])
          + f" | {card}")
    return busy, rows[:15], launches


def check_render(env, act_fn, steps, card):
    """The render phase: ``steps`` deterministic env steps of the main
    phase's policy on its env from a reset, env 0 recorded into a .usda
    stage and an HTML viewer; the frame counts held. Returns K1 launches."""
    from diffrl_tpu_torch.render import UsdRenderer
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.sim.model import State
    from diffrl_tpu_torch.viewer import HtmlViewer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_render_")
    usd = UsdRenderer(env.model, os.path.join(tmp, "ant.usda"))
    html = HtmlViewer(env.model, os.path.join(tmp, "ant.html"))
    state = env.reset()
    torch.cuda.synchronize()
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(steps):
            obs = env.batch_observations(state)
            state, *_ = env.step(state, act_fn(obs, None))
            frame = State(joint_q=state.joint_q[0])
            usd.update(frame, (i + 1) * env.dt)
            html.update(frame, (i + 1) * env.dt)
    launches = sk.substep_forward.launches
    text = open(usd.save()).read()
    data = open(html.save()).read()
    render_s = time.perf_counter() - t0
    shutil.rmtree(tmp)
    frames = text.count(": (") // (2 * len(usd._bodies))
    n_html = json.loads(data.split("const DATA = ", 1)[1].split(";\n", 1)[0]
                        )["bodies"]
    if frames != steps or len(n_html) != steps:
        raise RuntimeError(f"render: {frames} USD frames and {len(n_html)} "
                           f"HTML frames, expected {steps}")
    if launches != steps * (MM - 1) or sk.substep_vjp.launches:
        raise RuntimeError(f"render: K1 launched {launches} times")
    phase("render", f"Ant E={env.num_envs}: {steps} policy steps, env 0 into "
          f"a .usda ({len(text)} B, {frames} frames of {len(usd._bodies)} "
          f"bodies) and an HTML viewer ({len(data)} B, {len(n_html)} frames)"
          f" in {render_s:.2f} s; K1 launches {launches} | {card}")
    return launches


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
    from diffrl_tpu_torch.sim.model import State
    from diffrl_tpu_torch.testing import check_repeatable
    from diffrl_tpu_torch.utils import RunningMeanStd

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    card = card_line()
    card_kind = torch.cuda.get_device_name(0)
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

    # the plain path sums in a fixed order: two runs give the same bits
    for name in SPLIT:
        s1 = checks[name]["step_state"][0]
        _, _, _, jat, mat, h, _, _ = checks[name]["fargs"]
        t0 = time.perf_counter()
        n = check_repeatable(menvs[name].model, s1.joint_q.T.contiguous(),
                             s1.joint_qd.T.contiguous(), jat, mat, h, gen)
        phase("repeat", f"{name} E={E}: the plain refresh substep, cached "
              f"substep and both their VJPs run twice on the same inputs: "
              f"{n} outputs bitwise equal ({time.perf_counter() - t0:.2f} "
              f"s)")

    # 5. dflex golden fixtures through the kernel path
    for name in FIXTURES:
        check_fixture(name, menvs[name], dev)
    for name in SCENES + PARTICLE_SCENES:
        early, full, vel, n = scene_run(name, dev)
        if name in SCENES and name != "pendulum2_mm1" and n == 0:
            raise RuntimeError(f"the {name} scene did not go through K1")
        phase("fixture", f"{name} at E=1 through "
              f"{'simulate' if name in PARTICLE_SCENES else 'K1'}: max "
              f"error of the positions {early:.3e} (30 steps), {full:.3e} "
              f"(all), of the velocities {vel:.3e}, tolerances "
              f"{SCENE_TOL.get(name, (1e-5, 1e-4))}; substep_forward "
              f"launches {n}")

    # 5b. the particle, cloth, FEM and coupled engine at full width, and the
    # env's two reverse passes; then their timings
    t_engine = time.perf_counter()
    cloth = check_cloth(dev, card, gen)
    fem = check_fem(dev, card, gen)
    coupled = check_coupled(dev, card, gen)
    s1, _, acts = checks["Ant"]["step_state"]
    back_envs = {b: menvs["Ant"] if b == "lb" else envs.make(
        "Ant", num_envs=E, seed=0, stochastic_init=True, episode_length=1000,
        MM_caching_frequency=MM, device=dev, sim_backward=b)
        for b in BACKWARDS}
    backwards, res = check_backwards(back_envs, s1, acts, gen, card)
    phase("backward", f"Ant E={E}: one env step's gradient (obs and reward "
          f"w.r.t. actions, joint_q, joint_qd) on each reverse pass vs "
          f"'remat' (simulate, checkpointed plain stages) and float64 "
          f"(rtol 1e-3, atol 1e-4): " + "; ".join(res))
    env_remat = back_envs["remat"]
    torch.cuda.empty_cache()
    time_engine("cloth 60x60", *cloth, CLOTH["substeps"], ("particle_qd",),
                card, n=1)
    time_hashed(*cloth, CLOTH["substeps"], card)
    time_engine("fem 20x10x10", *fem, FEM["substeps"], ("particle_qd",),
                card)
    time_engine("coupled", coupled[0], coupled[1], 4,
                ("joint_q", "particle_qd"), card, mm=4, act=coupled[2])
    time_engine("Ant simulate (remat)", env_remat.model,
                State(s1.joint_q, s1.joint_qd), env_remat.sim_substeps,
                ("joint_q", "joint_qd"), card, mm=MM,
                act=controls(env_remat, acts)[0])
    phase("engine", f"phases 5b in {time.perf_counter() - t_engine:.1f} s")

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
    # the rollout's policy again from a reset, env 0 rendered
    paths = {"render": (check_render(
        eval_env, policy_act_fn(actor, obs_rms, deterministic=True),
        EVAL_STEPS, card), 0)}

    # 7. the training paths, each path's counts read alone, and one more
    # epoch of some split into its phases
    records, splits = {}, {}
    for label, spec in TRAINERS.items():
        trainer, records[label] = train(label, dev, card, gen)
        if label == "SHAC Ant":
            ant_trainer = trainer       # for the serve and profile phases
        if spec["split"]:
            splits[label], syncs = split(label, trainer)
            phase("timing", f"one more {label} epoch, host waiting after "
                  f"each phase: " + ", ".join(
                      f"{k} {v:.1f} ms" for k, v in splits[label].items())
                  + f"; {syncs} host syncs in it | {card}")
        del trainer
        torch.cuda.empty_cache()

    # 7b. PPO's builder path on the bandit: a discrete head on the one-hot
    # observation, a conv trunk on the image, a GRU
    for label, (net, kw, image, least) in BANDITS.items():
        torch.cuda.synchronize()
        ppo, rew, sec = bandit(label, dev, num_envs=E)
        phase("bandit", f"PPO {label} ({', '.join(net)}) on the bandit E={E}"
              f"{' (6 x 6 image)' if image else ''}, {kw['epochs']} epochs "
              f"of 8 steps: {sec:.2f} s, deterministic evaluation reward "
              f"{rew:.3f} (JAX's test holds > {least}; random 2, best 8) | "
              f"{card}")
        del ppo

    # 7c. data-parallel training over torch.distributed; serving the
    # trained SHAC Ant policy; one SHAC Ant epoch under the profiler
    t_new = time.perf_counter()
    paths.update(check_multi(records, card))
    check_serve(ant_trainer, dev, gen, card)
    busy, _, paths["profile SHAC Ant epoch"] = check_profile(ant_trainer,
                                                             card)
    del ant_trainer
    torch.cuda.empty_cache()
    phase("multi", f"phases multi, serve and profile in "
          f"{time.perf_counter() - t_new:.1f} s")

    # 8. timings at the main path's shapes: device time with the host
    # queued ahead (median of repeated batches), per-call time as a caller
    # sees it (CUDA events around each call, host launch overhead included)
    times = {name: time_kernels(name, checks[name], card) for name in MODELS}
    refresh_call = {name: time_refresh(name, checks[name], card)
                    for name in SPLIT}
    s1, ja, acts = checks["Ant"]["step_state"]
    with torch.no_grad():
        s_call, g_call = (statistics.median(event_times(fn, n)) for fn, n in (
            (lambda: env.step(s1, acts), 10),
            (lambda: step_grad(env.model, *checks["Ant"]["gargs"],
                               plain=False), 5)))
        k_call = {name: [statistics.median(event_times(
            lambda: fn(*checks[name][args]), 100))
            for fn, args in ((sk.substep_forward, "fargs"),
                             (sk.substep_vjp, "vargs"))] for name in SPLIT}
    phase("timing", f"Ant env step {s_call:.3f} ms per call = 1 refresh + "
          f"{MM - 1} kernel launches + obs/reward/reset; training env step "
          f"(forward and backward of simulate) {g_call:.3f} ms per call | "
          f"{card}")
    for name in SPLIT:
        spec = MODELS[name]
        fwd_ms, bwd_ms, critic_ms = splits[f"SHAC {name}"].values()
        blocks = TRAIN_STEPS * spec["substeps"] // spec["mm"]
        n_win = blocks * (spec["mm"] - 1)
        (r_call, rp_call), (f_call, v_call) = refresh_call[name], k_call[name]
        phase("timing", f"one {name} training epoch (E={E}, {TRAIN_STEPS} "
              f"steps, {spec['substeps']} substeps, mm {spec['mm']}), host "
              f"waiting after each phase: window forward {fwd_ms:.1f} ms "
              f"(K1 {n_win} launches x {f_call:.3f} ms per call = "
              f"{n_win * f_call:.1f} ms; refreshes {blocks} x {r_call:.3f} "
              f"ms per call = {blocks * r_call:.1f} ms), backward + actor "
              f"step {bwd_ms:.1f} ms (K2 {n_win} launches x {v_call:.3f} ms "
              f"per call = {n_win * v_call:.1f} ms; refresh replays "
              f"{blocks} x {rp_call:.3f} ms per call = "
              f"{blocks * rp_call:.1f} ms), critic {critic_ms:.1f} ms | "
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

    # each path's launches over its whole run
    runs = {label: [sum(r["launches"][i] for r in recs) for i in (0, 1)]
            for label, recs in records.items()}
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
                "launches": runs[f"SHAC {name}"][i],
                "launches_by_path": {
                    **{label: runs[label][i]
                       for label, spec in TRAINERS.items()
                       if spec["model"] == name},
                    **({f"env step grad {b}": backwards[b][4][i]
                        for b in BACKWARDS} if name == "Ant" else {}),
                    **({p: int(v[i]) for p, v in paths.items()}
                       if name == "Ant" else {})},
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
        "platform": "gpu", "kind": card_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-rank"]:
        sys.exit(multi_rank(*sys.argv[2:]))
    sys.exit(main())

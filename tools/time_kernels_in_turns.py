#!/usr/bin/env python3
"""Device time of the substep kernels (K1, K2) of two source trees, in turns.

    python3 tools/time_kernels_in_turns.py OTHER_TREE [ENV ...]
                                                (default: Ant Humanoid)

Needs one CUDA device. OTHER_TREE is another checkout of the repository
(the parent commit, say, unpacked with ``git archive`` into a git-ignored
directory such as build/parent). One worker process per tree imports that
tree's diffrl_tpu_torch, builds K1 and K2 for each env (any env of
chip_smoke.py's MODELS, without muscles) into the tree's own build/
directory, and sets up the settled 4096-env state of chip_smoke.py's
kernel and adjoint phases (generator seeded 1). The workers then take
turns, the other tree first (other, this, this, other, ...: PAIRS pairs), each
turn timing one launch of each kernel per env on the device
(chip_smoke.device_ms, the median of 7 x 50 launches) while the other
worker waits, so that the card's drift falls on both. Prints each build's
ptxas registers, spills and SASS instruction count (cuobjdump), one line
per turn, the median per tree, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
E = 4096
KERNELS = ("substep_forward", "substep_vjp")
PAIRS = 5   # pairs of turns, each tree once per pair


def _chip_smoke():
    """This tree's chip_smoke.py as a module of its own name, so that the
    other tree's copy on sys.path is not the one imported."""
    spec = importlib.util.spec_from_file_location("time_turns_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_instructions(path: str) -> int:
    """SASS instructions in a built library (cuobjdump -sass), or -1
    without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return -1
    out = subprocess.run([tool, "-sass", path], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    return sum(1 for line in out.splitlines()
               if line.strip().startswith("/*") and "*/" in line
               and line.split("*/", 1)[1].strip()
               and not line.split("*/", 1)[1].strip().startswith("/*"))


def worker(tree: str, names) -> int:
    """Builds and sets up in ``tree``, then times on each line of stdin."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import diffrl_tpu_torch.envs as envs
    from diffrl_tpu_torch.sim import articulation_lb as lb
    from diffrl_tpu_torch.sim import substep_kernels as sk

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    calls, builds = {}, {}
    for name in names:
        spec = cs.MODELS[name]
        env = envs.make(name, num_envs=E, seed=0, stochastic_init=True,
                        MM_caching_frequency=spec["mm"], device=dev)
        s = cs.settled_state(env, spec["settle"])
        acts = torch.rand((E, env.num_acts), generator=gen,
                          device=dev) * 2 - 1
        ja = env.action_to_controls(acts)[0].T.contiguous()
        q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
        h = env.dt / env.sim_substeps
        with torch.no_grad():
            q1, qd1, H, Hinv = lb.refresh_substep_lb(env.model, q, qd, ja,
                                                     None, h)
        gq = torch.randn(q1.shape, generator=gen, device=dev)
        gqd = torch.randn(qd1.shape, generator=gen, device=dev)
        m = env.model
        calls[name] = (
            lambda m=m, a=(q1, qd1, ja, None, h, H, Hinv):
                sk.substep_forward(m, *a),
            lambda m=m, a=(q1, qd1, ja, None, h, H, Hinv, gq, gqd):
                sk.substep_vjp(m, *a))
        for kname in KERNELS:
            b = sk._prepare(kname, m, dev, None).built
            builds[f"{name} {kname}"] = (
                b.registers, b.spill_store_bytes, b.spill_load_bytes,
                sass_instructions(b.lib._name))
    torch.cuda.synchronize()
    print(json.dumps({"builds": builds}), flush=True)
    while sys.stdin.readline():
        times = {}
        with torch.no_grad():
            for name, fns in calls.items():
                for kname, fn in zip(KERNELS, fns):
                    times[f"{name} {kname}"] = statistics.median(
                        cs.device_ms(fn, 50) for _ in range(7)) * 1e3
        print(json.dumps({"us": times}), flush=True)
    return 0


def _read(p, tree):
    """The next JSON line of a worker (other output passed on)."""
    while True:
        line = p.stdout.readline()
        if not line:
            raise RuntimeError(f"the worker for {tree} failed")
        if line.startswith("{"):
            return json.loads(line)
        print(line, end="", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        return worker(argv[1], argv[2:])
    import torch
    if not torch.cuda.is_available():
        print("time_kernels_in_turns: CUDA is not available",
              file=sys.stderr)
        return 1
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other, names = argv[0], argv[1:] or ["Ant", "Humanoid"]
    trees = {"other": other, "this": str(ROOT)}
    procs = {k: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker", t,
         *names], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for k, t in trees.items()}
    try:
        for k, p in procs.items():
            builds = _read(p, trees[k])["builds"]
            for kn, (reg, st, ld, ins) in builds.items():
                print(f"{k} ({trees[k]}) {kn}: {reg} registers, {st}/{ld} "
                      f"B spill stores/loads, {ins} SASS instructions",
                      flush=True)
        turns = ("other", "this", "this", "other")
        order = [turns[i % 4] for i in range(2 * PAIRS)]
        runs = {k: [] for k in trees}
        for i, k in enumerate(order):
            p = procs[k]
            p.stdin.write("time\n")
            p.stdin.flush()
            us = _read(p, trees[k])["us"]
            runs[k].append(us)
            print(f"turn {i + 1} {k}: " + " | ".join(
                f"{kn} {t:.2f} us" for kn, t in us.items()), flush=True)
        for k, rs in runs.items():
            print(f"median {k}: " + " | ".join(
                f"{kn} {statistics.median(r[kn] for r in rs):.2f} us"
                for kn in rs[0]), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    print(_chip_smoke().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

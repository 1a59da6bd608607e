"""One run of one cell: set-up, the measured window, the traced epoch
(``--trace 1``), then the check against the plain reference.

The set-up builds the port's trainer from the seed and drives it through
its first epochs (the first builds the kernels and warms every shape),
reading them for the check; the same trainer then runs whole epochs, each
``train_epoch()`` then ``_process_epoch_stats()`` as ``train()`` runs
them, until the window's seconds have passed. The reference runs once the
program's state is freed."""

from __future__ import annotations

import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from . import check
from .subjects import ProgramTrainer, ReferenceTrainer
from .trace import Trace, profile_epoch

FORBIDDEN = ("jax", "jaxlib", "flax", "diffrl_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (the port's name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class ImportRuleError(RuntimeError):
    pass


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Context:
    """What a per-layer metric reader reads."""

    cell: Any
    cfg: Dict[str, Any]
    num_envs: int
    steps_num: int
    epochs: int                     # whole epochs in the window
    window_s: float
    phase_ms: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Trace] = None
    model: Any = None               # the reference's model of the env
    n_active_per_launch: float = 0.0


class PhaseTimer:
    """Host-clock time of each phase of the trainer's epoch, the host
    waiting for the device before and after each (the pattern of
    ``chip_smoke.split``); installed as instance attributes, so that the
    trainer's own ``train_epoch`` calls them."""

    def __init__(self, subject, device):
        self.totals: Dict[str, float] = {}
        self._installed = []
        for name, obj in subject.phase_methods():
            inner = getattr(obj, name)

            def timed(*a, _inner=inner, _name=name, **k):
                _sync(device)
                t = time.perf_counter()
                out = _inner(*a, **k)
                _sync(device)
                self.totals[_name] = (self.totals.get(_name, 0.0)
                                      + time.perf_counter() - t)
                return out
            setattr(obj, name, timed)
            self._installed.append((obj, name))

    def remove(self):
        for obj, name in self._installed:
            delattr(obj, name)
        self._installed = []


def _window(subject, seconds, device):
    """Whole epochs until ``seconds`` have passed: (epochs, seconds, the
    epochs whose logged losses are not finite)."""
    _sync(device)
    t = last = time.perf_counter()
    n = failed = 0
    laps = []
    while True:
        subject.epoch()
        n += 1
        failed += not all(math.isfinite(v) for v in subject.losses().values())
        now = time.perf_counter()
        laps.append(now - last)
        last = now
        if now - t >= seconds:
            break
    _sync(device)
    print(f"window: {n} epochs, seconds each {laps}", file=sys.stderr)
    return n, time.perf_counter() - t, failed


def card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> Dict[str, Any]:
    """One run; returns the result line's object."""
    device = torch.device(device)
    logdir = tempfile.mkdtemp(prefix="benchmark_logs_")
    try:
        return _run(cell, seed, seconds, trace, device, t0, logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t0, logdir):
    cuda = device.type == "cuda"
    check_epochs = int(cell.traffic["check_epochs"])
    subject = ProgramTrainer(cell, seed, logdir, device)
    prog = check.read(subject, check_epochs)
    _sync(device)
    setup_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    phases = PhaseTimer(subject, device) if trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    epochs, window_s, failed = _window(subject, seconds, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = Context(cell=cell, cfg=subject.cfg, num_envs=subject.tr.num_envs,
                  steps_num=subject.tr.steps_num, epochs=epochs,
                  window_s=window_s)
    if phases is not None:
        phases.remove()
        ctx.phase_ms = {k: 1e3 * v / epochs for k, v in phases.totals.items()}
    if trace:
        ctx.trace, ctx.model, ctx.n_active_per_launch = _traced_epoch(
            subject, cell, device)
    peak = max(peak, torch.cuda.max_memory_allocated(device) if cuda else 0)
    found = forbidden_modules()
    if found:
        raise ImportRuleError(f"loaded after the window: {', '.join(found)}")

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {
            "train_env_steps_per_s":
                epochs * subject.env_steps_per_epoch / window_s,
            "peak_mem_gb": window_peak / 1e9,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # the program's state goes before the reference runs
    subject.close()
    del subject
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = check.read(ReferenceTrainer(cell, seed, device, torch.float64),
                     check_epochs)
    numbers = check.compare(prog, ref)
    print(f"numbers: {json.dumps(numbers)}", file=sys.stderr)
    correct, rows = check.judge(numbers, cell.limits["limits"])
    found = forbidden_modules()
    if found:
        raise ImportRuleError(f"loaded by the end: {', '.join(found)}")

    result = {
        "correct": correct,
        "attempted": epochs,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": (torch.cuda.get_device_name(device) if cuda
                     else "cpu (a test run, not a measurement)"),
            "count": cell.chips if cuda else 1,
            "memory_peak_bytes": int(peak),
            "power_limit": card_power_limit() if cuda else None,
        },
    }
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                               "idle_gaps": ctx.trace.idle_gaps(10)}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def _traced_epoch(subject, cell, device):
    """One more epoch under the profiler; the env's state at each of its
    steps is kept (a reference, no device work) to count the contacts that
    K2's adjoint runs."""
    from ..reference.envs import model_of
    from .counts import active_contacts

    env = subject.env
    states = []
    inner = env.step

    def step(env_state, actions):
        states.append(env_state.joint_q)
        return inner(env_state, actions)

    env.step = step
    try:
        tr = profile_epoch(subject.epoch, device.type == "cuda")
    finally:
        del env.step
    model = model_of(cell.config["diff_env"]["name"])
    with torch.no_grad():
        active = [active_contacts(model, q.detach().T.contiguous())
                  for q in states]
    n_active = sum(active) / max(len(active), 1)
    return tr, model, n_active

"""The trainers the harness drives: the port's (the system under test) and
the plain reference's (which the check follows, and which stands in the
program's place for the control and the planted faults). Both give the
same readings: each epoch's losses, each optimizer's first gradient as the
optimizer took it, and each module's parameters.

Which trainer a cell runs is its traffic mix's ``trainer``; the tables
below say, per trainer, which of the port's classes it is, which losses
its epoch logs, which modules and optimizers it has, which methods are the
phases of its epoch, which records of its first epoch the check compares
and which planted faults (``faults.py``) its timed path can have."""

from __future__ import annotations

import time
from typing import Dict

import torch

TRAINERS = {
    "shac": dict(program="diffrl_tpu_torch.algorithms.shac:SHAC",
                 reference="shac:ShacReference",
                 losses=("actor_loss", "value_loss"),
                 modules={"actor": "actor", "critic": "critic"},
                 optimizers={"actor": "actor_opt", "critic": "critic_opt"},
                 phases=("rollout", "actor_step", "critic_step"),
                 records=(("rollout", lambda out: {"rew": out[1]["rew"]}),
                          ("target_values", lambda out: {"target": out})),
                 faults=("frozen_state", "half_batch", "altered_answer",
                         "altered_slice", "scaled_adjoint")),
    "ppo": dict(program="diffrl_tpu_torch.algorithms.ppo:PPO",
                reference="ppo:PpoReference",
                losses=("loss",),
                modules={"network": "network"},
                optimizers={"network": "opt"},
                phases=("play_steps", "update"),
                records=(("play_steps", lambda out: {
                    "rew": out[0]["rew"], "value": out[0]["value"]}),
                         ("_returns", lambda out: {
                             "adv": out[0], "ret": out[2]})),
                # the rollout runs without gradients: no adjoint to scale
                faults=("frozen_state", "half_batch", "altered_answer",
                        "altered_slice")),
}


def _class(path, package=None):
    import importlib

    module, name = path.split(":")
    if package:
        module = f"{package}.{module}"
    return getattr(importlib.import_module(module), name)


def watch_first_records(tr, spec, store):
    """From now on, the first call of each method that the trainer's table
    names under ``records`` leaves the records it picks (the rollout's
    rewards, PPO's value estimates, SHAC's TD(lambda) targets, PPO's
    advantages and returns), each [steps, envs] in float64 on the host, in
    ``store``; each wrapper is an instance attribute, so the trainer's own
    epoch calls it."""
    for name, pick in spec["records"]:
        inner = getattr(tr, name)

        def first(*a, _inner=inner, _name=name, _pick=pick, **k):
            out = _inner(*a, **k)
            store.update({key: v.detach().double().cpu()
                          for key, v in _pick(out).items()})
            delattr(tr, _name)
            return out
        setattr(tr, name, first)


def param_snapshot(modules) -> Dict[str, Dict[str, torch.Tensor]]:
    return {m: {n: p.detach().clone() for n, p in mod.named_parameters()}
            for m, mod in modules.items()}


class ProgramTrainer:
    """The port's trainer, driven through ``train()``'s loop body:
    ``train_epoch()`` then ``_process_epoch_stats()``."""

    def __init__(self, cell, seed, logdir, device, fault=None):
        self.spec = TRAINERS[cell.trainer]
        cls = _class(self.spec["program"])
        self.cfg = cell.trainer_cfg(seed, logdir)
        self.tr = tr = cls(self.cfg, device=device)
        self._undo = None
        if fault is not None:
            self._undo = fault(tr, self.spec["optimizers"])
        now = time.time()
        tr.start_time, tr._best_snapshot = now, None
        tr._last_best_write, tr._t_last_epoch = now, now
        for t in ("algorithm", "actor training"):
            if t not in tr.time_report.timers:
                tr.time_report.add_timer(t)
        self.env_steps_per_epoch = tr.num_envs * tr.steps_num
        self._first = {}
        self._hooks = []
        self._records = {}

    def epoch(self):
        self.tr._process_epoch_stats(self.tr.train_epoch())

    def losses(self) -> Dict[str, float]:
        return {k: float(self.tr.scalars[k][-1][2])
                for k in self.spec["losses"]}

    def modules(self):
        return {m: getattr(self.tr, a)
                for m, a in self.spec["modules"].items()}

    def watch_first_steps(self):
        """From now on, each optimizer's first step leaves its gradient as
        the optimizer took it, worked out from Adam's state after that one
        step (exp_avg / (1 - beta1)), in ``first_grads()``, and the first
        epoch its records in ``first_records()``."""
        watch_first_records(self.tr, self.spec, self._records)
        names = {id(p): n for mod in self.modules().values()
                 for n, p in mod.named_parameters()}
        for key, attr in self.spec["optimizers"].items():
            opt = getattr(self.tr, attr)

            def hook(optimizer, args, kwargs, key=key):
                if key in self._first:
                    return
                grads = {}
                for group in optimizer.param_groups:
                    b1 = group["betas"][0]
                    for p in group["params"]:
                        grads[names[id(p)]] = (
                            optimizer.state[p]["exp_avg"] / (1.0 - b1)
                        ).detach().clone()
                self._first[key] = grads
            self._hooks.append(opt.register_step_post_hook(hook))

    def first_grads(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []
        return self._first

    def first_records(self):
        return self._records

    def phase_methods(self):
        return [(p, self.tr) for p in self.spec["phases"]]

    @property
    def env(self):
        return self.tr.env

    def close(self):
        self.first_grads()
        if self._undo is not None:
            self._undo()
            self._undo = None
        self.tr = None


class ReferenceTrainer:
    """The plain reference's trainer in ``dtype`` (float64 for the check;
    float32 with TF32 matmuls for the control)."""

    def __init__(self, cell, seed, device, dtype, fault=None):
        self.spec = TRAINERS[cell.trainer]
        cls = _class(self.spec["reference"], "benchmark.reference")
        self.tr = cls(cell.trainer_cfg(seed, ""), device, dtype)
        self._undo = None
        if fault is not None:
            self._undo = fault(self.tr, self.spec["optimizers"])
        self._losses = {}
        self._records = {}

    def epoch(self):
        self._losses = self.tr.epoch()

    def losses(self):
        return {k: self._losses[k] for k in self.spec["losses"]}

    def modules(self):
        return self.tr.modules()

    def watch_first_steps(self):
        watch_first_records(self.tr, self.spec, self._records)

    def first_grads(self):
        return self.tr.first_grads

    def first_records(self):
        return self._records

    def close(self):
        if self._undo is not None:
            self._undo()
            self._undo = None
        self.tr.env.close()
        self.tr = None

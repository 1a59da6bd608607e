"""Runtime-independent experiment driver of the Kit extension (port of
diffrl_tpu/extension/experiment.py).

The extension drives an experiment one tick at a time from Kit's update
loop: ``train()`` advances one optimization step, ``run()`` one inference
step, ``reset()`` restarts, while the UI polls ``train_loss``,
``render_time`` and ``log_output``. This module gives that contract without
any Omniverse dependency:

- :class:`Experiment`: the duck-typed surface the UI layer needs.
- :class:`PolicyExperiment`: a driver over the port's env and SHAC trainer:
  one SHAC epoch per ``train()`` tick, one deterministic env step per
  ``run()`` tick, optionally recorded into a USD stage (render.UsdRenderer).
- :func:`load_experiment_script`: loads a user script and returns its
  experiment (a ``make_experiment()`` factory, or a module-level
  ``experiment`` object).
"""

from __future__ import annotations

import copy
import runpy
from typing import List, Optional

import torch


class Experiment:
    """Duck-typed surface consumed by kit_ext.DiffRLExtension.

    Subclasses override the tick methods; the attributes are the UI
    contract.
    """

    #: loss history for the UI plot (most-recent-last)
    train_loss: List[float]
    #: simulated seconds of the rendered trajectory (drives stage timeline)
    render_time: float
    #: text streamed into the UI log widget
    log_output: str
    #: optional policy checkpoint path (set by the UI network picker)
    network_file: Optional[str]
    #: when True, run() ticks append to the USD recording
    record: bool

    def __init__(self):
        self.train_loss = []
        self.render_time = 0.0
        self.log_output = ""
        self.network_file = None
        self.record = True

    def reset(self):  # pragma: no cover - interface default
        raise NotImplementedError

    def train(self):  # one training step per UI tick
        raise NotImplementedError

    def run(self):  # one inference step per UI tick
        raise NotImplementedError

    def log(self, msg: str):
        self.log_output += msg + "\n"


class PolicyExperiment(Experiment):
    """Drives the port's env and SHAC trainer tick by tick.

    cfg: a SHAC config dict (``params.diff_env`` + ``params.config``), the
        tree of examples/cfg/shac/*.yaml.
    usd_path: when set, ``run()`` ticks with ``record`` on stream env 0's
        body transforms into a UsdRenderer stage written by
        :meth:`save_usd`.
    device: the trainer's device (CUDA unless named).
    """

    def __init__(self, cfg: dict, logdir: str = "logs/kit",
                 usd_path: Optional[str] = None, device=None):
        super().__init__()
        from ..algorithms.shac import SHAC

        cfg = copy.deepcopy(cfg)
        general = cfg.setdefault("params", {}).setdefault("general", {})
        general.setdefault("logdir", logdir)
        general.setdefault("seed", 0)
        self.trainer = SHAC(cfg, device=device)
        self.env = self.trainer.env
        self.usd_path = usd_path
        self._renderer = None
        self._net_loaded = False
        self.reset()

    # ------------------------------------------------------------------ ticks

    def reset(self):
        """The env back at the start states of the trainer's seed."""
        self.env.generator.manual_seed(self.trainer.seed)
        self.trainer.env_state = self.env.reset()
        self.render_time = 0.0
        self.log("reset")

    def train(self):
        """One SHAC epoch (actor window + critic fits)."""
        stats = self.trainer.train_epoch()
        loss = float(stats["actor_loss"])
        self.train_loss.append(loss)
        self.log(f"epoch {len(self.train_loss)}: actor loss {loss:.4f}")

    @torch.no_grad()
    def run(self):
        """One deterministic policy step of the env; records USD when
        enabled."""
        t = self.trainer
        if self.network_file and not self._net_loaded:
            t.load(self.network_file)
            self._net_loaded = True
            self.log(f"loaded network {self.network_file}")
        obs = self.env.batch_observations(t.env_state)
        if t.obs_rms is not None:
            obs = t.obs_rms.normalize(obs)
        act = t.actor(obs, deterministic=True) if t.stochastic_actor \
            else t.actor(obs)
        t.env_state, *_ = self.env.step(t.env_state, torch.tanh(act))
        self.render_time += self.env.dt
        if self.record and self.usd_path is not None:
            self._record_frame()

    # -------------------------------------------------------------- recording

    def _record_frame(self):
        from ..render import UsdRenderer
        from ..sim.model import State

        if self._renderer is None:
            self._renderer = UsdRenderer(self.env.model, self.usd_path)
        s = self.trainer.env_state
        self._renderer.update(State(joint_q=s.joint_q[0],
                                    joint_qd=s.joint_qd[0]),
                              self.render_time)

    def save_usd(self):
        if self._renderer is not None:
            self._renderer.save()
            self.log(f"wrote {self.usd_path}")


def load_experiment_script(path: str) -> Experiment:
    """Load a user experiment script and return its Experiment.

    The script runs as module code. Preferred contract: define
    ``make_experiment() -> Experiment``; a script that builds a
    module-level ``experiment`` at import time has that object returned.
    """
    ns = runpy.run_path(path)
    if "make_experiment" in ns:
        return ns["make_experiment"]()
    if "experiment" in ns and ns["experiment"] is not None:
        return ns["experiment"]
    raise ValueError(
        f"{path}: experiment script must define make_experiment() or a "
        "module-level `experiment` object")

"""What the port's trainers (SHAC, BPTT, PPO, SAC) share: playing a
checkpoint, saving a snapshot as ``<log_dir>/<name>.pt`` and logging scalars
to the TensorBoard writer and ``scalars.npz``, as each JAX trainer does in
its own copy."""

from __future__ import annotations

import os

import numpy as np
import torch


class Trainer:
    """Mixin over a trainer with ``log_dir``, ``writer``, ``scalars``,
    ``iter_count``, ``step_count``, ``max_epochs``, ``_snapshot()``,
    ``load(path)`` and ``run(num_games)``."""

    def play(self, cfg):
        """Loads ``cfg``'s general checkpoint and runs the player's
        games_num episodes."""
        self.load(cfg["params"]["general"]["checkpoint"])
        return self.run(cfg["params"]["config"].get("player", {}).get(
            "games_num", 1))

    def save(self, filename=None, snapshot=None):
        filename = filename or "best_policy"
        torch.save(snapshot if snapshot is not None else self._snapshot(),
                   os.path.join(self.log_dir, f"{filename}.pt"))

    def _log_scalars(self, time_elapse=None, **kwargs):
        for k, v in kwargs.items():
            self.scalars.setdefault(k, []).append(
                (self.iter_count, self.step_count, float(v)))
            if np.isfinite(float(v)):
                self.writer.log(k, float(v), self.iter_count, self.step_count,
                                time_elapse)
        if self.iter_count % 50 == 0 or self.iter_count == self.max_epochs:
            np.savez(os.path.join(self.log_dir, "scalars.npz"),
                     **{k: np.array(v) for k, v in self.scalars.items()})

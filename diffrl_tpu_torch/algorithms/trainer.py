"""What the port's trainers (SHAC, BPTT, PPO, SAC) share: playing a
checkpoint, saving a snapshot as ``<log_dir>/<name>.pt`` and logging scalars
to the TensorBoard writer and ``scalars.npz``, as each JAX trainer does in
its own copy. Under a process group only rank 0 writes files."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.mesh import process_rank
from ..utils.tb import TBWriter
from ..utils.time_report import traced


class Trainer:
    """Mixin over a trainer with ``log_dir``, ``writer``, ``scalars``,
    ``iter_count``, ``step_count``, ``max_epochs``, ``_snapshot()``,
    ``load(path)`` and ``run(num_games)``."""

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints, histories and logs:
        rank 0 of a process group, or a process without one."""
        return process_rank() == 0

    def _make_log_dir(self):
        """Creates ``log_dir`` and the TensorBoard writer (a writer that
        writes nothing off rank 0)."""
        if self.is_writer:
            os.makedirs(self.log_dir, exist_ok=True)
        self.writer = TBWriter(os.path.join(self.log_dir, "log")
                               if self.is_writer else None)

    def play(self, cfg):
        """Loads ``cfg``'s general checkpoint and runs the player's
        games_num episodes."""
        self.load(cfg["params"]["general"]["checkpoint"])
        return self.run(cfg["params"]["config"].get("player", {}).get(
            "games_num", 1))

    @traced("trainer.save")
    def save(self, filename=None, snapshot=None):
        """Writes ``snapshot`` (``_snapshot()`` unless given) to
        ``<log_dir>/<filename>.pt``, in a span of its own: ``torch.save``
        reads each tensor back from the card, and whether an epoch writes
        a best policy depends on the wall clock."""
        if not self.is_writer:
            return
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
        if self.is_writer and (self.iter_count % 50 == 0
                               or self.iter_count == self.max_epochs):
            np.savez(os.path.join(self.log_dir, "scalars.npz"),
                     **{k: np.array(v) for k, v in self.scalars.items()})

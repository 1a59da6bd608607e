"""Minibatches over flattened rollout buffers (port of
diffrl_tpu/utils/dataset.py; the reference's utils/dataset.py).

SHAC shuffles its whole critic dataset once per iteration inside the
trainer, as the JAX trainer does, so this iterator exists for the
reference's API and for host-driven tooling. It keeps the tensors on their
device and shuffles with a caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch


class CriticDataset:
    def __init__(self, batch_size, obs, target_values, shuffle=False,
                 drop_last=False, generator: Optional[torch.Generator] = None):
        obs = torch.as_tensor(obs)
        self.obs = obs.reshape(-1, obs.shape[-1])
        self.target_values = torch.as_tensor(target_values).reshape(-1)
        self.batch_size = batch_size
        self.generator = generator

        if shuffle:
            self.shuffle()

        if drop_last:
            self.length = self.obs.shape[0] // self.batch_size
        else:
            self.length = ((self.obs.shape[0] + self.batch_size - 1)
                           // self.batch_size)

    def shuffle(self):
        """Permute the rows with the dataset's generator (on the tensors'
        device; torch's default generator when none was given)."""
        index = torch.randperm(self.obs.shape[0], generator=self.generator,
                               device=self.obs.device)
        self.obs = self.obs[index]
        self.target_values = self.target_values[index]

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        start_idx = index * self.batch_size
        end_idx = min((index + 1) * self.batch_size, self.obs.shape[0])
        return {
            "obs": self.obs[start_idx:end_idx],
            "target_values": self.target_values[start_idx:end_idx],
        }

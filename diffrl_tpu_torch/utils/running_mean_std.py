"""Welford parallel running mean/var (port of
diffrl_tpu/utils/running_mean_std.py), as an nn.Module with buffers that
``update`` changes in place. The JAX package's RunningMeanStd is a value;
where it keeps an old value while a new one is made (SHAC normalizes a
whole window with the statistics frozen at its start), the port takes a
``copy()``."""

from __future__ import annotations

import torch
from torch import nn

from .. import default_device


class RunningMeanStd(nn.Module):
    def __init__(self, shape=(), epsilon=1e-4, device=None):
        super().__init__()
        device = default_device(device)
        self.register_buffer(
            "mean", torch.zeros(shape, dtype=torch.float32, device=device))
        self.register_buffer(
            "var", torch.ones(shape, dtype=torch.float32, device=device))
        # a fill, not torch.tensor(epsilon): a copy from a host scalar
        # blocks the host (SHAC takes a copy() every window)
        self.register_buffer(
            "count", torch.full((), epsilon, dtype=torch.float32,
                                device=device))

    @torch.no_grad()
    def update(self, batch) -> "RunningMeanStd":
        batch = batch.reshape(-1, *self.mean.shape)
        self.update_from_moments(batch.mean(dim=0),
                                 batch.var(dim=0, unbiased=False),
                                 batch.shape[0])
        return self

    @torch.no_grad()
    def update_from_moments(self, batch_mean, batch_var, batch_count):
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        M2 = m_a + m_b + delta ** 2 * self.count * batch_count / tot
        self.mean.copy_(new_mean)
        self.var.copy_(M2 / tot)
        self.count.copy_(tot)

    def copy(self) -> "RunningMeanStd":
        """An independent snapshot: later updates of either leave the other
        as it is."""
        out = RunningMeanStd(self.mean.shape, device=self.mean.device)
        out.load_state_dict(self.state_dict())
        return out

    def normalize(self, x, un_norm: bool = False):
        if un_norm:
            return x * torch.sqrt(self.var + 1e-5) + self.mean
        return (x - self.mean) / torch.sqrt(self.var + 1e-5)

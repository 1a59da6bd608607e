"""Actor and critic MLPs as nn.Modules (port of diffrl_tpu/models/mlp.py).

Same architecture as the JAX package's ``init_mlp``/``apply_mlp``: Linear
stacks with activation then LayerNorm (eps 1e-5) on hidden layers and a
plain last layer, orthogonal init (gain sqrt(2)) with zero bias, and for
the stochastic actor a state-independent learnable ``logstd``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import default_device

_ACTIVATIONS = {
    "elu": nn.functional.elu,
    "relu": nn.functional.relu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


class MLP(nn.Module):
    """Linear -> act -> LayerNorm on hidden layers, plain last layer."""

    def __init__(self, layer_dims: Sequence[int], activation: str = "elu",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        self.layer_dims = list(layer_dims)
        self.activation = activation
        n = len(layer_dims) - 1
        self.linears = nn.ModuleList(
            nn.Linear(layer_dims[i], layer_dims[i + 1], device=device)
            for i in range(n))
        self.norms = nn.ModuleList(
            nn.LayerNorm(layer_dims[i + 1], eps=1e-5, device=device)
            for i in range(n - 1))
        with torch.no_grad():
            for lin in self.linears:
                nn.init.orthogonal_(lin.weight, gain=math.sqrt(2.0),
                                    generator=generator)
                lin.bias.zero_()

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < last:
                x = self.norms[i](act(x))
        return x


def _units(cfg_network, key, default):
    sub = (cfg_network or {}).get(key, {})
    return list(sub.get("units", default)), sub.get("activation", "elu")


class ActorStochasticMLP(nn.Module):
    """Gaussian policy: mu MLP + learnable state-independent logstd."""

    def __init__(self, obs_dim, action_dim, cfg_network=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        units, activation = _units(cfg_network, "actor_mlp", [64, 64])
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.mu_net = MLP([obs_dim] + units + [action_dim], activation,
                          device=device, generator=generator)
        logstd_init = (cfg_network or {}).get("actor_logstd_init", -1.0)
        self.logstd = nn.Parameter(torch.full(
            (action_dim,), float(logstd_init), dtype=torch.float32,
            device=device))

    def forward(self, obs, deterministic: bool = False,
                generator: Optional[torch.Generator] = None):
        """mu, or with a generator and not deterministic, a reparameterized
        sample mu + eps * exp(logstd)."""
        mu = self.mu_net(obs)
        if deterministic or generator is None:
            return mu
        eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        return mu + eps * torch.exp(self.logstd)


class ActorDeterministicMLP(nn.Module):
    def __init__(self, obs_dim, action_dim, cfg_network=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        units, activation = _units(cfg_network, "actor_mlp", [64, 64])
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.mu_net = MLP([obs_dim] + units + [action_dim], activation,
                          device=device, generator=generator)

    def forward(self, obs, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        return self.mu_net(obs)


class CriticMLP(nn.Module):
    def __init__(self, obs_dim, cfg_network=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        units, activation = _units(cfg_network, "critic_mlp", [64, 64])
        self.critic_net = MLP([obs_dim] + units + [1], activation,
                              device=device, generator=generator)

    def forward(self, obs):
        return self.critic_net(obs)

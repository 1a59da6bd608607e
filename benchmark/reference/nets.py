"""The trainers' networks and running statistics for the benchmark's plain
reference: a frozen copy of the port's ``models/mlp.py`` (MLP,
ActorStochasticMLP, CriticMLP, ActorCriticPPO) and
``utils/running_mean_std.py``.

The networks are initialized as the port initializes them, in float32 on
the given device from the given generator (orthogonal weights, zero
biases), and only then cast to ``dtype``: the reference starts from the
weights that the program draws from the same seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_ACTIVATIONS = {"elu": nn.functional.elu, "relu": nn.functional.relu,
                "tanh": torch.tanh, "identity": lambda x: x}


class MLP(nn.Module):
    """Linear -> act -> LayerNorm on hidden layers, plain last layer."""

    def __init__(self, layer_dims, activation="elu", device=None,
                 generator=None, layer_norm=True, gain=math.sqrt(2.0)):
        super().__init__()
        n = len(layer_dims) - 1
        self.activation = activation
        self.linears = nn.ModuleList(
            nn.Linear(layer_dims[i], layer_dims[i + 1], device=device)
            for i in range(n))
        self.norms = nn.ModuleList(
            nn.LayerNorm(layer_dims[i + 1], eps=1e-5, device=device)
            for i in range(n - 1 if layer_norm else 0))
        with torch.no_grad():
            for lin in self.linears:
                nn.init.orthogonal_(lin.weight, gain=gain,
                                    generator=generator)
                lin.bias.zero_()

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < last:
                x = act(x)
                if self.norms:
                    x = self.norms[i](x)
        return x


def _units(cfg_network, key, default):
    sub = (cfg_network or {}).get(key, {})
    return list(sub.get("units", default)), sub.get("activation", "elu")


class ActorStochasticMLP(nn.Module):
    def __init__(self, obs_dim, action_dim, cfg_network, device, generator):
        super().__init__()
        units, activation = _units(cfg_network, "actor_mlp", [64, 64])
        self.mu_net = MLP([obs_dim] + units + [action_dim], activation,
                          device=device, generator=generator)
        self.logstd = nn.Parameter(torch.full(
            (action_dim,), float(cfg_network.get("actor_logstd_init", -1.0)),
            dtype=torch.float32, device=device))

    def forward(self, obs, eps):
        return self.mu_net(obs) + eps * torch.exp(self.logstd)


class CriticMLP(nn.Module):
    def __init__(self, obs_dim, cfg_network, device, generator):
        super().__init__()
        units, activation = _units(cfg_network, "critic_mlp", [64, 64])
        self.critic_net = MLP([obs_dim] + units + [1], activation,
                              device=device, generator=generator)

    def forward(self, obs):
        return self.critic_net(obs)


class ActorCriticPPO(nn.Module):
    """PPO's shared trunk with mu and value heads and a state-independent
    logstd."""

    def __init__(self, obs_dim, action_dim, cfg_network, device, generator):
        super().__init__()
        units, activation = _units(cfg_network, "mlp", [128, 64, 32])
        self.activation = activation
        self.trunk = MLP([obs_dim] + units, activation, device=device,
                         generator=generator, layer_norm=False)
        self.mu = MLP([units[-1], action_dim], device=device,
                      generator=generator, layer_norm=False, gain=0.01)
        self.value = MLP([units[-1], 1], device=device, generator=generator,
                         layer_norm=False, gain=1.0)
        sigma_init = (cfg_network.get("space", {}).get("continuous", {})
                      .get("sigma_init", {}).get("val", 0.0))
        self.logstd = nn.Parameter(torch.full(
            (action_dim,), float(sigma_init or 0.0), dtype=torch.float32,
            device=device))

    def forward(self, obs):
        h = _ACTIVATIONS[self.activation](self.trunk(obs))
        mu = self.mu(h)
        return mu, torch.exp(self.logstd).expand_as(mu), self.value(h)[..., 0]

    @staticmethod
    def log_prob(mu, sigma, actions):
        return torch.sum(-0.5 * ((actions - mu) / sigma) ** 2
                         - torch.log(sigma) - 0.5 * math.log(2.0 * math.pi),
                         dim=-1)

    @staticmethod
    def entropy(sigma):
        return torch.sum(torch.log(sigma)
                         + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)


class RunningMeanStd:
    """Parallel running mean and variance (the port's RunningMeanStd)."""

    def __init__(self, shape, device, dtype, epsilon=1e-4):
        self.mean = torch.zeros(shape, dtype=dtype, device=device)
        self.var = torch.ones(shape, dtype=dtype, device=device)
        self.count = torch.full((), epsilon, dtype=torch.float32,
                                device=device).to(dtype)

    @torch.no_grad()
    def update(self, batch):
        batch = batch.reshape(-1, *self.mean.shape)
        mean = batch.mean(0)
        var = ((batch - mean) ** 2).mean(0)
        n = batch.shape[0]
        delta = mean - self.mean
        tot = self.count + n
        m2 = (self.var * self.count + var * n
              + delta ** 2 * self.count * n / tot)
        self.mean = self.mean + delta * n / tot
        self.var = m2 / tot
        self.count = tot

    def copy(self):
        out = RunningMeanStd.__new__(RunningMeanStd)
        out.mean, out.var, out.count = self.mean, self.var, self.count
        return out

    def normalize(self, x, un_norm=False):
        if un_norm:
            return x * torch.sqrt(self.var + 1e-5) + self.mean
        return (x - self.mean) / torch.sqrt(self.var + 1e-5)

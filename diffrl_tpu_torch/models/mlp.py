"""Actor and critic MLPs as nn.Modules (port of diffrl_tpu/models/mlp.py).

Same architecture as the JAX package's ``init_mlp``/``apply_mlp``: Linear
stacks with activation then LayerNorm (eps 1e-5) on hidden layers (or the
activation alone where the JAX network has no LayerNorm) and a plain last
layer, orthogonal init (gain sqrt(2) unless the network says otherwise)
with zero bias, and for the stochastic actor a state-independent learnable
``logstd``. The model-free baselines' networks follow: PPO's shared-trunk
``ActorCriticPPO``, SAC's twin Q ``DoubleCriticMLP`` and squashed-Gaussian
``SACActor``. Their random draws come in as tensors (``eps``) or from a
``torch.Generator``.
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
                 device=None, generator: Optional[torch.Generator] = None,
                 layer_norm: bool = True, gain: float = math.sqrt(2.0)):
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


class DoubleCriticMLP(nn.Module):
    """Twin Q-networks for SAC on (obs, action), each with LayerNorm on its
    hidden layers as the JAX package's init_mlp gives them."""

    def __init__(self, obs_dim, action_dim, cfg_network=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        units, activation = _units(cfg_network, "critic_mlp", [256, 256])
        dims = [obs_dim + action_dim] + units + [1]
        self.q1 = MLP(dims, activation, device=device, generator=generator)
        self.q2 = MLP(dims, activation, device=device, generator=generator)

    def forward(self, obs, actions):
        x = torch.cat([obs, actions], dim=-1)
        return self.q1(x), self.q2(x)


class ActorCriticPPO(nn.Module):
    """PPO's shared-trunk actor-critic (rl_games 'continuous_a2c_logstd'):
    a trunk with the activation after every layer and no LayerNorm, a mu
    head (orthogonal gain 0.01) and a value head (gain 1) off it, and a
    state-independent logstd set to ``space.continuous.sigma_init.val``."""

    def __init__(self, obs_dim, action_dim, cfg_network=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        units, activation = _units(cfg_network, "mlp", [128, 64, 32])
        self.activation = activation
        self.action_dim = action_dim
        self.trunk = MLP([obs_dim] + units, activation, device=device,
                         generator=generator, layer_norm=False)
        self.mu = MLP([units[-1], action_dim], device=device,
                      generator=generator, layer_norm=False, gain=0.01)
        self.value = MLP([units[-1], 1], device=device, generator=generator,
                         layer_norm=False, gain=1.0)
        sigma_init = ((cfg_network or {}).get("space", {})
                      .get("continuous", {}).get("sigma_init", {})
                      .get("val", 0.0))
        self.logstd = nn.Parameter(torch.full(
            (action_dim,), float(sigma_init or 0.0), dtype=torch.float32,
            device=device))

    def forward(self, obs):
        """(mu [.., A], sigma [.., A], value [..])."""
        h = _ACTIVATIONS[self.activation](self.trunk(obs))
        mu = self.mu(h)
        sigma = torch.exp(self.logstd).expand_as(mu)
        return mu, sigma, self.value(h)[..., 0]

    @staticmethod
    def log_prob(mu, sigma, actions):
        return torch.sum(-0.5 * ((actions - mu) / sigma) ** 2
                         - torch.log(sigma) - 0.5 * math.log(2.0 * math.pi),
                         dim=-1)

    @staticmethod
    def entropy(sigma):
        return torch.sum(torch.log(sigma)
                         + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)


class SACActor(nn.Module):
    """SAC's squashed-Gaussian policy: an MLP without LayerNorm gives mu and
    a log_std that a tanh rescales into ``log_std_bounds``; actions are
    tanh(mu + eps std) with the log-det-Jacobian correction."""

    def __init__(self, obs_dim, action_dim, cfg_network=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        units, activation = _units(cfg_network, "mlp", [256, 128, 64])
        if "activation" not in (cfg_network or {}).get("mlp", {}):
            activation = "relu"
        self.action_dim = action_dim
        self.net = MLP([obs_dim] + units + [2 * action_dim], activation,
                       device=device, generator=generator, layer_norm=False)
        lo, hi = (cfg_network or {}).get("log_std_bounds", [-5.0, 2.0])
        self.log_std_min, self.log_std_max = float(lo), float(hi)

    def dist(self, obs):
        mu, log_std = torch.chunk(self.net(obs), 2, dim=-1)
        t = torch.tanh(log_std)
        log_std = self.log_std_min + 0.5 * (
            self.log_std_max - self.log_std_min) * (t + 1.0)
        return mu, torch.exp(log_std)

    def sample(self, obs, eps=None, generator: Optional[torch.Generator] =
               None):
        """(action in [-1, 1], log_prob) with the standard normal draws
        ``eps`` [.., A], or draws from ``generator`` when eps is None."""
        mu, std = self.dist(obs)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        action = torch.tanh(mu + eps * std)
        log_prob = torch.sum(
            -0.5 * eps ** 2 - torch.log(std) - 0.5 * math.log(2.0 * math.pi)
            - torch.log(torch.maximum(1.0 - action ** 2,
                                      action.new_full((), 1e-6))), dim=-1)
        return action, log_prob

    def mean_action(self, obs):
        return torch.tanh(self.dist(obs)[0])

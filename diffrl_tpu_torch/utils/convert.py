"""Carry the JAX package's network weights into the port's modules.

The JAX package keeps parameters as pytrees: an MLP is a list of layers
``{"w" [out, in], "b" [out], "ln_scale" [out], "ln_bias" [out]}`` (the
LayerNorm entries on hidden layers only), a stochastic actor is
``{"mlp": [...], "logstd" [A]}`` and a RunningMeanStd holds ``mean``,
``var`` and ``count``. The converters take those pytrees with numpy
leaves (``jax.device_get`` of the parameters, or the arrays read out of a
checkpoint by the caller) and never unpickle JAX classes themselves.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..models.mlp import MLP, ActorDeterministicMLP, ActorStochasticMLP, \
    CriticMLP
from .running_mean_std import RunningMeanStd


def _copy(dst: torch.Tensor, src, name: str):
    a = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {a.shape} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.as_tensor(a, device=dst.device))


@torch.no_grad()
def load_mlp(module: MLP, layers: List[Mapping[str, Any]]) -> MLP:
    """Copy a JAX MLP parameter list into ``module`` in place."""
    if len(layers) != len(module.linears):
        raise ValueError(f"{len(layers)} layers do not fit an MLP of "
                         f"{len(module.linears)}")
    for i, (layer, lin) in enumerate(zip(layers, module.linears)):
        _copy(lin.weight, layer["w"], f"layer {i} w")
        _copy(lin.bias, layer["b"], f"layer {i} b")
        has_ln = i < len(module.norms)
        if has_ln != ("ln_scale" in layer):
            raise ValueError(f"layer {i}: LayerNorm present in one side only")
        if has_ln:
            _copy(module.norms[i].weight, layer["ln_scale"],
                  f"layer {i} ln_scale")
            _copy(module.norms[i].bias, layer["ln_bias"],
                  f"layer {i} ln_bias")
    return module


def actor_from_jax(params: Mapping[str, Any], obs_dim: int, action_dim: int,
                   cfg_network: Optional[Dict] = None, stochastic: bool = True,
                   device=None):
    """ActorStochasticMLP (params with "logstd") or ActorDeterministicMLP
    holding the JAX actor's weights."""
    if stochastic:
        actor = ActorStochasticMLP(obs_dim, action_dim, cfg_network,
                                   device=device)
        with torch.no_grad():
            _copy(actor.logstd, params["logstd"], "logstd")
    else:
        actor = ActorDeterministicMLP(obs_dim, action_dim, cfg_network,
                                      device=device)
    load_mlp(actor.mu_net, params["mlp"])
    return actor


def critic_from_jax(params: Mapping[str, Any], obs_dim: int,
                    cfg_network: Optional[Dict] = None, device=None):
    critic = CriticMLP(obs_dim, cfg_network, device=device)
    load_mlp(critic.critic_net, params["mlp"])
    return critic


@torch.no_grad()
def running_mean_std_from_jax(rms: Mapping[str, Any], device=None
                              ) -> RunningMeanStd:
    """RunningMeanStd from a mapping (or object) with mean, var and count."""
    get = rms.__getitem__ if isinstance(rms, Mapping) else \
        (lambda k: getattr(rms, k))
    mean = np.asarray(get("mean"), np.float32)
    out = RunningMeanStd(mean.shape, device=device)
    _copy(out.mean, mean, "mean")
    _copy(out.var, get("var"), "var")
    _copy(out.count, get("count"), "count")
    return out

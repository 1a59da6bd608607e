"""Carry the JAX package's network weights into the port's modules.

The JAX package keeps parameters as pytrees: an MLP is a list of layers
``{"w" [out, in], "b" [out], "ln_scale" [out], "ln_bias" [out]}`` (the
LayerNorm entries on hidden layers only), a stochastic actor is
``{"mlp": [...], "logstd" [A]}`` and a RunningMeanStd holds ``mean``,
``var`` and ``count``. Adam's state (optax ``ScaleByAdamState``) holds
``mu`` and ``nu`` pytrees shaped like the parameters and a ``count``. The
model-free networks are ``{"trunk": [...], "mu": [...], "value": [...],
"logstd"}`` (PPO's ActorCriticPPO), ``{"q1": [...], "q2": [...]}`` (SAC's
DoubleCriticMLP) and ``{"mlp": [...]}`` (SACActor); SAC's temperature is a
scalar ``log_alpha`` with an Adam state of its own, and PPO's optimizer is
optax.scale_by_adam alone (torch's Adam at the carried learning rate). The
config-built A2CNetwork is ``{"trunk": {"cnn": [{"w" HWIO, "b"}], "rnn":
[{"wi", "wh", "b"}], "mlp": [...]}, "trunk_critic" (separate trunks),
"mu", "logstd" or "sigma_head" (continuous) or "logits": [[...], ...]
(one MLP per discrete head), "value"}``; a conv weight goes into the
port's OIHW Conv2d permuted. The converters take
those pytrees with numpy leaves (``jax.device_get`` of the parameters, or
the arrays read out of a checkpoint by the caller) and never unpickle JAX
classes themselves. ``checkpoint_from_jax`` turns the dict of a JAX
SHAC/BPTT checkpoint, unpickled by the caller, into the port's checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.builders import A2CNetwork
from ..models.mlp import (MLP, ActorCriticPPO, ActorDeterministicMLP,
                          ActorStochasticMLP, CriticMLP, DoubleCriticMLP,
                          SACActor)
from .running_mean_std import RunningMeanStd


def _copy(dst: torch.Tensor, src, name: str):
    a = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {a.shape} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.as_tensor(a, device=dst.device))


def _mlp_pairs(module: MLP, layers: List[Mapping[str, Any]]
               ) -> Iterator[Tuple[str, torch.Tensor, Any]]:
    if len(layers) != len(module.linears):
        raise ValueError(f"{len(layers)} layers do not fit an MLP of "
                         f"{len(module.linears)}")
    for i, (layer, lin) in enumerate(zip(layers, module.linears)):
        yield f"layer {i} w", lin.weight, layer["w"]
        yield f"layer {i} b", lin.bias, layer["b"]
        has_ln = i < len(module.norms)
        if has_ln != ("ln_scale" in layer):
            raise ValueError(f"layer {i}: LayerNorm present in one side only")
        if has_ln:
            yield f"layer {i} ln_scale", module.norms[i].weight, \
                layer["ln_scale"]
            yield f"layer {i} ln_bias", module.norms[i].bias, layer["ln_bias"]


def _a2c_pairs(net: A2CNetwork, params):
    for key in ("trunk", "trunk_critic"):
        trunk = getattr(net, key)
        if trunk is None:
            continue
        tp = params[key]
        for i, (conv, layer) in enumerate(zip(trunk.cnn or (),
                                              tp.get("cnn", ()))):
            # HWIO -> OIHW, a view of the leaf
            yield f"{key} cnn {i} w", conv.weight, np.transpose(
                np.asarray(layer["w"]), (3, 2, 0, 1))
            yield f"{key} cnn {i} b", conv.bias, layer["b"]
        for i, (cell, layer) in enumerate(zip(trunk.rnn or (),
                                              tp.get("rnn", ()))):
            for k in ("wi", "wh", "b"):
                yield f"{key} rnn {i} {k}", getattr(cell, k), layer[k]
        if trunk.mlp is not None:
            for name, dst, src in _mlp_pairs(trunk.mlp, tp["mlp"]):
                yield f"{key} mlp {name}", dst, src
    heads = [("value", net.value, params["value"])]
    if net.space == "continuous":
        heads.append(("mu", net.mu, params["mu"]))
        if net.fixed_sigma:
            yield "logstd", net.logstd, params["logstd"]
        else:
            heads.append(("sigma_head", net.sigma_head, params["sigma_head"]))
    else:
        heads += [(f"logits {i}", head, layers) for i, (head, layers) in
                  enumerate(zip(net.logits, params["logits"]))]
    for key, head, layers in heads:
        for name, dst, src in _mlp_pairs(head, layers):
            yield f"{key} {name}", dst, src


def param_pairs(module, params) -> List[Tuple[str, torch.Tensor, Any]]:
    """(name, parameter of ``module``, leaf of ``params`` in the port's
    layout) for a network of models.mlp or models.builders and a pytree
    shaped like its JAX parameters; ``module`` may also be a lone parameter
    (SAC's log_alpha) and ``params`` its leaf. A leaf whose layout differs
    (a conv weight) comes as a numpy view of it in the port's layout."""
    if isinstance(module, torch.Tensor):
        return [("tensor", module, params)]
    if isinstance(module, A2CNetwork):
        return list(_a2c_pairs(module, params))
    if isinstance(module, ActorCriticPPO):
        parts = (("trunk", module.trunk), ("mu", module.mu),
                 ("value", module.value))
    elif isinstance(module, DoubleCriticMLP):
        parts = (("q1", module.q1), ("q2", module.q2))
    elif isinstance(module, SACActor):
        parts = (("mlp", module.net),)
    else:
        parts = (("mlp", module.mu_net if hasattr(module, "mu_net")
                  else module.critic_net),)
    pairs = [(f"{key} {name}", dst, src) for key, net in parts
             for name, dst, src in _mlp_pairs(net, params[key])]
    if isinstance(module, (ActorStochasticMLP, ActorCriticPPO)):
        pairs.append(("logstd", module.logstd, params["logstd"]))
    return pairs


@torch.no_grad()
def load_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX actor's or critic's parameters into ``module`` in place."""
    for name, dst, src in param_pairs(module, params):
        _copy(dst, src, name)
    return module


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return np.array(tree, dtype=np.float32)


def jax_params(module, like):
    """``module``'s parameters back in the JAX layout: a pytree of numpy
    arrays shaped like ``like`` (the JAX parameters it was loaded from, or
    any tree of that structure)."""
    out = _numpy_tree(like)
    for _, dst, view in param_pairs(module, out):
        np.copyto(view, dst.detach().cpu().numpy())
    return out


@torch.no_grad()
def load_adam_state(optimizer: torch.optim.Adam, module, mu, nu, count
                    ) -> torch.optim.Adam:
    """Set ``optimizer``'s state for ``module``'s parameters (or for a lone
    parameter) from optax's Adam state: exp_avg = mu, exp_avg_sq = nu, step
    = count (optax and torch apply the same bias corrections to the same
    moments). A fused or capturable Adam keeps its step on the parameter's
    device, as torch does."""
    group = optimizer.param_groups[0]
    on_device = group.get("fused") or group.get("capturable")
    for (name, p, m), (_, _, v) in zip(param_pairs(module, mu),
                                       param_pairs(module, nu)):
        exp_avg, exp_avg_sq = torch.empty_like(p), torch.empty_like(p)
        _copy(exp_avg, m, f"{name} mu")
        _copy(exp_avg_sq, v, f"{name} nu")
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32,
                                 device=p.device if on_device else None),
            "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    return optimizer


def actor_from_jax(params: Mapping[str, Any], obs_dim: int, action_dim: int,
                   cfg_network: Optional[Dict] = None, stochastic: bool = True,
                   device=None):
    """ActorStochasticMLP (params with "logstd") or ActorDeterministicMLP
    holding the JAX actor's weights."""
    cls = ActorStochasticMLP if stochastic else ActorDeterministicMLP
    return load_params(cls(obs_dim, action_dim, cfg_network, device=device),
                       params)


def critic_from_jax(params: Mapping[str, Any], obs_dim: int,
                    cfg_network: Optional[Dict] = None, device=None):
    return load_params(CriticMLP(obs_dim, cfg_network, device=device),
                       params)


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


def checkpoint_from_jax(state: Mapping[str, Any], cfg: Dict, path: str
                        ) -> Dict[str, Any]:
    """The port's SHAC/BPTT checkpoint (the ``.pt`` of ``Trainer.save``,
    written to ``path`` and returned) of a JAX one: ``state`` is the dict
    of the JAX trainer's ``.pkl`` with numpy leaves ("actor", and where
    present "critic", "target_critic", "obs_rms", "ret_rms" and the
    counters). ``cfg``'s network names the actor class and the widths. The
    optimizer states are not carried."""
    network = cfg.get("params", {}).get("network", {})
    stochastic = network.get("actor", "ActorStochasticMLP") == \
        "ActorStochasticMLP"
    mlp = state["actor"]["mlp"]
    obs_dim, act_dim = (int(np.shape(mlp[0]["w"])[1]),
                        int(np.shape(mlp[-1]["w"])[0]))
    out: Dict[str, Any] = {"actor": actor_from_jax(
        state["actor"], obs_dim, act_dim, network, stochastic,
        device="cpu").state_dict()}
    for key in ("critic", "target_critic"):
        if state.get(key) is not None:
            out[key] = critic_from_jax(state[key], obs_dim, network,
                                       device="cpu").state_dict()
    for key in ("obs_rms", "ret_rms"):
        out[key] = (running_mean_std_from_jax(state[key], device="cpu")
                    .state_dict() if state.get(key) is not None else None)
    for key in ("iter_count", "step_count"):
        if key in state:
            out[key] = int(state[key])
    torch.save(out, path)
    return out

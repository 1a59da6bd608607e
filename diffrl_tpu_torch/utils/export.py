"""Policy export for serving: ``torch.export`` artifacts (port of
diffrl_tpu/utils/export.py, whose artifacts are StableHLO).

A trained policy becomes an ExportedProgram saved to one file: the
inference path as a graph of ATen operators with its weights, which
``torch.export.load`` runs without the training code or a pickle of
Python objects. The exported function is the evaluation policy: obs
normalization (frozen statistics) -> actor mean -> tanh, batch-polymorphic
over the leading dimension.
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import default_device


class _Fn(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable, example_args, path: Optional[str] = None,
              batch_polymorphic: bool = True) -> bytes:
    """Export ``fn`` (a module or a function of positional tensors) with
    ``torch.export.export`` and serialize it with ``torch.export.save``.

    example_args: tuple of tensors fixing shapes, dtypes and the device.
    batch_polymorphic: each argument's leading axis becomes one symbolic
    dimension ``batch`` (at least 1), so one artifact serves any batch size.
    torch.export specializes an example dimension of size 1, so the
    examples must have a batch of at least 2.
    Returns the serialized bytes; writes them to ``path`` when given.
    """
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    dynamic = None
    if batch_polymorphic:
        if any(a.shape[0] < 2 for a in example_args):
            raise ValueError("batch_polymorphic export needs example "
                             "batches of at least 2 (torch.export "
                             "specializes a size of 1)")
        batch = torch.export.Dim("batch", min=1)
        dynamic = tuple({0: batch} for _ in example_args)
    exported = torch.export.export(module, tuple(example_args),
                                   dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_exported(path_or_bytes) -> Callable:
    """Load an artifact of ``export_fn`` (a path or its bytes) back into a
    callable module."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    return torch.export.load(path_or_bytes).module()


class Policy(nn.Module):
    """The deterministic evaluation policy of a SHAC/BPTT actor: obs
    normalized by frozen statistics -> the actor's mean -> tanh."""

    def __init__(self, actor: nn.Module, mean=None, var=None):
        super().__init__()
        self.actor = actor
        self.normalize = mean is not None
        if self.normalize:
            self.register_buffer("mean", mean.detach().clone())
            self.register_buffer("var", var.detach().clone())

    def forward(self, obs):
        if self.normalize:
            obs = (obs - self.mean) / torch.sqrt(self.var + 1e-5)
        return torch.tanh(self.actor(obs, deterministic=True))


def shac_policy_fn(checkpoint: str, cfg: Dict, device=None):
    """The deterministic inference policy of a port SHAC/BPTT checkpoint
    (``Trainer.save``'s ``.pt``: ``actor`` and ``obs_rms`` state dicts) on
    ``device`` (CUDA unless named). Returns (policy, obs_dim, act_dim)
    where policy(obs [B, obs_dim]) -> actions in [-1, 1], the evaluation
    path of algorithms/shac.py."""
    from ..models.mlp import ActorDeterministicMLP, ActorStochasticMLP

    dev = default_device(device)
    state = torch.load(checkpoint, map_location=dev)
    actor_sd = state["actor"]
    network = cfg.get("params", {}).get("network", {})
    actor_name = network.get("actor", "ActorStochasticMLP")
    weights = [k for k in actor_sd if k.startswith("mu_net.linears.")
               and k.endswith(".weight")]
    obs_dim = int(actor_sd[weights[0]].shape[1])
    act_dim = int(actor_sd[weights[-1]].shape[0])
    actor_cls = {"ActorStochasticMLP": ActorStochasticMLP,
                 "ActorDeterministicMLP": ActorDeterministicMLP}[actor_name]
    actor = actor_cls(obs_dim, act_dim, network, device=dev)
    actor.load_state_dict(actor_sd)
    rms = state.get("obs_rms")
    policy = Policy(actor, *((rms["mean"], rms["var"]) if rms is not None
                             else ()))
    return policy.eval().requires_grad_(False), obs_dim, act_dim

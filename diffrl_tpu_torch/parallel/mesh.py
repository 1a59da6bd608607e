"""Data parallelism over the env axis with torch.distributed (port of
diffrl_tpu/parallel/mesh.py).

The JAX package shards the env axis over a ``data`` mesh and lets XLA
insert the reductions. Here every rank is a process that holds rows
``[r E/W, (r + 1) E/W)`` of a global batch of E envs, with the learner's
state replicated, and the trainers call the collectives below where JAX's
reductions run: one flat all-reduce of the gradients per optimizer step,
sums of loss terms, the moment merge of the running statistics and an
all-gather of the per-env episode records.

Backends: NCCL for CUDA tensors, gloo for the CPU. A caller may name gloo
for CUDA tensors too (two ranks sharing one card, which NCCL refuses);
nothing switches backend on its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .. import default_device

#: seconds a rendezvous or a collective waits for a lost peer before it
#: raises (torch's default is 10 minutes for gloo and NCCL)
TIMEOUT_S = 300.0


def process_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
    """The device a rank trains on: ``device`` (CUDA unless the caller
    names another), and for CUDA without an index
    ``cuda:{LOCAL_RANK % device_count}``, made the current device."""
    dev = default_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = TIMEOUT_S):
    """``torch.distributed.init_process_group`` for one process of a data
    mesh. ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to torchrun's MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE and RANK. ``backend`` defaults to NCCL when ``device``
    (CUDA unless named) is a CUDA device, else gloo. A peer that does not
    arrive within ``timeout_s`` makes the rendezvous raise."""
    if dist.is_initialized():
        return dist.group.WORLD
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None \
        else num_processes
    rank = int(env.get("RANK", 0)) if process_id is None else process_id
    if backend is None:
        backend = "nccl" if local_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: this rank's place in ``group`` (None: no process
    group, so no collective runs) and the device it trains on."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def rows(self, n_global: int) -> slice:
        """This rank's rows of an axis of ``n_global`` entries."""
        n = n_global // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def make_data_mesh(num_devices: Optional[int] = None, device=None
                   ) -> DataMesh:
    """The mesh over every rank of the default process group, or a world
    of one without a group. ``num_devices``, when given, must be the
    world's size (one device per rank)."""
    dev = local_device(device)
    if not dist.is_initialized():
        size, rank, group = 1, 0, None
    else:
        size, rank, group = (dist.get_world_size(), dist.get_rank(),
                             dist.group.WORLD)
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices={num_devices}: the process group "
                         f"has {size} ranks, one device each")
    return DataMesh(group, rank, size, dev)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_env_axis(mesh: DataMesh, tree, num_envs: Optional[int] = None):
    """This rank's rows of every [E, ...] tensor of ``tree`` (tensors,
    dicts, lists, tuples and dataclasses such as EnvState); scalars and
    other leaves are kept whole (replicated).

    With ``num_envs`` exactly the tensors whose leading dim equals it are
    split; without it the JAX package's heuristic applies (leading dim at
    least the mesh size and divisible by it), which can split a small leaf
    that is not per env."""
    def place(x):
        if x.ndim < 1:
            return x
        n = x.shape[0]
        if num_envs is not None:
            split = n == num_envs
        else:
            split = n >= mesh.size and n % mesh.size == 0
        return x[mesh.rows(n)] if split else x

    return _map(place, tree)


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, nn.Module):
        out += list(tree.parameters()) + list(tree.buffers())
    else:
        _map(out.append, tree)
    return out


@torch.no_grad()
def replicate(mesh: DataMesh, tree):
    """Broadcast rank 0's values of every tensor of ``tree`` (modules'
    parameters and buffers included) in place; returns ``tree``."""
    if mesh.group is not None:
        for t in _tensors(tree):
            dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
    return tree


def all_reduce_grads(mesh: Optional[DataMesh],
                     params: Sequence[torch.Tensor],
                     extra: Optional[torch.Tensor] = None):
    """Sums the ``.grad`` of ``params`` over the mesh in one all-reduce of
    a flat buffer, which also carries ``extra`` (loss terms to sum, a
    float32 vector). Every gradient must be set. Returns ``extra`` summed
    (``extra`` itself without a group)."""
    if mesh is None or mesh.group is None:
        return extra
    grads = [p.grad for p in params]
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.detach().reshape(-1))
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return None if extra is None else flat[offset:].view_as(extra)


def local_rows(mesh: Optional[DataMesh], idx: torch.Tensor, num_envs: int):
    """(rows of this rank's [K x E_local] records, a bool mask of the ones
    this rank holds) for indices ``idx`` into the global [K x E] records
    (row k E + e, E = ``num_envs``); the rows a rank does not hold point
    at its row k E_local. (idx, None) on a mesh of one rank or none."""
    if mesh is None or mesh.size == 1:
        return idx, None
    rows = mesh.rows(num_envs)
    n = rows.stop - rows.start
    e = idx % num_envs - rows.start
    own = (e >= 0) & (e < n)
    return idx // num_envs * n + e.clamp(0, n - 1), own


def masked_mean(x: torch.Tensor, own: Optional[torch.Tensor]):
    """x.mean(), or with ``own`` ([rows] bool, rows leading x) this rank's
    part of the mean over all ranks' rows: the sum of its rows over the
    global count x.numel()."""
    if own is None:
        return x.mean()
    own = own.reshape(own.shape + (1,) * (x.ndim - own.ndim))
    return torch.where(own, x, torch.zeros_like(x)).sum() / x.numel()


def all_reduce_sum(mesh: Optional[DataMesh], x: torch.Tensor
                   ) -> torch.Tensor:
    """x summed over the mesh (a new tensor; x itself without a group)."""
    if mesh is None or mesh.group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def all_gather(mesh: Optional[DataMesh], x: torch.Tensor) -> torch.Tensor:
    """[W, *x.shape]: every rank's x in rank order ([1, ...] without a
    group)."""
    if mesh is None or mesh.group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.stack(parts)


def gather_envs(mesh: Optional[DataMesh], x: torch.Tensor) -> torch.Tensor:
    """[..., E_global] from every rank's [..., E_local] records (the env
    axis last), in the global env order."""
    parts = all_gather(mesh, x)
    return torch.movedim(parts, 0, -2).reshape(*x.shape[:-1], -1)


def moments(mesh: Optional[DataMesh], batch: torch.Tensor):
    """(mean, population variance) over the rows of the global batch whose
    shards the ranks hold (``batch`` [n, ...], the same n on every rank):
    each rank's count, mean and M2 gathered and merged (Chan et al.), in
    rank order, the same on every rank."""
    mean = batch.mean(dim=0)
    var = batch.var(dim=0, unbiased=False)
    if mesh is None or mesh.group is None:
        return mean, var
    n = batch.shape[0]
    parts = all_gather(mesh, torch.stack([mean, var]))   # [W, 2, ...]
    means, vars_ = parts[:, 0], parts[:, 1]
    g_mean = means.mean(dim=0)
    m2 = (vars_ * n).sum(dim=0) + (n * (means - g_mean) ** 2).sum(dim=0)
    return g_mean, m2 / (n * mesh.size)


def draw(mesh: Optional[DataMesh], fn: Callable, shape) -> torch.Tensor:
    """``fn(shape)`` of a random draw for this rank's rows: the draw is made
    for the global batch (the leading dim times the mesh size) and this
    rank's rows kept, so that W ranks draw what one process draws."""
    shape = tuple(shape)
    if mesh is None or mesh.size == 1:
        return fn(shape)
    full = fn((shape[0] * mesh.size,) + shape[1:])
    return full[mesh.rows(full.shape[0])]

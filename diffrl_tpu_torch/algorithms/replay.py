"""Replay buffers, uniform and proportional-prioritized, resident on the
device (port of diffrl_tpu/algorithms/replay.py).

The buffer is a dict of [capacity, ...] tensors (obs, actions, rews,
next_obs, dones, and for prioritized replay the priorities and their
running maximum) written as a ring, plus its cursor ``idx`` and fill
``count``. The cursor and the fill depend only on how many transitions were
added, so they stay host integers: no write reads anything back from the
device. Prioritized sampling inverts the priorities' cumulative sum with a
``searchsorted``, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_buffer(capacity: int, obs_dim: int, act_dim: int,
                prioritized: bool = False, device=None):
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    buf = dict(obs=zeros(capacity, obs_dim), actions=zeros(capacity, act_dim),
               rews=zeros(capacity), next_obs=zeros(capacity, obs_dim),
               dones=zeros(capacity), idx=0, count=0)
    if prioritized:
        buf["prio"] = zeros(capacity)
        buf["max_prio"] = torch.ones((), device=device)
    return buf


def add(buf, obs, actions, rews, next_obs, dones):
    """Writes a batch of E transitions at the cursor, in place (the
    capacity is a multiple of E, so a batch never wraps); fresh entries get
    the largest priority seen. Returns ``buf``."""
    i, E = buf["idx"], obs.shape[0]
    cap = buf["obs"].shape[0]
    for k, v in (("obs", obs), ("actions", actions), ("rews", rews),
                 ("next_obs", next_obs), ("dones", dones)):
        buf[k][i:i + E] = v
    if "prio" in buf:
        buf["prio"][i:i + E] = buf["max_prio"]
    buf["idx"] = (i + E) % cap
    buf["count"] = min(buf["count"] + E, cap)
    return buf


def sample_uniform(buf, batch_size: int,
                   generator: Optional[torch.Generator] = None, idx=None):
    """(indices, batch, weights of 1): ``idx`` drawn uniformly from the
    filled rows by ``generator`` unless given."""
    n = max(buf["count"], 1)
    if idx is None:
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=buf["obs"].device)
    return idx, _gather(buf, idx), torch.ones(
        (batch_size,), device=buf["obs"].device)


def sample_prioritized(buf, batch_size: int, alpha: float = 0.6,
                       beta: float = 0.4,
                       generator: Optional[torch.Generator] = None, u=None):
    """Proportional prioritization: P(i) = p_i^alpha / sum over the filled
    rows, importance weights (N P(i))^-beta over their largest. ``u``
    [batch_size] are the uniform draws in [0, 1) that pick the rows
    (scaled by the total, inverted through the cumulative sum), from
    ``generator`` unless given. Returns (indices, batch, weights)."""
    prio = buf["prio"]
    cap = prio.shape[0]
    n = max(buf["count"], 1)
    valid = torch.arange(cap, device=prio.device) < n
    zero = prio.new_zeros(())
    p = torch.where(valid, prio, zero) ** alpha
    p = torch.where(valid, torch.clamp(p, min=1e-12), zero)
    cdf = torch.cumsum(p, 0)
    total = cdf[-1]
    if u is None:
        u = torch.rand((batch_size,), generator=generator,
                       device=prio.device)
    idx = torch.clamp(torch.searchsorted(cdf, u * total), 0, n - 1)
    probs = p[idx] / total
    w = (n * probs) ** (-beta)
    w = w / torch.clamp(torch.max(w), min=1e-12)
    return idx, _gather(buf, idx), w


def update_priorities(buf, idx, td_errors, eps: float = 1e-6):
    """Sets the sampled rows' priorities to |td| + eps and raises the
    running maximum, in place. Returns ``buf``."""
    prio = torch.abs(td_errors) + eps
    buf["prio"][idx] = prio
    buf["max_prio"] = torch.maximum(buf["max_prio"], torch.max(prio))
    return buf


def _gather(buf, idx):
    return tuple(buf[k][idx] for k in ("obs", "actions", "rews", "next_obs",
                                       "dones"))

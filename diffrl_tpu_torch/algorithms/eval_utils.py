"""Batched policy evaluation (port of diffrl_tpu/algorithms/eval_utils.py,
and in ``policy_act_fn`` the policy of SHAC.evaluate_policy,
diffrl_tpu/algorithms/shac.py).

Episode statistics stay on the env's device; the host reads them once per
chunk of steps.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


@torch.no_grad()
def batched_eval(env, act_fn: Callable, num_games: int, gamma: float = 1.0,
                 chunk: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
    """Evaluate a policy on a batched env until ``num_games`` episodes end.

    act_fn(obs, generator) -> actions. Runs whole chunks of
    ``chunk`` steps (default min(episode_length, 256)).
    Returns (mean_episode_reward, mean_discounted_reward, mean_length).
    """
    chunk = chunk or min(env.episode_length, 256)
    E, dev = env.num_envs, env.device
    env_state = env.reset()
    obs = env.batch_observations(env_state)
    ep_rew = torch.zeros(E, device=dev)
    ep_disc = torch.zeros(E, device=dev)
    ep_gamma = torch.ones(E, device=dev)
    ep_len = torch.zeros(E, dtype=torch.int32, device=dev)
    tot = dict(sum_rew=0.0, sum_disc=0.0, sum_len=0.0, games=0.0)
    while tot["games"] < num_games:
        sums = torch.zeros(4, device=dev)
        for _ in range(chunk):
            actions = act_fn(obs, generator)
            env_state, obs, rew, done, _ = env.step(env_state, actions)
            ep_rew = ep_rew + rew
            ep_disc = ep_disc + ep_gamma * rew
            ep_len = ep_len + 1
            zero = torch.zeros_like(ep_rew)
            sums += torch.stack([
                torch.sum(torch.where(done, ep_rew, zero)),
                torch.sum(torch.where(done, ep_disc, zero)),
                torch.sum(torch.where(done, ep_len, 0)).to(zero.dtype),
                torch.sum(done).to(zero.dtype),
            ])
            ep_rew = torch.where(done, zero, ep_rew)
            ep_disc = torch.where(done, zero, ep_disc)
            ep_gamma = torch.where(done, torch.ones_like(ep_gamma),
                                   ep_gamma * gamma)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
        host = sums.tolist()  # one host sync per chunk
        for k, v in zip(("sum_rew", "sum_disc", "sum_len", "games"), host):
            tot[k] += v
    g = tot["games"]
    return tot["sum_rew"] / g, tot["sum_disc"] / g, tot["sum_len"] / g


def policy_act_fn(actor, obs_rms=None, deterministic: bool = False):
    """The SHAC evaluation policy: tanh(actor(obs_rms.normalize(obs))),
    its mean when deterministic, else a sample from the actor's generator
    argument."""

    def act_fn(obs, generator):
        obs_n = obs_rms.normalize(obs) if obs_rms is not None else obs
        a = actor(obs_n, deterministic=deterministic,
                  generator=None if deterministic else generator)
        return torch.tanh(a)

    return act_fn


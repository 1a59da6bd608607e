"""SAC: soft actor-critic (port of diffrl_tpu/algorithms/sac.py).

Twin Q networks with Polyak targets, a squashed-Gaussian actor and a
learnable temperature alpha against the entropy target -|A|, over a replay
buffer on the device (``replay``; proportional-prioritized when the config
sets ``prioritized_replay``). The first ``num_seed_steps`` epochs act
uniformly at random; after that every env step, taken without gradients
(on CUDA the cached substeps run the hand-written forward kernel only), is
followed by one update on a sampled batch: the critic against
rew + gamma where(done, 0, min target Q - alpha logp'), weighted by the
importance weights, then the actor against the updated critic, then alpha,
then the Polyak target. The stored successor is the pre-reset observation,
nan_to_num-ed and clipped to +-1e6.

Random draws come from one ``torch.Generator`` on the trainer's device, or
per env step from the ``draws`` argument of ``train_epoch``: "actions"
(the seed phase's uniform actions in [-1, 1], else the actor's standard
normal noise), the batch's "idx" (uniform) or "u" (prioritized), and the
update's "eps_next" and "eps_pi".
"""

from __future__ import annotations

import copy
import math
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import default_device
from .. import envs as env_registry
from ..envs.base import clip
from ..models import DoubleCriticMLP, SACActor
from ..utils import AverageMeter, RunningMeanStd, TimeReport, print_info
from ..utils.tb import TBWriter
from . import replay
from .trainer import Trainer


class SAC(Trainer):
    def __init__(self, cfg: Dict[str, Any], env=None, device=None):
        params = cfg["params"]
        general = params.get("general", {})
        config = params["config"]
        if config.get("multi_gpu", False):
            raise NotImplementedError(
                "multi_gpu: the port trains on one card (ROADMAP A7)")
        self.seed = general.get("seed", 0)
        if env is not None:
            self.env = env
            self.device = env.device
        else:
            self.device = default_device(device)
            diff_env = params["diff_env"]
            self.env = env_registry.make(
                diff_env["name"],
                num_envs=config["num_actors"],
                seed=self.seed,
                episode_length=diff_env.get("episode_length", 1000),
                stochastic_init=diff_env.get("stochastic_env", True),
                MM_caching_frequency=diff_env.get("MM_caching_frequency", 1),
                device=self.device,
            )
        self.num_envs = self.env.num_envs
        self.num_obs = self.env.num_obs
        self.num_actions = self.env.num_acts

        self.gamma = config.get("gamma", 0.99)
        self.max_epochs = config.get("max_epochs", 5000)
        self.steps_per_epoch = config.get("num_steps_per_episode", 128)
        self.batch_size = config.get("batch_size", 4096)
        self.actor_lr = float(config.get("actor_lr", 5e-4))
        self.critic_lr = float(config.get("critic_lr", 5e-4))
        self.alpha_lr = float(config.get("alpha_lr", 5e-3))
        self.critic_tau = config.get("critic_tau", 0.005)
        self.init_alpha = config.get("init_alpha", 1.0)
        self.learnable_alpha = config.get("learnable_temperature", True)
        self.num_seed_steps = config.get("num_seed_steps", 5)
        self.normalize_input = config.get("normalize_input", True)
        self.rew_scale = config.get("reward_shaper", {}).get("scale_value",
                                                             1.0)
        self.name = config.get("name", "sac")
        self.target_entropy = -float(self.num_actions)
        cap = config.get("replay_buffer_size", 1_000_000)
        self.capacity = max(1, cap // self.num_envs) * self.num_envs
        self.prioritized = config.get("prioritized_replay", False)
        self.prio_alpha = config.get("priority_alpha", 0.6)
        self.prio_beta = config.get("priority_beta", 0.4)
        self.log_dir = general.get("logdir", "./logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.save_interval = config.get("save_frequency", 0)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        cfg_network = params.get("network", {})
        self.actor = SACActor(self.num_obs, self.num_actions, cfg_network,
                              device=self.device, generator=self.generator)
        self.critic = DoubleCriticMLP(self.num_obs, self.num_actions,
                                      cfg_network, device=self.device,
                                      generator=self.generator)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.full(
            (), math.log(self.init_alpha), dtype=torch.float32,
            device=self.device))
        self.actor_opt = torch.optim.Adam(self.actor.parameters(),
                                          lr=self.actor_lr)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(),
                                           lr=self.critic_lr)
        self.alpha_opt = torch.optim.Adam([self.log_alpha], lr=self.alpha_lr)

        self.obs_rms = (RunningMeanStd((self.num_obs,), device=self.device)
                        if self.normalize_input else None)
        self.env_state = self.env.reset()
        self.buffer = replay.make_buffer(self.capacity, self.num_obs,
                                         self.num_actions, self.prioritized,
                                         device=self.device)
        self.episode_trackers = dict(
            ep_rew=torch.zeros(self.num_envs, device=self.device),
            ep_len=torch.zeros(self.num_envs, dtype=torch.int32,
                               device=self.device))

        self.iter_count = 0
        self.step_count = 0
        self.episode_rew_meter = AverageMeter(1, 100)
        self.episode_length_meter = AverageMeter(1, 100)
        self.best_rew = -np.inf
        self.time_report = TimeReport()
        self.scalars: Dict[str, list] = {}
        self.writer = TBWriter(os.path.join(self.log_dir, "log"))

    # ------------------------------------------------------------ one epoch

    def _norm(self, o):
        return self.obs_rms.normalize(o) if self.obs_rms is not None else o

    @staticmethod
    def _step(optimizer, loss, params):
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def update_step(self, batch, weights, eps_next=None, eps_pi=None):
        """One update on ``batch`` = (obs, actions, rews, next_obs, dones)
        with importance ``weights``: the critic, the actor against the
        updated critic, alpha, the Polyak target. ``eps_next`` and
        ``eps_pi`` [B, A] are the actor's draws at next_obs and at obs
        (else the generator's). Returns ((critic loss, actor loss, alpha
        after the update), the TD errors for the priorities)."""
        obs, actions, rews, next_obs, dones = batch
        obs_n, next_obs_n = self._norm(obs), self._norm(next_obs)
        alpha = torch.exp(self.log_alpha.detach())
        g = self.generator
        with torch.no_grad():
            next_a, next_logp = self.actor.sample(next_obs_n, eps_next, g)
            tq1, tq2 = self.target_critic(next_obs_n, next_a)
            target_v = torch.minimum(tq1[..., 0], tq2[..., 0]) \
                - alpha * next_logp
            # where(), not (1 - done) v: 0 x NaN would still poison the
            # terminal transitions whose next_obs met the env's defenses
            target_q = rews + self.gamma * torch.where(
                dones > 0.0, torch.zeros_like(target_v), target_v)
        q1, q2 = self.critic(obs_n, actions)
        d1, d2 = q1[..., 0] - target_q, q2[..., 0] - target_q
        c_loss = (weights * d1 ** 2).mean() + (weights * d2 ** 2).mean()
        td_err = (0.5 * (d1.abs() + d2.abs())).detach()
        self._step(self.critic_opt, c_loss, list(self.critic.parameters()))

        a, logp = self.actor.sample(obs_n, eps_pi, g)
        q1, q2 = self.critic(obs_n, a)
        a_loss = (alpha * logp - torch.minimum(q1[..., 0], q2[..., 0])).mean()
        self._step(self.actor_opt, a_loss, list(self.actor.parameters()))

        if self.learnable_alpha:
            al_loss = (torch.exp(self.log_alpha)
                       * (-logp - self.target_entropy).detach()).mean()
            self._step(self.alpha_opt, al_loss, [self.log_alpha])

        with torch.no_grad():
            tau = self.critic_tau
            for t, p in zip(self.target_critic.parameters(),
                            self.critic.parameters()):
                t.copy_(t * (1.0 - tau) + p * tau)
        return (torch.stack([c_loss.detach(), a_loss.detach(),
                             torch.exp(self.log_alpha.detach())]), td_err)

    def train_epoch(self, seed_phase: bool = False,
                    draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None):
        """``steps_per_epoch`` env steps, each followed (outside the seed
        phase) by one update; ``draws[i]`` holds step i's random draws
        (module docstring). Returns the epoch's [H, ...] records as device
        tensors."""
        env, E = self.env, self.num_envs
        env_state, trk = self.env_state, self.episode_trackers
        keys = ("done", "ep_rew_done", "ep_len_done", "losses")
        outs = {k: [] for k in keys}
        for i in range(self.steps_per_epoch):
            d = draws[i] if draws is not None else {}
            with torch.no_grad():
                obs = env.batch_observations(env_state)
                if seed_phase:
                    actions = d.get("actions")
                    if actions is None:
                        actions = torch.rand(
                            (E, self.num_actions), generator=self.generator,
                            device=self.device) * 2.0 - 1.0
                else:
                    actions, _ = self.actor.sample(
                        self._norm(obs), d.get("actions"), self.generator)
                env_state, obs_next, rew_raw, done, info = env.step(
                    env_state, actions)
                if self.obs_rms is not None:
                    self.obs_rms.update(obs_next)
                next_obs = clip(torch.nan_to_num(
                    info["obs_before_reset"], nan=0.0, posinf=0.0,
                    neginf=0.0), -1e6, 1e6)
                replay.add(self.buffer, obs, actions, rew_raw * self.rew_scale,
                           next_obs, done.to(torch.float32))
            if seed_phase:
                losses = torch.stack([self.log_alpha.new_zeros(()),
                                      self.log_alpha.new_zeros(()),
                                      torch.exp(self.log_alpha.detach())])
            else:
                if self.prioritized:
                    idx, batch, weights = replay.sample_prioritized(
                        self.buffer, self.batch_size, self.prio_alpha,
                        self.prio_beta, self.generator, d.get("u"))
                else:
                    idx, batch, weights = replay.sample_uniform(
                        self.buffer, self.batch_size, self.generator,
                        d.get("idx"))
                losses, td_err = self.update_step(
                    batch, weights, d.get("eps_next"), d.get("eps_pi"))
                if self.prioritized:
                    replay.update_priorities(self.buffer, idx, td_err)
            ep_rew = trk["ep_rew"] + rew_raw
            ep_len = trk["ep_len"] + 1
            z = torch.zeros_like(ep_rew)
            outs["done"].append(done)
            outs["ep_rew_done"].append(torch.where(done, ep_rew, z))
            outs["ep_len_done"].append(torch.where(
                done, ep_len, torch.zeros_like(ep_len)))
            outs["losses"].append(losses)
            trk = dict(ep_rew=torch.where(done, z, ep_rew),
                       ep_len=torch.where(done, torch.zeros_like(ep_len),
                                          ep_len))
        self.env_state, self.episode_trackers = env_state, trk
        return {k: torch.stack(v) for k, v in outs.items()}

    # ---------------------------------------------------------------- train

    def train(self):
        self.start_time = time.time()
        self._best_snapshot = None
        self._last_best_write = 0.0
        self.time_report.add_timer("algorithm")
        self.time_report.start_timer("algorithm")
        self._t_last_epoch = time.time()
        for epoch in range(self.max_epochs):
            self._process_epoch_stats(self.train_epoch(
                seed_phase=epoch < self.num_seed_steps))
        self.time_report.end_timer("algorithm")
        self.time_report.report()
        if self._best_snapshot is not None:
            self.save("best_policy", snapshot=self._best_snapshot)
        self.save("final_policy")

    def _process_epoch_stats(self, outs):
        """Host-side half of one epoch: one transfer of the statistics,
        meters, best-policy snapshot, logging (the last step's losses)."""
        n = self.steps_per_epoch * self.num_envs
        host = torch.cat([
            outs["losses"][-1], outs["done"].to(torch.float32).reshape(-1),
            outs["ep_rew_done"].reshape(-1),
            outs["ep_len_done"].to(torch.float32).reshape(-1)]).cpu().numpy()
        c_loss, a_loss, alpha = (float(x) for x in host[:3])
        done, ep_rews, ep_lens = host[3:].reshape(3, n)
        self.iter_count += 1
        self.step_count += n
        sel = done.astype(bool)
        if sel.any():
            self.episode_rew_meter.update(ep_rews[sel])
            self.episode_length_meter.update(ep_lens[sel])
        mean_rew = self.episode_rew_meter.get_mean()
        mean_len = self.episode_length_meter.get_mean()
        now = time.time()
        fps = n / (now - self._t_last_epoch)
        self._t_last_epoch = now
        if mean_rew > self.best_rew and \
                self.episode_rew_meter.current_size > 0:
            self.best_rew = mean_rew
            self._best_snapshot = self._snapshot(copy_state=True)
            if now - self._last_best_write > 60.0:
                self.save(snapshot=self._best_snapshot)
                self._last_best_write = now
        self._log_scalars(rewards=mean_rew, episode_lengths=mean_len,
                          c_loss=c_loss, a_loss=a_loss, alpha=alpha, fps=fps)
        if self.iter_count % 10 == 0 or self.iter_count == 1:
            print(f"iter {self.iter_count}: rew {mean_rew:.2f}, ep len "
                  f"{mean_len:.1f}, fps {fps:.0f}, alpha {alpha:.3f}")
        if self.save_interval > 0 and self.iter_count % self.save_interval == 0:
            self.save(f"{self.name}_iter{self.iter_count}")

    # ----------------------------------------------------------- evaluation

    def evaluate_policy(self, num_games, deterministic=True):
        """Batched evaluation (batched_eval): (mean reward, mean length)."""
        from .eval_utils import batched_eval

        def act_fn(obs, gen):
            obs_n = self._norm(obs)
            if deterministic:
                return self.actor.mean_action(obs_n)
            return self.actor.sample(obs_n, generator=gen)[0]

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        with torch.no_grad():
            mean_rew, _, mean_len = batched_eval(self.env, act_fn, num_games,
                                                 generator=gen)
        return mean_rew, mean_len

    def run(self, num_games):
        mean_rew, mean_len = self.evaluate_policy(num_games)
        print_info(f"mean reward = {mean_rew}, mean episode length = "
                   f"{mean_len}")
        return mean_rew, mean_len


    # ---------------------------------------------------------- checkpoints

    def _snapshot(self, copy_state: bool = False):
        state = {
            "actor": self.actor.state_dict(),
            "critic": self.critic.state_dict(),
            "target_critic": self.target_critic.state_dict(),
            "log_alpha": self.log_alpha.detach(),
            "obs_rms": (self.obs_rms.state_dict()
                        if self.obs_rms is not None else None),
            "iter_count": self.iter_count,
            "step_count": self.step_count,
        }
        return copy.deepcopy(state) if copy_state else state


    def load(self, path):
        state = torch.load(path, map_location=self.device)
        self.actor.load_state_dict(state["actor"])
        self.critic.load_state_dict(state["critic"])
        self.target_critic.load_state_dict(state["target_critic"])
        with torch.no_grad():
            self.log_alpha.copy_(state["log_alpha"])
        if state.get("obs_rms") is not None:
            self.obs_rms.load_state_dict(state["obs_rms"])
        self.iter_count = state.get("iter_count", 0)
        self.step_count = state.get("step_count", 0)

"""PPO: proximal policy optimization (port of diffrl_tpu/algorithms/ppo.py).

One epoch: a rollout of ``steps_num`` env steps without gradients (on CUDA
the cached substeps run the hand-written forward kernel only), actions
mu + sigma eps clipped to [-1, 1] for the env alone; GAE(gamma, tau) as a
reverse loop with the last value as bootstrap; the value statistics
updated with the returns and values and returns normalized by them;
advantages normalized with the population std; then ``mini_epochs``
permutations cut into minibatches, each one step of the clipped surrogate,
the clipped value loss, the bound loss at 1.1 and the entropy bonus,
clipped by min(1, grad_norm / (norm + 1e-12)), through Adam (optax's
scale_by_adam times a learning rate) at the carried learning rate, which
the analytic Gaussian KL then adapts (divided by 1.5 above twice
kl_threshold, multiplied by 1.5 below half of it, clamped to [1e-6,
1e-2]). The learning rate stays on the device: no step reads it back.

A network tree that asks for a conv trunk, a recurrent layer or a
discrete or multi-discrete space builds the config-driven ``A2CNetwork``
(models/builders.py) and takes the head-generic path of the JAX trainer's
``_build_jitted_fns_builder``: the rollout carries the recurrent state,
zeroed where an env is done, and records the state before each step; the
losses are the same, with the bound loss on continuous heads only and the
KL of the head's distribution; with a recurrent layer the minibatches are
chunks of ``seq_length`` steps of one env (``seq_length`` must divide
``steps_num``), each started from its recorded state and run through the
chunk with the state zeroed after a done step. Without any of those the
network is the shared-trunk ``ActorCriticPPO``.

Random draws (action noise and samples, permutations) come from one
``torch.Generator`` on the trainer's device, or from the ``noise`` and
``perms`` arguments of ``train_epoch`` (``noise`` on the ActorCriticPPO
path only).

``multi_gpu`` (or ``shard_over_mesh``) makes the trainer one rank of a
data mesh (``parallel.mesh``) on both network paths: it keeps its rows of
the env batch (and of the recurrent state) and a replica of the network.
The ranks draw the global batch's noise and samples and the global
minibatch permutations (over rows, or over sequence chunks) and keep their
rows; each minibatch's means are taken over the global minibatch, the
gradients and loss terms summed in one flat all-reduce, so the KL that
adapts the learning rate is global; advantages are normalized by the
global mean and std, the observation and value statistics merged, and the
ended episodes gathered. Only rank 0 writes files.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import default_device, optim
from .. import envs as env_registry
from ..parallel import mesh as mesh_lib
from ..envs.base import clip
from ..models import A2CNetwork, ActorCriticPPO
from ..models.builders import mask_hidden
from ..utils import AverageMeter, RunningMeanStd, TimeReport, print_info
from ..utils.time_report import epoch_span, traced
from .shac import _global_norm
from .trainer import Trainer


def gae(rews, dones, values, last_value, gamma, tau):
    """Advantages [H, E] by GAE(gamma, tau) over [H, E] records, the reverse
    loop of the reference (a2c_common.py discount_values)."""
    advs = [None] * rews.shape[0]
    adv = torch.zeros_like(last_value)
    next_value = last_value
    for i in reversed(range(rews.shape[0])):
        nonterminal = 1.0 - dones[i]
        delta = rews[i] + gamma * next_value * nonterminal - values[i]
        adv = delta + gamma * tau * nonterminal * adv
        advs[i] = adv
        next_value = values[i]
    return torch.stack(advs)


def normalize_advantages(adv, mesh=None):
    """(adv - mean) / (std + 1e-8) with the population std (jnp.std's ddof
    0; torch.std's default is 1); under a ``mesh`` the global batch's mean
    and std (parallel.mesh.moments)."""
    mean, var = mesh_lib.moments(mesh, adv.reshape(-1))
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def tree_map(fn, *trees):
    """fn over the tensors of equally shaped nests of tuples, lists and
    dicts (a head's output, a recurrent state, a record of a step)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    if t is None:
        return None
    return fn(*trees)


def adapt_lr(lr, kl, threshold):
    """rl_games' AdaptiveScheduler on device tensors: lr / 1.5 (at least
    1e-6) when kl > 2 threshold, then lr * 1.5 (at most 1e-2) when kl <
    threshold / 2."""
    lr = torch.where(kl > 2.0 * threshold, torch.clamp(lr / 1.5, min=1e-6),
                     lr)
    return torch.where(kl < 0.5 * threshold, torch.clamp(lr * 1.5, max=1e-2),
                       lr)


class PPO(Trainer):
    def __init__(self, cfg: Dict[str, Any], env=None, device=None):
        params = cfg["params"]
        general = params.get("general", {})
        config = params["config"]
        net_cfg = params.get("network", {})
        space = net_cfg.get("space", {})
        self.use_builder = ("discrete" in space or "multi_discrete" in space
                            or "cnn" in net_cfg or "rnn" in net_cfg)
        multi_gpu = config.get("multi_gpu", False)
        self.seed = general.get("seed", 0)
        if env is not None:
            self.env = env
            self.device = env.device
        else:
            self.device = (mesh_lib.local_device(device) if multi_gpu
                           else default_device(device))
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
        self.tau = config.get("tau", 0.95)
        self.steps_num = config.get("steps_num", 32)
        self.max_epochs = config.get("max_epochs", 5000)
        self.lr = float(config.get("learning_rate", 3e-4))
        self.lr_schedule = config.get("lr_schedule", "adaptive")
        self.kl_threshold = float(config.get("kl_threshold", 0.008))
        self.e_clip = config.get("e_clip", 0.2)
        self.clip_value = config.get("clip_value", True)
        self.critic_coef = config.get("critic_coef", 4.0)
        self.entropy_coef = config.get("entropy_coef", 0.0)
        self.bounds_loss_coef = config.get("bounds_loss_coef", 0.0001)
        self.grad_norm = config.get("grad_norm", 1.0)
        self.truncate_grads = config.get("truncate_grads", True)
        self.normalize_input = config.get("normalize_input", True)
        self.normalize_value = config.get("normalize_value", True)
        self.normalize_advantage = config.get("normalize_advantage", True)
        self.rew_scale = config.get("reward_shaper", {}).get("scale_value",
                                                             1.0)
        batch = self.num_envs * self.steps_num
        self.minibatch_size = min(config.get("minibatch_size", batch), batch)
        self.mini_epochs = config.get("mini_epochs", 5)
        self.name = config.get("name", "ppo")
        if batch % self.minibatch_size != 0:
            raise ValueError("minibatch_size must divide steps_num*num_actors")
        self.num_minibatches = batch // self.minibatch_size
        self.log_dir = general.get("logdir", "./logs")
        self._make_log_dir()
        self.save_interval = config.get("save_frequency", 400)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        obs_shape = tuple(getattr(self.env, "obs_shape", (self.num_obs,)))
        if self.use_builder:
            self.network = A2CNetwork(
                obs_shape, self.num_actions, net_cfg,
                action_dims=getattr(self.env, "action_dims", None),
                device=self.device, generator=self.generator)
            self.seq_length = int(config.get("seq_length", 4))
            if self.network.rnn_name and self.steps_num % self.seq_length:
                raise ValueError("seq_length must divide steps_num")
        else:
            self.network = ActorCriticPPO(self.num_obs, self.num_actions,
                                          net_cfg, device=self.device,
                                          generator=self.generator)
        self.cur_lr = torch.full((), self.lr, device=self.device)
        self.opt = optim.adam(self.network.parameters(), self.cur_lr,
                              fused=True)

        self.obs_rms = (RunningMeanStd(obs_shape, device=self.device)
                        if self.normalize_input else None)
        self.val_rms = (RunningMeanStd((), device=self.device)
                        if self.normalize_value else None)
        self.env_state = self.env.reset()
        self.episode_trackers = dict(
            ep_rew=torch.zeros(self.num_envs, device=self.device),
            ep_len=torch.zeros(self.num_envs, dtype=torch.int32,
                               device=self.device))
        if self.use_builder and self.network.rnn_name:
            self.episode_trackers["rnn"] = self.network.initial_rnn_state(
                (self.num_envs,))

        # the reference's `multi_gpu` flag (Horovod there)
        self.mesh = None
        if multi_gpu:
            self.shard_over_mesh()

        self.iter_count = 0
        self.step_count = 0
        self.episode_rew_meter = AverageMeter(1, 100)
        self.episode_length_meter = AverageMeter(1, 100)
        self.best_rew = -np.inf
        self.time_report = TimeReport()
        self.scalars: Dict[str, list] = {}

    def shard_over_mesh(self, num_devices=None):
        """Make this trainer one rank of a data mesh over the default
        process group (a world of one without a group): the env (which must
        have ``shard(rank, size)``), its state and the trackers keep this
        rank's rows, the network and statistics take rank 0's values.
        ``num_envs`` stays the global count."""
        self.mesh = mesh_lib.make_data_mesh(num_devices, device=self.device)
        if self.num_envs % self.mesh.size:
            raise ValueError(f"num_envs={self.num_envs} not divisible by "
                             f"mesh size {self.mesh.size}")
        self.env.shard(self.mesh.rank, self.mesh.size)
        self.env_state = mesh_lib.shard_env_axis(self.mesh, self.env_state,
                                                 self.num_envs)
        self.episode_trackers = mesh_lib.shard_env_axis(
            self.mesh, self.episode_trackers, self.num_envs)
        mesh_lib.replicate(self.mesh, [
            m for m in (self.network, self.obs_rms, self.val_rms)
            if m is not None])

    # ------------------------------------------------------------ one epoch

    def _norm_val(self, v, un=False):
        return self.val_rms.normalize(v, un_norm=un) \
            if self.val_rms is not None else v

    @torch.no_grad()
    @traced("ppo.play_steps")
    def play_steps(self, noise: Optional[torch.Tensor] = None):
        """The rollout: ``steps_num`` env steps without gradients, the
        observations normalized by the statistics frozen at its start
        while the live ones update. ``noise`` [H, E, A] holds the action
        draws (else the generator's). Returns ([H, E, ...] records, the
        last value, unnormalized)."""
        if self.use_builder:
            return self._play_steps_builder()
        env, net = self.env, self.network
        rms = self.obs_rms.copy() if self.obs_rms is not None else None

        def norm(o):
            return rms.normalize(o) if rms is not None else o

        obs = env.batch_observations(self.env_state)
        env_state, trk = self.env_state, self.episode_trackers
        keys = ("obs", "actions", "logp", "mu", "sigma", "value", "rew",
                "done", "ep_rew_done", "ep_len_done")
        outs = {k: [] for k in keys}
        for i in range(self.steps_num):
            obs_n = norm(obs)
            mu, sigma, value = net(obs_n)
            eps = noise[i] if noise is not None else mesh_lib.draw(
                self.mesh, lambda s: torch.randn(
                    s, generator=self.generator, device=mu.device), mu.shape)
            actions = mu + sigma * eps
            logp = net.log_prob(mu, sigma, actions)
            env_state, obs, rew_raw, done, _ = env.step(
                env_state, clip(actions, -1.0, 1.0))
            if self.obs_rms is not None:
                self.obs_rms.update(obs, self.mesh)
            ep_rew = trk["ep_rew"] + rew_raw
            ep_len = trk["ep_len"] + 1
            z = torch.zeros_like(ep_rew)
            for k, v in zip(keys, (
                    obs_n, actions, logp, mu, sigma,
                    self._norm_val(value, un=True), rew_raw * self.rew_scale,
                    done.to(torch.float32), torch.where(done, ep_rew, z),
                    torch.where(done, ep_len, torch.zeros_like(ep_len)))):
                outs[k].append(v)
            trk = dict(ep_rew=torch.where(done, z, ep_rew),
                       ep_len=torch.where(done, torch.zeros_like(ep_len),
                                          ep_len))
        self.env_state, self.episode_trackers = env_state, trk
        last_value = self._norm_val(net(norm(obs))[2], un=True)
        return {k: torch.stack(v) for k, v in outs.items()}, last_value

    def minibatch_loss(self, obs, actions, old_logp, advantages, returns,
                       old_values, old_mu, old_sigma, own=None):
        """(loss, actor loss, critic loss, entropy, KL(old || new)); under a
        mesh ``own`` marks the rows this rank holds and each mean is its
        part of the global minibatch's (parallel.mesh.masked_mean)."""
        net = self.network
        mu, sigma, value = net(obs)
        a_loss, c_loss = self._ppo_losses(net.log_prob(mu, sigma, actions),
                                          old_logp, advantages, value,
                                          old_values, returns, own)
        zero = mu.new_zeros(())
        b_loss = mesh_lib.masked_mean(
            (torch.maximum(mu - 1.1, zero) ** 2
             + torch.maximum(-1.1 - mu, zero) ** 2).sum(-1), own)
        entropy = mesh_lib.masked_mean(net.entropy(sigma), own)
        loss = (a_loss + 0.5 * c_loss * self.critic_coef
                - self.entropy_coef * entropy
                + self.bounds_loss_coef * b_loss)
        kl = mesh_lib.masked_mean(torch.sum(
            torch.log(sigma / old_sigma)
            + (old_sigma ** 2 + (mu - old_mu) ** 2) / (2.0 * sigma ** 2)
            - 0.5, dim=-1), own)
        return loss, a_loss, c_loss, entropy, kl.detach()

    def _ppo_losses(self, logp, old_logp, adv, value, old_value, ret,
                    own=None):
        """The clipped surrogate's loss and the (clipped) value loss."""
        ratio = torch.exp(logp - old_logp)
        surr1 = adv * ratio
        surr2 = adv * clip(ratio, 1.0 - self.e_clip, 1.0 + self.e_clip)
        a_loss = -mesh_lib.masked_mean(torch.minimum(surr1, surr2), own)
        if self.clip_value:
            v_clipped = old_value + clip(value - old_value, -self.e_clip,
                                         self.e_clip)
            c_loss = mesh_lib.masked_mean(torch.maximum(
                (value - ret) ** 2, (v_clipped - ret) ** 2), own)
        else:
            c_loss = mesh_lib.masked_mean((value - ret) ** 2, own)
        return a_loss, c_loss

    @traced("ppo.returns")
    def _returns(self, outs, last_value):
        """GAE's advantages [H, E] and the values and returns, normalized
        by the value statistics after they take in the returns."""
        advs = gae(outs["rew"], outs["done"], outs["value"], last_value,
                   self.gamma, self.tau)
        returns = advs + outs["value"]
        values_n, returns_n = outs["value"], returns
        if self.val_rms is not None:
            self.val_rms.update(returns, self.mesh)
            values_n = self.val_rms.normalize(values_n)
            returns_n = self.val_rms.normalize(returns_n)
        return advs, values_n, returns_n

    @traced("ppo.update")
    def update(self, outs, last_value,
               perms: Optional[Sequence[torch.Tensor]] = None):
        """GAE, the statistics and the minibatch steps from the rollout's
        records; ``perms[e]`` is mini-epoch e's permutation of the batch
        (else the generator's). Returns [4, steps] (loss, actor loss,
        critic loss, kl) per minibatch step."""
        if self.use_builder:
            return self._update_builder(outs, last_value, perms)
        advs, values_n, returns_n = self._returns(outs, last_value)
        B = self.steps_num * self.num_envs           # the global batch
        Bl = self.steps_num * self.env.num_envs      # this rank's rows
        flat = [outs["obs"].reshape(Bl, -1),
                outs["actions"].reshape(Bl, -1), outs["logp"].reshape(Bl),
                advs.reshape(Bl), returns_n.reshape(Bl),
                values_n.reshape(Bl), outs["mu"].reshape(Bl, -1),
                outs["sigma"].reshape(Bl, -1)]
        if self.normalize_advantage:
            flat[3] = normalize_advantages(flat[3], self.mesh)
        params = list(self.network.parameters())
        stats = []
        for e in range(self.mini_epochs):
            perm = perms[e] if perms is not None else torch.randperm(
                B, generator=self.generator, device=self.device)
            for idx in perm.reshape(self.num_minibatches,
                                    self.minibatch_size):
                rows, own = mesh_lib.local_rows(self.mesh, idx,
                                                self.num_envs)
                stats.append(self._minibatch_step(
                    params, *self.minibatch_loss(*(x[rows] for x in flat),
                                                 own=own)))
        return torch.stack(stats, dim=1)

    @traced("optim.step")
    def _minibatch_step(self, params, loss, a_l, c_l, entropy, kl):
        """One clipped Adam step at the carried learning rate, which the KL
        then adapts; returns (loss, actor loss, critic loss, kl), summed
        over the mesh with the gradients."""
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        stats = mesh_lib.all_reduce_grads(self.mesh, params, torch.stack(
            [loss.detach(), a_l.detach(), c_l.detach(), kl]))
        grads = [p.grad for p in params]
        if self.truncate_grads:
            scale = torch.clamp(self.grad_norm / (
                _global_norm(grads) + 1e-12), max=1.0)
            for p, g in zip(params, grads):
                p.grad = g * scale
        self.opt.param_groups[0]["lr"] = self.cur_lr
        self.opt.step()
        if self.lr_schedule == "adaptive":
            self.cur_lr = adapt_lr(self.cur_lr, stats[3], self.kl_threshold)
        return stats

    # ---------------------------------------------- the A2CNetwork path

    @torch.no_grad()
    def _play_steps_builder(self):
        """The rollout of an A2CNetwork policy: its head's samples, the
        recurrent state carried (zeroed where an env is done) and recorded
        before each step. Returns ([H, E, ...] records, the last value)."""
        env, net = self.env, self.network
        rms = self.obs_rms.copy() if self.obs_rms is not None else None

        def norm(o):
            return rms.normalize(o) if rms is not None else o

        continuous = net.space == "continuous"
        obs = env.batch_observations(self.env_state)
        env_state, trk = self.env_state, self.episode_trackers
        records = []
        for _ in range(self.steps_num):
            rnn_state = trk.get("rnn")
            obs_n = norm(obs)
            head, value, new_rnn = net(obs_n, rnn_state)
            actions = net.sample(head, self.generator, self.mesh)
            logp = net.log_prob(head, actions)
            env_state, obs, rew_raw, done, _ = env.step(
                env_state, clip(actions, -1.0, 1.0) if continuous
                else actions)
            if self.obs_rms is not None:
                self.obs_rms.update(obs, self.mesh)
            ep_rew = trk["ep_rew"] + rew_raw
            ep_len = trk["ep_len"] + 1
            z = torch.zeros_like(ep_rew)
            rec = dict(obs=obs_n, actions=actions, logp=logp, head=head,
                       value=self._norm_val(value, un=True),
                       rew=rew_raw * self.rew_scale,
                       done=done.to(torch.float32),
                       ep_rew_done=torch.where(done, ep_rew, z),
                       ep_len_done=torch.where(done, ep_len,
                                               torch.zeros_like(ep_len)))
            new_trk = dict(ep_rew=torch.where(done, z, ep_rew),
                           ep_len=torch.where(done, torch.zeros_like(ep_len),
                                              ep_len))
            if rnn_state is not None:
                rec["rnn"] = rnn_state
                new_trk["rnn"] = mask_hidden(new_rnn, done)
            records.append(rec)
            trk = new_trk
        self.env_state, self.episode_trackers = env_state, trk
        last_value = net(norm(obs), trk.get("rnn"))[1]
        return (tree_map(lambda *xs: torch.stack(xs), *records),
                self._norm_val(last_value, un=True))

    def builder_loss(self, batch, own=None):
        """(loss, actor loss, critic loss, entropy, KL(old || new)) of one
        minibatch of the A2CNetwork path: rows of steps, or with a
        recurrent layer [mb, seq_length, ...] chunks run from their
        recorded state. ``own`` as in minibatch_loss."""
        net = self.network
        if not net.rnn_name:
            head, value, _ = net(batch["obs"])
        else:
            state, heads, values = batch["rnn"], [], []
            for t in range(batch["obs"].shape[1]):
                head_t, value_t, new = net(batch["obs"][:, t], state)
                state = mask_hidden(new, batch["done"][:, t].to(torch.bool))
                heads.append(head_t)
                values.append(value_t)
            head = tree_map(lambda *xs: torch.stack(xs, dim=1), *heads)
            value = torch.stack(values, dim=1)
        a_loss, c_loss = self._ppo_losses(
            net.log_prob(head, batch["actions"]), batch["logp"],
            batch["adv"], value, batch["value"], batch["ret"], own)
        entropy = mesh_lib.masked_mean(net.entropy(head), own)
        loss = (a_loss + 0.5 * c_loss * self.critic_coef
                - self.entropy_coef * entropy)
        if net.space == "continuous":
            mu, zero = head[0], head[0].new_zeros(())
            b_loss = mesh_lib.masked_mean(
                (torch.maximum(mu - 1.1, zero) ** 2
                 + torch.maximum(-1.1 - mu, zero) ** 2).sum(-1), own)
            loss = loss + self.bounds_loss_coef * b_loss
        kl = mesh_lib.masked_mean(net.kl(batch["head"], head, mean=False),
                                  own)
        return loss, a_loss, c_loss, entropy, kl.detach()

    def _update_builder(self, outs, last_value, perms=None):
        """GAE, the statistics and the minibatch steps of the A2CNetwork
        path: rows of single steps, or with a recurrent layer chunks of
        seq_length steps of one env (minibatches of minibatch_size //
        seq_length chunks) with the recorded state at each chunk's start.
        ``perms[e]`` permutes mini-epoch e's rows or chunks."""
        advs, values_n, returns_n = self._returns(outs, last_value)
        if self.normalize_advantage:
            advs = normalize_advantages(advs, self.mesh)
        H, E = self.steps_num, self.env.num_envs
        data = dict(obs=outs["obs"], actions=outs["actions"],
                    logp=outs["logp"], head=outs["head"], adv=advs,
                    ret=returns_n, value=values_n, done=outs["done"])
        if self.network.rnn_name:
            seq = self.seq_length

            def chunk(x):
                x = x.reshape((H // seq, seq, E) + x.shape[2:]).movedim(2, 1)
                return x.reshape((H // seq * E, seq) + x.shape[3:])
            data = tree_map(chunk, data)
            data["rnn"] = tree_map(
                lambda x: x.reshape((H // seq, seq, E) + x.shape[2:])[:, 0]
                .reshape((H // seq * E,) + x.shape[2:]), outs["rnn"])
            B, mb = H // seq * self.num_envs, max(1,
                                                  self.minibatch_size // seq)
        else:
            data = tree_map(lambda x: x.reshape((H * E,) + x.shape[2:]),
                            data)
            B, mb = H * self.num_envs, self.minibatch_size
        nmb = max(1, B // mb)
        params = list(self.network.parameters())
        stats = []
        for e in range(self.mini_epochs):
            perm = perms[e] if perms is not None else torch.randperm(
                B, generator=self.generator, device=self.device)
            for idx in perm[:nmb * mb].reshape(nmb, mb):
                rows, own = mesh_lib.local_rows(self.mesh, idx,
                                                self.num_envs)
                batch = tree_map(lambda x: x[rows], data)
                stats.append(self._minibatch_step(
                    params, *self.builder_loss(batch, own)))
        return torch.stack(stats, dim=1)

    @epoch_span("ppo.epoch")
    def train_epoch(self, noise: Optional[torch.Tensor] = None,
                    perms: Optional[Sequence[torch.Tensor]] = None):
        """One PPO epoch; returns its statistics as device tensors."""
        outs, last_value = self.play_steps(noise)
        stats = self.update(outs, last_value, perms)
        return dict(loss=stats[0].mean(), a_loss=stats[1].mean(),
                    c_loss=stats[2].mean(), kl=stats[3, -1],
                    cur_lr=self.cur_lr, done=outs["done"],
                    ep_rew_done=outs["ep_rew_done"],
                    ep_len_done=outs["ep_len_done"])

    # ---------------------------------------------------------------- train

    def train(self):
        self.start_time = time.time()
        self._best_snapshot = None
        self._last_best_write = 0.0
        self.time_report.add_timer("algorithm")
        self.time_report.start_timer("algorithm")
        self._t_last_epoch = time.time()
        for _ in range(self.max_epochs):
            self._process_epoch_stats(self.train_epoch())
        self.time_report.end_timer("algorithm")
        self.time_report.report()
        if self._best_snapshot is not None:
            self.save("best_policy", snapshot=self._best_snapshot)
        self.save("final_policy")

    @epoch_span("ppo.stats")
    def _process_epoch_stats(self, stats):
        """Host-side half of one epoch: one transfer of the statistics,
        meters, best-policy snapshot, logging."""
        n = self.steps_num * self.num_envs
        episodes = mesh_lib.gather_envs(self.mesh, torch.stack([
            stats["done"], stats["ep_rew_done"],
            stats["ep_len_done"].to(torch.float32)]))
        host = torch.cat([
            torch.stack([stats[k] for k in ("loss", "a_loss", "c_loss", "kl",
                                            "cur_lr")]),
            episodes.reshape(-1)]).cpu().numpy()
        loss, a_loss, c_loss, kl, cur_lr = (float(x) for x in host[:5])
        done, ep_rews, ep_lens = host[5:].reshape(3, n)
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
                          loss=loss, a_loss=a_loss, c_loss=c_loss, kl=kl,
                          lr=cur_lr, fps=fps)
        if self.iter_count % 10 == 0 or self.iter_count == 1:
            print(f"iter {self.iter_count}: rew {mean_rew:.2f}, ep len "
                  f"{mean_len:.1f}, fps {fps:.0f}, kl {kl:.4f}, lr "
                  f"{cur_lr:.2e}")
        if self.save_interval > 0 and self.iter_count % self.save_interval == 0:
            self.save(f"{self.name}_iter{self.iter_count}")

    # ----------------------------------------------------------- evaluation

    def evaluate_policy(self, num_games, deterministic=True):
        """Batched evaluation (batched_eval): (mean reward, mean length);
        for an A2CNetwork one episode per env (_evaluate_builder)."""
        from .eval_utils import batched_eval

        if self.use_builder:
            return self._evaluate_builder(deterministic)

        def act_fn(obs, gen):
            obs_n = self.obs_rms.normalize(obs) \
                if self.obs_rms is not None else obs
            mu, sigma, _ = self.network(obs_n)
            a = mu if deterministic else mu + sigma * torch.randn(
                mu.shape, generator=gen, device=mu.device)
            return clip(a, -1.0, 1.0)

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        mean_rew, _, mean_len = batched_eval(self.env, act_fn, num_games,
                                             generator=gen)
        return mean_rew, mean_len

    @torch.no_grad()
    def _evaluate_builder(self, deterministic=True):
        """The JAX trainer's _evaluate_builder: episode_length steps of
        every env from a reset, the recurrent state carried and zeroed on
        done, greedy (argmax) actions of a categorical head when
        deterministic; each env's reward until its first done. Returns
        (mean reward, mean length)."""
        env, net = self.env, self.network
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 2)
        env_state = env.reset()
        rnn = net.initial_rnn_state((env.num_envs,))
        ep_rew = torch.zeros(env.num_envs, device=self.device)
        ep_len = torch.zeros_like(ep_rew)
        done_seen = torch.zeros_like(ep_rew)
        for _ in range(env.episode_length):
            obs = env.batch_observations(env_state)
            obs_n = self.obs_rms.normalize(obs) \
                if self.obs_rms is not None else obs
            head, _, rnn = net(obs_n, rnn)
            if net.space == "continuous":
                mu, sigma = head
                a = mu if deterministic else mu + sigma * torch.randn(
                    mu.shape, generator=gen, device=mu.device)
                a = clip(a, -1.0, 1.0)
            elif not deterministic:
                a = net.sample(head, gen)
            elif net.space == "discrete":
                a = torch.argmax(head, dim=-1)
            else:
                a = torch.stack([torch.argmax(lg, dim=-1) for lg in head],
                                dim=-1)
            env_state, _, rew, done, _ = env.step(env_state, a)
            ep_rew = ep_rew + rew * (1.0 - done_seen)
            done_seen = torch.maximum(done_seen, done.to(torch.float32))
            ep_len = ep_len + (1.0 - done_seen)
            if rnn is not None:
                rnn = mask_hidden(rnn, done)
        return float(ep_rew.mean()), float(ep_len.mean())

    def run(self, num_games):
        mean_rew, mean_len = self.evaluate_policy(num_games)
        print_info(f"mean reward = {mean_rew}, mean episode length = "
                   f"{mean_len}")
        return mean_rew, mean_len


    # ---------------------------------------------------------- checkpoints

    def _snapshot(self, copy_state: bool = False):
        state = {
            "net": self.network.state_dict(),
            "obs_rms": (self.obs_rms.state_dict()
                        if self.obs_rms is not None else None),
            "val_rms": (self.val_rms.state_dict()
                        if self.val_rms is not None else None),
            "opt_state": self.opt.state_dict(),
            "cur_lr": self.cur_lr,
            "iter_count": self.iter_count,
            "step_count": self.step_count,
        }
        return copy.deepcopy(state) if copy_state else state


    def load(self, path):
        state = torch.load(path, map_location=self.device)
        self.network.load_state_dict(state["net"])
        for name in ("obs_rms", "val_rms"):
            if state.get(name) is not None:
                getattr(self, name).load_state_dict(state[name])
        self.opt.load_state_dict(state["opt_state"])
        self.cur_lr = torch.as_tensor(state["cur_lr"], dtype=torch.float32,
                                      device=self.device)
        self.iter_count = state.get("iter_count", 0)
        self.step_count = state.get("step_count", 0)

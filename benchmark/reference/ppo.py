"""PPO's first epochs for the benchmark's plain reference: the port's
``algorithms/ppo.py`` on its shared-trunk network (rollout without
gradients, GAE, the value statistics, the clipped surrogate and value
losses, the bound loss, the adaptive learning rate) without its logging,
computed in ``dtype`` on the plain simulator.

The trainer's generator initializes the network, then draws each step's
action noise and each mini-epoch's permutation, in the port's order and in
float32; the env's generator draws the start states.
"""

from __future__ import annotations

import torch

from .envs import clip, env_class
from .nets import ActorCriticPPO, RunningMeanStd


def gae(rews, dones, values, last_value, gamma, tau):
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


class PpoReference:
    """The PPO trainer of ``cfg`` (the port's config tree) in ``dtype``."""

    def __init__(self, cfg, device, dtype=torch.float64):
        params = cfg["params"]
        config, diff_env = params["config"], params["diff_env"]
        net_cfg = params.get("network", {})
        self.device, self.dtype = torch.device(device), dtype
        self.seed = params.get("general", {}).get("seed", 0)
        self.E, self.H = config["num_actors"], config.get("steps_num", 32)
        self.env = env_class(diff_env["name"])(
            self.E, self.seed, diff_env.get("episode_length", 1000),
            diff_env.get("stochastic_env", True),
            diff_env.get("MM_caching_frequency", 1), device, dtype)
        self.gamma = config.get("gamma", 0.99)
        self.tau = config.get("tau", 0.95)
        self.lr_schedule = config.get("lr_schedule", "adaptive")
        self.kl_threshold = float(config.get("kl_threshold", 0.008))
        self.e_clip = config.get("e_clip", 0.2)
        self.clip_value = config.get("clip_value", True)
        self.critic_coef = config.get("critic_coef", 4.0)
        self.entropy_coef = config.get("entropy_coef", 0.0)
        self.bounds_loss_coef = config.get("bounds_loss_coef", 0.0001)
        self.grad_norm = config.get("grad_norm", 1.0)
        self.truncate = config.get("truncate_grads", True)
        self.normalize_advantage = config.get("normalize_advantage", True)
        self.rew_scale = config.get("reward_shaper", {}).get("scale_value",
                                                             1.0)
        batch = self.E * self.H
        self.minibatch_size = min(config.get("minibatch_size", batch), batch)
        self.mini_epochs = config.get("mini_epochs", 5)
        self.num_minibatches = batch // self.minibatch_size

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.network = ActorCriticPPO(self.env.num_obs, self.env.num_acts,
                                      net_cfg, self.device,
                                      self.generator).to(dtype)
        self.cur_lr = float(config.get("learning_rate", 3e-4))
        self.opt = torch.optim.Adam(self.network.parameters(),
                                    lr=self.cur_lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.obs_rms = (RunningMeanStd((self.env.num_obs,), self.device,
                                       dtype)
                        if config.get("normalize_input", True) else None)
        self.val_rms = (RunningMeanStd((), self.device, dtype)
                        if config.get("normalize_value", True) else None)
        self.env_state = self.env.reset()
        self.first_grads = {}

    def _norm_val(self, v, un=False):
        return (self.val_rms.normalize(v, un_norm=un)
                if self.val_rms is not None else v)

    @torch.no_grad()
    def play_steps(self):
        env, net = self.env, self.network
        rms = self.obs_rms.copy() if self.obs_rms is not None else None

        def norm(o):
            return rms.normalize(o) if rms is not None else o

        obs = env.batch_observations(self.env_state)
        env_state = self.env_state
        keys = ("obs", "actions", "logp", "mu", "sigma", "value", "rew",
                "done")
        outs = {k: [] for k in keys}
        for _ in range(self.H):
            obs_n = norm(obs)
            mu, sigma, value = net(obs_n)
            eps = torch.randn(mu.shape, generator=self.generator,
                              device=self.device).to(self.dtype)
            actions = mu + sigma * eps
            logp = net.log_prob(mu, sigma, actions)
            env_state, obs, rew, done, _ = env.step(env_state,
                                                    clip(actions, -1.0, 1.0))
            if self.obs_rms is not None:
                self.obs_rms.update(obs)
            for k, v in zip(keys, (obs_n, actions, logp, mu, sigma,
                                   self._norm_val(value, un=True),
                                   rew * self.rew_scale,
                                   done.to(self.dtype))):
                outs[k].append(v)
        self.env_state = env_state
        last_value = self._norm_val(net(norm(obs))[2], un=True)
        return {k: torch.stack(v) for k, v in outs.items()}, last_value

    def minibatch_loss(self, obs, actions, old_logp, adv, ret, old_value,
                       old_mu, old_sigma):
        net = self.network
        mu, sigma, value = net(obs)
        ratio = torch.exp(net.log_prob(mu, sigma, actions) - old_logp)
        a_loss = -torch.mean(torch.minimum(
            adv * ratio, adv * clip(ratio, 1.0 - self.e_clip,
                                    1.0 + self.e_clip)))
        if self.clip_value:
            v_clipped = old_value + clip(value - old_value, -self.e_clip,
                                         self.e_clip)
            c_loss = torch.mean(torch.maximum((value - ret) ** 2,
                                              (v_clipped - ret) ** 2))
        else:
            c_loss = torch.mean((value - ret) ** 2)
        zero = mu.new_zeros(())
        b_loss = torch.mean((torch.maximum(mu - 1.1, zero) ** 2
                             + torch.maximum(-1.1 - mu, zero) ** 2).sum(-1))
        entropy = torch.mean(net.entropy(sigma))
        loss = (a_loss + 0.5 * c_loss * self.critic_coef
                - self.entropy_coef * entropy
                + self.bounds_loss_coef * b_loss)
        kl = torch.mean(torch.sum(
            torch.log(sigma / old_sigma)
            + (old_sigma ** 2 + (mu - old_mu) ** 2) / (2.0 * sigma ** 2)
            - 0.5, dim=-1))
        return loss, a_loss, c_loss, kl.detach()

    def _returns(self, outs, last_value):
        """GAE's advantages [H, E] and the values and returns, normalized
        by the value statistics after they take in the returns (the port's
        ``PPO._returns``)."""
        advs = gae(outs["rew"], outs["done"], outs["value"], last_value,
                   self.gamma, self.tau)
        returns = advs + outs["value"]
        values_n, returns_n = outs["value"], returns
        if self.val_rms is not None:
            self.val_rms.update(returns)
            values_n = self.val_rms.normalize(values_n)
            returns_n = self.val_rms.normalize(returns_n)
        return advs, values_n, returns_n

    def update(self, outs, last_value):
        advs, values_n, returns_n = self._returns(outs, last_value)
        B = self.E * self.H
        flat = [outs["obs"].reshape(B, -1), outs["actions"].reshape(B, -1),
                outs["logp"].reshape(B), advs.reshape(B),
                returns_n.reshape(B), values_n.reshape(B),
                outs["mu"].reshape(B, -1), outs["sigma"].reshape(B, -1)]
        if self.normalize_advantage:
            a = flat[3]
            flat[3] = (a - a.mean()) / (torch.sqrt(a.var(unbiased=False))
                                        + 1e-8)
        names = [n for n, _ in self.network.named_parameters()]
        params = list(self.network.parameters())
        stats = []
        for _ in range(self.mini_epochs):
            perm = torch.randperm(B, generator=self.generator,
                                  device=self.device)
            for idx in perm.reshape(self.num_minibatches,
                                    self.minibatch_size):
                loss, a_l, c_l, kl = self.minibatch_loss(
                    *(x[idx] for x in flat))
                grads = torch.autograd.grad(loss, params)
                if self.truncate:
                    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                    scale = torch.clamp(self.grad_norm / (norm + 1e-12),
                                        max=1.0)
                    grads = [g * scale for g in grads]
                self.first_grads.setdefault(
                    "network", {n: g.detach().clone()
                                for n, g in zip(names, grads)})
                for p, g in zip(params, grads):
                    p.grad = g
                self.opt.param_groups[0]["lr"] = self.cur_lr
                self.opt.step()
                kl = float(kl)
                if self.lr_schedule == "adaptive":
                    if kl > 2.0 * self.kl_threshold:
                        self.cur_lr = max(self.cur_lr / 1.5, 1e-6)
                    if kl < 0.5 * self.kl_threshold:
                        self.cur_lr = min(self.cur_lr * 1.5, 1e-2)
                stats.append((float(loss.detach()), float(a_l.detach()),
                              float(c_l.detach()), kl))
        return stats

    def epoch(self):
        """One epoch; returns its losses (means over the minibatch steps)
        as floats."""
        outs, last_value = self.play_steps()
        stats = torch.tensor(self.update(outs, last_value),
                             dtype=torch.float64)
        return {"loss": float(stats[:, 0].mean()),
                "a_loss": float(stats[:, 1].mean()),
                "c_loss": float(stats[:, 2].mean())}

    def modules(self):
        return {"network": self.network}

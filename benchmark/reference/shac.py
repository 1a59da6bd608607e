"""SHAC's first epochs for the benchmark's plain reference: the port's
``algorithms/shac.py`` (rollout, actor step, TD(lambda) critic update,
polyak) without its logging, computed in ``dtype`` on the plain simulator.

Every random draw is the port's: the trainer's generator (seeded with the
config's seed) first initializes the actor and the critic, then draws the
actor noise of each step and the critic's permutations, in the port's
order and in float32; the env's generator draws the start states.
"""

from __future__ import annotations

import copy

import torch

from .envs import env_class
from .nets import ActorStochasticMLP, CriticMLP, RunningMeanStd


def linear_schedule(init, end, horizon, count):
    if horizon <= 0:
        return init
    frac = 1.0 - min(max(count, 0), horizon) / horizon
    return (init - end) * frac + end


def clip_and_step(optimizer, params, lr, grad_norm, truncate):
    """nan_to_num, clip by min(1, grad_norm / (norm + 1e-12)), one Adam
    step at ``lr``. Returns the gradients as the optimizer took them."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        torch.nan_to_num(p.grad, nan=0.0, posinf=0.0, neginf=0.0,
                         out=p.grad)
    norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params))
    if truncate:
        scale = torch.clamp(grad_norm / (norm + 1e-12), max=1.0)
        for p in params:
            p.grad.mul_(scale)
    taken = [p.grad.detach().clone() for p in params]
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return taken


class ShacReference:
    """The SHAC trainer of ``cfg`` (the port's config tree) in ``dtype``."""

    def __init__(self, cfg, device, dtype=torch.float64):
        params = cfg["params"]
        config, diff_env = params["config"], params["diff_env"]
        net_cfg = params.get("network", {})
        if config.get("ret_rms", False):
            raise ValueError("the reference covers obs_rms, not ret_rms")
        self.device, self.dtype = torch.device(device), dtype
        self.seed = params.get("general", {}).get("seed", 0)
        self.env = env_class(diff_env["name"])(
            config["num_actors"], self.seed,
            diff_env.get("episode_length", 250),
            diff_env.get("stochastic_env", True),
            diff_env.get("MM_caching_frequency", 1), device, dtype)
        self.E, self.H = config["num_actors"], config["steps_num"]
        self.gamma = config.get("gamma", 0.99)
        self.lam = config.get("lambda", 0.95)
        self.critic_method = config.get("critic_method", "one-step")
        self.actor_lr = float(config["actor_learning_rate"])
        self.critic_lr = float(config["critic_learning_rate"])
        self.lr_schedule = config.get("lr_schedule", "linear")
        self.alpha = config.get("target_critic_alpha", 0.4)
        self.rew_scale = config.get("rew_scale", 1.0)
        self.critic_iterations = config.get("critic_iterations", 16)
        self.num_batch = config.get("num_batch", 4)
        self.batch_size = self.E * self.H // self.num_batch
        self.truncate = config.get("truncate_grads", True)
        self.grad_norm = config.get("grad_norm", 1.0)
        max_epochs = config["max_epochs"]
        self.actor_horizon = max_epochs
        self.critic_horizon = (max_epochs * self.critic_iterations
                               * self.num_batch)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        obs, acts = self.env.num_obs, self.env.num_acts
        self.actor = ActorStochasticMLP(obs, acts, net_cfg, self.device,
                                        self.generator).to(dtype)
        self.critic = CriticMLP(obs, net_cfg, self.device,
                                self.generator).to(dtype)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        betas = tuple(config.get("betas", (0.7, 0.95)))
        self.actor_opt = torch.optim.Adam(self.actor.parameters(),
                                          lr=self.actor_lr, betas=betas,
                                          eps=1e-8)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(),
                                           lr=self.critic_lr, betas=betas,
                                           eps=1e-8)
        self.actor_updates = self.critic_updates = 0
        self.obs_rms = (RunningMeanStd((obs,), self.device, dtype)
                        if config.get("obs_rms", False) else None)
        self.env_state = self.env.reset()
        self.first_grads = {}      # optimizer name -> {leaf: first gradient}

    def rollout(self):
        env, H, E, g = self.env, self.H, self.E, self.gamma
        env_state, obs = env.initialize_trajectory(self.env_state)
        rms = None
        if self.obs_rms is not None:
            rms = self.obs_rms.copy()
            self.obs_rms.update(obs)

        def norm(o):
            return rms.normalize(o) if rms is not None else o

        dev, dt = self.device, self.dtype
        rew_acc = torch.zeros(E, dtype=dt, device=dev)
        gamma = torch.ones(E, dtype=dt, device=dev)
        loss = torch.zeros((), dtype=dt, device=dev)
        outs = {k: [] for k in ("obs", "rew", "done", "next_value")}
        for i in range(H):
            obs_n = norm(obs)
            eps = torch.randn((E, env.num_acts), generator=self.generator,
                              device=dev).to(dt)
            actions = torch.tanh(self.actor(obs_n, eps))
            env_state, obs_next, rew, done, info = env.step(env_state,
                                                            actions)
            rew = rew * self.rew_scale
            if self.obs_rms is not None:
                self.obs_rms.update(obs_next)
            v_next = self.target_critic(norm(obs_next))[..., 0]
            obs_br = info["obs_before_reset"]
            bad = (torch.any(~torch.isfinite(obs_br), dim=-1)
                   | torch.any(torch.abs(obs_br) > 1e6, dim=-1))
            v_term = self.target_critic(torch.where(
                bad[:, None], torch.zeros_like(obs_br), norm(obs_br)))[..., 0]
            zero = torch.zeros_like(v_term)
            v_done = torch.where(bad, zero, torch.where(
                info["truncation"], v_term, zero))
            next_value = torch.where(done, v_done, v_next)
            rew_acc = rew_acc + gamma * rew
            settle = done if i < H - 1 else torch.ones_like(done)
            loss = loss + torch.where(
                settle, -rew_acc - g * gamma * next_value,
                torch.zeros_like(rew_acc)).sum()
            gamma = torch.where(done, torch.ones_like(gamma), gamma * g)
            rew_acc = torch.where(done, torch.zeros_like(rew_acc), rew_acc)
            for k, v in (("obs", obs_n), ("rew", rew), ("done", done),
                         ("next_value", next_value)):
                outs[k].append(v.detach())
            obs = obs_next
        self.env_state = env_state.detach()
        return loss / (H * E), {k: torch.stack(v) for k, v in outs.items()}

    def _step(self, name, optimizer, module, lr):
        names = [n for n, _ in module.named_parameters()]
        taken = clip_and_step(optimizer, list(module.parameters()), lr,
                              self.grad_norm, self.truncate)
        self.first_grads.setdefault(name, dict(zip(names, taken)))

    def actor_step(self, loss):
        self.actor_opt.zero_grad(set_to_none=True)
        loss.backward()
        lr = (linear_schedule(self.actor_lr, 1e-5, self.actor_horizon,
                              self.actor_updates)
              if self.lr_schedule == "linear" else self.actor_lr)
        self._step("actor", self.actor_opt, self.actor, lr)
        self.actor_updates += 1

    @torch.no_grad()
    def target_values(self, rew, done, next_value):
        if self.critic_method == "one-step":
            return rew + self.gamma * next_value
        lam_c, g = self.lam, self.gamma
        E = rew.shape[1]
        Ai = torch.zeros(E, dtype=rew.dtype, device=rew.device)
        Bi = torch.zeros_like(Ai)
        lam = torch.ones_like(Ai)
        targets = [None] * rew.shape[0]
        for i in reversed(range(rew.shape[0])):
            d, nv, r = done[i], next_value[i], rew[i]
            lam = lam * lam_c * (1.0 - d) + d
            Ai = (1.0 - d) * (lam_c * g * Ai + g * nv
                              + (1.0 - lam) / (1.0 - lam_c) * r)
            Bi = g * (nv * d + Bi * (1.0 - d)) + r
            targets[i] = (1.0 - lam_c) * Ai + lam * Bi
        return torch.stack(targets)

    def critic_step(self, outs):
        done = outs["done"].to(self.dtype)
        done[-1] = 1.0
        targets = self.target_values(outs["rew"], done, outs["next_value"])
        obs_flat = outs["obs"].reshape(-1, self.env.num_obs)
        target_flat = targets.reshape(-1)
        n, bs = obs_flat.shape[0], self.batch_size
        nb = (n - 1) // bs + 1
        data = torch.cat([obs_flat, target_flat[:, None]], dim=1)
        weights = [(b * bs + torch.arange(bs, device=data.device) < n).to(
            data.dtype) for b in range(nb)]
        value_loss = None
        for _ in range(self.critic_iterations):
            perm = torch.randperm(n, generator=self.generator,
                                  device=data.device)
            if nb * bs > n:
                perm = torch.cat([perm, perm[-1:].expand(nb * bs - n)])
            total = torch.zeros((), dtype=self.dtype, device=data.device)
            for b in range(nb):
                d = data[perm[b * bs:(b + 1) * bs]]
                v = self.critic(d[:, :-1])[..., 0]
                loss = torch.sum((v - d[:, -1]) ** 2 * weights[b]) / \
                    torch.clamp(torch.sum(weights[b]), min=1.0)
                self.critic_opt.zero_grad(set_to_none=True)
                loss.backward()
                lr = (linear_schedule(self.critic_lr, 1e-5,
                                      self.critic_horizon,
                                      self.critic_updates)
                      if self.lr_schedule == "linear" else self.critic_lr)
                self._step("critic", self.critic_opt, self.critic, lr)
                self.critic_updates += 1
                total = total + loss.detach()
            value_loss = total / nb
        with torch.no_grad():
            for t, p in zip(self.target_critic.parameters(),
                            self.critic.parameters()):
                t.copy_(t * self.alpha + p * (1.0 - self.alpha))
        return value_loss

    def epoch(self):
        """One epoch; returns its losses as floats."""
        loss, outs = self.rollout()
        self.actor_step(loss)
        value_loss = self.critic_step(outs)
        return {"actor_loss": float(loss.detach()),
                "value_loss": float(value_loss)}

    def modules(self):
        return {"actor": self.actor, "critic": self.critic}

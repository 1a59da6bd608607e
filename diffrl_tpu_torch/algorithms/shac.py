"""SHAC: Short-Horizon Actor-Critic with differentiable simulation (port of
diffrl_tpu/algorithms/shac.py).

One epoch: the actor's ``steps_num``-step window is rolled out with
gradients through the simulator (the replay reverse pass of
``simulate_batched_lb``, whose cached substeps run the hand-written forward
and adjoint kernels on CUDA); the window loss bootstraps with the target
critic; the actor takes one clipped Adam step; TD(lambda) targets feed
``critic_iterations`` x ``num_batch`` critic minibatch steps; the target
critic follows by polyak averaging. The semantics are the JAX trainer's,
step by step: the window is normalized with the observation statistics
frozen at its start while a live copy updates, gradients are
nan_to_num-ed and clipped by ``min(1, grad_norm / (norm + 1e-12))``, and the
linear learning-rate decay is optax's ``linear_schedule`` evaluated at the
optimizer's step count before each update.

Random draws (actor noise, critic permutations) come from one
``torch.Generator`` on the trainer's device; env resets from the env's own.
The host reads the epoch's statistics once, in one transfer.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import default_device
from .. import envs as env_registry
from ..models import ActorDeterministicMLP, ActorStochasticMLP, CriticMLP
from ..utils import AverageMeter, RunningMeanStd, TimeReport, print_info
from ..utils.tb import TBWriter
from .trainer import Trainer


def linear_schedule(init: float, end: float, horizon: int, count: int):
    """optax.linear_schedule(init, end, horizon) at step ``count``."""
    if horizon <= 0:
        return init
    frac = 1.0 - min(max(count, 0), horizon) / horizon
    return (init - end) * frac + end


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_and_step(optimizer, params: Sequence[torch.Tensor], lr: float,
                  grad_norm: float, truncate: bool = True):
    """nan_to_num the gradients in ``params``' .grad, scale them by
    min(1, grad_norm / (norm + 1e-12)) when ``truncate`` (the JAX
    trainers' clip, not clip_grad_norm_'s 1e-6) and take one step of
    ``optimizer`` at ``lr``. A parameter the loss did not reach gets a zero
    gradient, as under jax.grad, so Adam still advances its moments.
    Returns the norms before and after."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        torch.nan_to_num(p.grad, nan=0.0, posinf=0.0, neginf=0.0,
                         out=p.grad)
        grads.append(p.grad)
    gnorm_before = _global_norm(grads)
    if truncate:
        scale = torch.clamp(grad_norm / (gnorm_before + 1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)
    gnorm_after = _global_norm(grads)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return gnorm_before, gnorm_after


class SHAC(Trainer):
    def __init__(self, cfg: Dict[str, Any], device=None):
        params = cfg["params"]
        general = params.get("general", {})
        config = params["config"]
        diff_env = params["diff_env"]
        self.device = default_device(device)
        if config.get("multi_gpu", False):
            raise NotImplementedError(
                "multi_gpu: the port trains on one card (ROADMAP A7)")

        self.seed = general.get("seed", 0)
        self.env = env_registry.make(
            diff_env["name"],
            num_envs=config["num_actors"],
            seed=self.seed,
            episode_length=diff_env.get("episode_length", 250),
            stochastic_init=diff_env.get("stochastic_env", True),
            MM_caching_frequency=diff_env.get("MM_caching_frequency", 1),
            sim_backward=diff_env.get("sim_backward"),
            device=self.device,
        )
        self.num_envs = self.env.num_envs
        self.num_obs = self.env.num_obs
        self.num_actions = self.env.num_acts
        self.max_episode_length = self.env.episode_length

        self.gamma = config.get("gamma", 0.99)
        self.critic_method = config.get("critic_method", "one-step")
        self.lam = config.get("lambda", 0.95)
        self.steps_num = config["steps_num"]
        self.max_epochs = config["max_epochs"]
        self.actor_lr = float(config["actor_learning_rate"])
        self.critic_lr = float(config["critic_learning_rate"])
        self.lr_schedule = config.get("lr_schedule", "linear")
        self.target_critic_alpha = config.get("target_critic_alpha", 0.4)
        self.use_obs_rms = config.get("obs_rms", False)
        self.use_ret_rms = config.get("ret_rms", False)
        self.rew_scale = config.get("rew_scale", 1.0)
        self.critic_iterations = config.get("critic_iterations", 16)
        self.num_batch = config.get("num_batch", 4)
        self.batch_size = self.num_envs * self.steps_num // self.num_batch
        self.name = config.get("name", "shac")
        self.truncate_grad = config.get("truncate_grads", True)
        self.grad_norm = config.get("grad_norm", 1.0)
        self.log_dir = general.get("logdir", "./logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.save_interval = config.get("save_interval", 500)

        # networks, initialized from the seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        cfg_network = params.get("network", {})
        actor_name = cfg_network.get("actor", "ActorStochasticMLP")
        actor_cls = {"ActorStochasticMLP": ActorStochasticMLP,
                     "ActorDeterministicMLP": ActorDeterministicMLP}[actor_name]
        self.actor = actor_cls(self.num_obs, self.num_actions, cfg_network,
                               device=self.device, generator=self.generator)
        self.critic = CriticMLP(self.num_obs, cfg_network, device=self.device,
                                generator=self.generator)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self.stochastic_actor = actor_name == "ActorStochasticMLP"

        # Adam with the reference's betas; the linear decay to 1e-5 runs
        # over max_epochs actor steps and, for the critic, over its
        # max_epochs x critic_iterations x num_batch steps
        self.betas = tuple(config.get("betas", (0.7, 0.95)))
        self.actor_opt = torch.optim.Adam(
            self.actor.parameters(), lr=self.actor_lr, betas=self.betas,
            eps=1e-8)
        self.critic_opt = torch.optim.Adam(
            self.critic.parameters(), lr=self.critic_lr, betas=self.betas,
            eps=1e-8)
        self.actor_horizon = self.max_epochs
        self.critic_horizon = (self.max_epochs * self.critic_iterations
                               * self.num_batch)
        self.actor_updates = 0      # optimizer steps taken (schedule count)
        self.critic_updates = 0

        self.obs_rms = (RunningMeanStd((self.num_obs,), device=self.device)
                        if self.use_obs_rms else None)
        self.ret_rms = (RunningMeanStd((), device=self.device)
                        if self.use_ret_rms else None)

        # env + episode-tracking state
        self.env_state = self.env.reset()
        E, dev = self.num_envs, self.device
        self.episode_trackers = dict(
            ep_loss=torch.zeros(E, device=dev),
            ep_disc_loss=torch.zeros(E, device=dev),
            ep_gamma=torch.ones(E, device=dev),
            ep_len=torch.zeros(E, dtype=torch.int32, device=dev),
            ret=torch.zeros(E, device=dev),
        )

        # logging / meters
        self.iter_count = 0
        self.step_count = 0
        self.episode_loss_meter = AverageMeter(1, 100)
        self.episode_discounted_loss_meter = AverageMeter(1, 100)
        self.episode_length_meter = AverageMeter(1, 100)
        self.episode_loss_his: list = []
        self.episode_discounted_loss_his: list = []
        self.episode_length_his: list = []
        self.best_policy_loss = np.inf
        self.actor_loss = np.inf
        self.value_loss = np.inf
        self.time_report = TimeReport()
        self.scalars: Dict[str, list] = {}
        self.writer = TBWriter(os.path.join(self.log_dir, "log"))

    # ------------------------------------------------------------ one epoch

    def rollout(self, deterministic: bool = False):
        """The actor's window from the current env state, with gradients
        through the simulator. Returns (loss, outs) with outs the per-step
        [H, E] records the critic and the meters use; advances env_state,
        the trackers and the live obs/return statistics."""
        env, H, E = self.env, self.steps_num, self.num_envs
        gamma_c = self.gamma
        env_state, obs = env.initialize_trajectory(self.env_state)

        rms = None
        if self.obs_rms is not None:
            rms = self.obs_rms.copy()           # frozen for the whole window
            self.obs_rms.update(obs)
        ret_var = self.ret_rms.var.clone() if self.ret_rms is not None \
            else None

        def norm(o):
            return rms.normalize(o) if rms is not None else o

        trk = self.episode_trackers
        rew_acc = torch.zeros(E, device=self.device)
        gamma = torch.ones(E, device=self.device)
        loss = torch.zeros((), device=self.device)
        outs = {k: [] for k in ("obs", "rew", "done", "next_value",
                                "ep_loss_done", "ep_disc_done",
                                "ep_len_done")}
        for i in range(H):
            obs_n = norm(obs)
            if self.stochastic_actor:
                actions = self.actor(
                    obs_n, deterministic=deterministic,
                    generator=None if deterministic else self.generator)
            else:
                actions = self.actor(obs_n)
            actions = torch.tanh(actions)

            env_state, obs_next, rew_raw, done, info = env.step(env_state,
                                                                actions)
            rew = rew_raw * self.rew_scale
            if self.obs_rms is not None:
                self.obs_rms.update(obs_next)
            if self.ret_rms is not None:
                new_ret = trk["ret"] * gamma_c + rew.detach()
                trk = dict(trk, ret=new_ret)
                self.ret_rms.update(new_ret)
                rew = rew / torch.sqrt(ret_var + 1e-6)

            # bootstrap values (branchless, as the JAX trainer)
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
                settle, -rew_acc - gamma_c * gamma * next_value,
                torch.zeros_like(rew_acc)).sum()
            gamma = torch.where(done, torch.ones_like(gamma), gamma * gamma_c)
            rew_acc = torch.where(done, torch.zeros_like(rew_acc), rew_acc)

            # episode stats
            with torch.no_grad():
                raw = rew_raw.detach()
                ep_loss = trk["ep_loss"] - raw
                ep_disc = trk["ep_disc_loss"] - trk["ep_gamma"] * raw
                ep_gamma = trk["ep_gamma"] * gamma_c
                ep_len = trk["ep_len"] + 1
                z = torch.zeros_like(ep_loss)
                for k, v in (("obs", obs_n), ("rew", rew), ("done", done),
                             ("next_value", next_value),
                             ("ep_loss_done", torch.where(done, ep_loss, z)),
                             ("ep_disc_done", torch.where(done, ep_disc, z)),
                             ("ep_len_done", torch.where(
                                 done, ep_len, torch.zeros_like(ep_len)))):
                    outs[k].append(v.detach())
                trk = dict(
                    trk,
                    ep_loss=torch.where(done, z, ep_loss),
                    ep_disc_loss=torch.where(done, z, ep_disc),
                    ep_gamma=torch.where(done, torch.ones_like(ep_gamma),
                                         ep_gamma),
                    ep_len=torch.where(done, torch.zeros_like(ep_len),
                                       ep_len),
                )
            obs = obs_next

        loss = loss / (H * E)
        if self.ret_rms is not None:
            loss = loss * torch.sqrt(ret_var + 1e-6)
        self.env_state = env_state.detach()
        self.episode_trackers = trk
        return loss, {k: torch.stack(v) for k, v in outs.items()}

    def _clip_and_step(self, optimizer, params: Sequence[torch.Tensor],
                       lr: float):
        return clip_and_step(optimizer, params, lr, self.grad_norm,
                             self.truncate_grad)

    def actor_step(self, loss):
        """Backward through the window, then one clipped Adam step."""
        self.actor_opt.zero_grad(set_to_none=True)
        loss.backward()
        return self.apply_actor_grads()

    def apply_actor_grads(self):
        """One clipped Adam step of the actor from the gradients in its
        parameters' .grad, at the scheduled learning rate."""
        lr = (linear_schedule(self.actor_lr, 1e-5, self.actor_horizon,
                              self.actor_updates)
              if self.lr_schedule == "linear" else self.actor_lr)
        norms = self._clip_and_step(self.actor_opt,
                                    list(self.actor.parameters()), lr)
        self.actor_updates += 1
        return norms

    @torch.no_grad()
    def target_values(self, rew, done, next_value):
        """Critic targets from [H, E] records; done must hold 1 on the last
        step. TD(lambda) is the JAX trainer's backward recursion."""
        if self.critic_method == "one-step":
            return rew + self.gamma * next_value
        lam_c, g = self.lam, self.gamma
        E = rew.shape[1]
        Ai = torch.zeros(E, device=rew.device)
        Bi = torch.zeros(E, device=rew.device)
        lam = torch.ones(E, device=rew.device)
        targets = [None] * rew.shape[0]
        for i in reversed(range(rew.shape[0])):
            d, nv, r = done[i], next_value[i], rew[i]
            lam = lam * lam_c * (1.0 - d) + d
            Ai = (1.0 - d) * (lam_c * g * Ai + g * nv
                              + (1.0 - lam) / (1.0 - lam_c) * r)
            Bi = g * (nv * d + Bi * (1.0 - d)) + r
            targets[i] = (1.0 - lam_c) * Ai + lam * Bi
        return torch.stack(targets)

    def critic_update(self, obs_flat, target_flat,
                      perms: Optional[Sequence[torch.Tensor]] = None):
        """critic_iterations x num_batch minibatch MSE steps. Each
        iteration shuffles the whole dataset once (``perms[i]`` when given,
        else a permutation from the trainer's generator) and cuts it into
        contiguous minibatches; a short last batch is padded with copies of
        the final row at weight 0. Returns the last iteration's mean loss."""
        n = obs_flat.shape[0]
        bs = self.batch_size
        nb = (n - 1) // bs + 1
        data = torch.cat([obs_flat, target_flat[:, None]], dim=1)
        params = list(self.critic.parameters())
        weights = [(b * bs + torch.arange(bs, device=data.device) < n).to(
            data.dtype) for b in range(nb)]
        value_loss = None
        for it in range(self.critic_iterations):
            perm = perms[it] if perms is not None else torch.randperm(
                n, generator=self.generator, device=data.device)
            shuffled = data[perm]
            if nb * bs > n:
                shuffled = torch.cat(
                    [shuffled, shuffled[-1:].expand(nb * bs - n, -1)])
            total = torch.zeros((), device=data.device)
            for b in range(nb):
                d = shuffled[b * bs:(b + 1) * bs]
                w = weights[b]
                v = self.critic(d[:, :-1])[..., 0]
                loss = torch.sum((v - d[:, -1]) ** 2 * w) / torch.clamp(
                    torch.sum(w), min=1.0)
                self.critic_opt.zero_grad(set_to_none=True)
                loss.backward()
                lr = (linear_schedule(self.critic_lr, 1e-5,
                                      self.critic_horizon,
                                      self.critic_updates)
                      if self.lr_schedule == "linear" else self.critic_lr)
                self._clip_and_step(self.critic_opt, params, lr)
                self.critic_updates += 1
                total = total + loss.detach()
            value_loss = total / nb
        return value_loss

    @torch.no_grad()
    def polyak(self):
        a = self.target_critic_alpha
        for t, p in zip(self.target_critic.parameters(),
                        self.critic.parameters()):
            t.copy_(t * a + p * (1.0 - a))

    def critic_step(self, outs):
        """The epoch's critic half from the window's records ``outs``:
        TD(lambda) targets with the last step settled, the minibatch
        updates, then polyak. Returns the value loss."""
        done = outs["done"].to(torch.float32)
        done[-1] = 1.0
        targets = self.target_values(outs["rew"], done, outs["next_value"])
        value_loss = self.critic_update(outs["obs"].reshape(-1, self.num_obs),
                                        targets.reshape(-1))
        self.polyak()
        return value_loss

    def train_epoch(self):
        """One SHAC epoch; returns the epoch's statistics as device
        tensors."""
        actor_loss, outs = self.rollout()
        gnorm_before, gnorm_after = self.actor_step(actor_loss)
        value_loss = self.critic_step(outs)
        return dict(actor_loss=actor_loss.detach(), value_loss=value_loss,
                    gnorm_before=gnorm_before, gnorm_after=gnorm_after,
                    done=outs["done"], ep_loss_done=outs["ep_loss_done"],
                    ep_disc_done=outs["ep_disc_done"],
                    ep_len_done=outs["ep_len_done"])

    # ---------------------------------------------------------------- train

    def train(self):
        self.start_time = time.time()
        self._best_snapshot = None
        self._last_best_write = 0.0
        tr = self.time_report
        for t in ("algorithm", "actor training"):
            tr.add_timer(t)
        tr.start_timer("algorithm")
        self._t_last_epoch = time.time()
        for _ in range(self.max_epochs):
            self._process_epoch_stats(self.train_epoch())
        tr.end_timer("algorithm")
        tr.report()
        if self._best_snapshot is not None:
            self.save("best_policy", snapshot=self._best_snapshot)
        self.save("final_policy")
        for name, his in (("episode_loss_his", self.episode_loss_his),
                          ("episode_discounted_loss_his",
                           self.episode_discounted_loss_his),
                          ("episode_length_his", self.episode_length_his)):
            np.save(os.path.join(self.log_dir, f"{name}.npy"), np.array(his))

    def _process_epoch_stats(self, stats):
        """Host-side half of one epoch: one transfer of the statistics,
        episode meters, best-policy snapshot, logging."""
        H, E = self.steps_num, self.num_envs
        host = torch.cat([
            torch.stack([stats["actor_loss"], stats["value_loss"],
                         stats["gnorm_before"], stats["gnorm_after"]]),
            stats["done"].to(torch.float32).reshape(-1),
            stats["ep_loss_done"].reshape(-1),
            stats["ep_disc_done"].reshape(-1),
            stats["ep_len_done"].to(torch.float32).reshape(-1),
        ]).cpu().numpy()
        self.actor_loss, self.value_loss, gnorm_before, gnorm_after = (
            float(x) for x in host[:4])
        done, ep_losses, ep_disc, ep_lens = host[4:].reshape(4, H * E)
        self.step_count += H * E
        self.iter_count += 1

        sel = done.astype(bool)
        if sel.any():
            self.episode_loss_meter.update(ep_losses[sel])
            self.episode_discounted_loss_meter.update(ep_disc[sel])
            self.episode_length_meter.update(ep_lens[sel])
            self.episode_loss_his.extend(ep_losses[sel].tolist())
            self.episode_discounted_loss_his.extend(ep_disc[sel].tolist())
            self.episode_length_his.extend(ep_lens[sel].tolist())

        now = time.time()
        epoch_time = now - self._t_last_epoch
        self._t_last_epoch = now
        self.time_report.add_time("actor training", epoch_time)
        fps = H * E / epoch_time
        if len(self.episode_loss_his) > 0:
            mean_policy_loss = self.episode_loss_meter.get_mean()
            mean_policy_discounted_loss = \
                self.episode_discounted_loss_meter.get_mean()
            mean_episode_length = self.episode_length_meter.get_mean()
            if mean_policy_loss < self.best_policy_loss:
                self._best_snapshot = self._snapshot(copy_state=True)
                self.best_policy_loss = mean_policy_loss
                if now - self._last_best_write > 60.0:
                    print_info(f"save best policy with loss "
                               f"{mean_policy_loss:.2f}")
                    self.save(snapshot=self._best_snapshot)
                    self._last_best_write = now
        else:
            mean_policy_loss = np.inf
            mean_policy_discounted_loss = np.inf
            mean_episode_length = 0

        self._log_scalars(
            time_elapse=time.time() - self.start_time,
            actor_loss=self.actor_loss,
            value_loss=self.value_loss,
            policy_loss=mean_policy_loss,
            rewards=-mean_policy_loss if np.isfinite(mean_policy_loss)
            else np.nan,
            episode_lengths=mean_episode_length,
            fps=fps,
        )
        print(
            f"iter {self.iter_count}: ep loss {mean_policy_loss:.2f}, "
            f"ep discounted loss {mean_policy_discounted_loss:.2f}, "
            f"ep len {mean_episode_length:.1f}, fps total {fps:.2f}, "
            f"value loss {self.value_loss:.5f}, "
            f"grad norm before/after clip {gnorm_before:.2f}/"
            f"{gnorm_after:.2f}")
        if self.save_interval > 0 and self.iter_count % self.save_interval == 0:
            self.save(f"{self.name}policy_iter{self.iter_count}_reward"
                      f"{-mean_policy_loss:.3f}")

    # ----------------------------------------------------------- evaluation

    def evaluate_policy(self, num_games, deterministic=False):
        """Batched evaluation on the training env (batched_eval); episode
        statistics stay on the device, one host read per chunk."""
        from .eval_utils import batched_eval, policy_act_fn

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        mean_rew, mean_disc, mean_len = batched_eval(
            self.env, policy_act_fn(self.actor, self.obs_rms, deterministic),
            num_games, gamma=self.gamma, generator=gen)
        return -mean_rew, -mean_disc, mean_len

    def run(self, num_games):
        """Evaluates the current policy over ``num_games`` episodes and
        prints the means; returns (mean episode loss, mean length)."""
        mean_loss, mean_disc, mean_len = self.evaluate_policy(num_games)
        print_info(f"mean episode loss = {mean_loss}, mean discounted loss = "
                   f"{mean_disc}, mean episode length = {mean_len}")
        return mean_loss, mean_len


    # ---------------------------------------------------------- checkpoints

    def _snapshot(self, copy_state: bool = False):
        """The whole training state: networks, optimizer states, statistics
        and counters. With ``copy_state`` the tensors are copies, so later
        training leaves the snapshot as it is."""
        state = {
            "actor": self.actor.state_dict(),
            "critic": self.critic.state_dict(),
            "target_critic": self.target_critic.state_dict(),
            "obs_rms": (self.obs_rms.state_dict()
                        if self.obs_rms is not None else None),
            "ret_rms": (self.ret_rms.state_dict()
                        if self.ret_rms is not None else None),
            "actor_opt_state": self.actor_opt.state_dict(),
            "critic_opt_state": self.critic_opt.state_dict(),
            "actor_updates": self.actor_updates,
            "critic_updates": self.critic_updates,
            "iter_count": self.iter_count,
            "step_count": self.step_count,
        }
        return copy.deepcopy(state) if copy_state else state


    def load(self, path):
        state = torch.load(path, map_location=self.device)
        self.actor.load_state_dict(state["actor"])
        self.critic.load_state_dict(state["critic"])
        self.target_critic.load_state_dict(state["target_critic"])
        if state.get("obs_rms") is not None:
            self.obs_rms.load_state_dict(state["obs_rms"])
        if state.get("ret_rms") is not None:
            self.ret_rms.load_state_dict(state["ret_rms"])
        self.actor_opt.load_state_dict(state["actor_opt_state"])
        self.critic_opt.load_state_dict(state["critic_opt_state"])
        self.actor_updates = state["actor_updates"]
        self.critic_updates = state["critic_updates"]
        self.iter_count = state.get("iter_count", 0)
        self.step_count = state.get("step_count", 0)

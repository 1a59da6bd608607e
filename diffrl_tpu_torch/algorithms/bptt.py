"""BPTT: full-horizon backprop-through-time policy optimization (port of
diffrl_tpu/algorithms/bptt.py).

One epoch rolls the actor out for ``steps_num`` env steps with gradients
through the simulator (the replay reverse pass of ``simulate_batched_lb``:
on CUDA the cached substeps run the hand-written forward and adjoint
kernels, the refresh substeps are replayed under autograd), then takes one
optimizer step. The loss conventions are the JAX trainer's: each env
accumulates its discounted reward, -rew_acc is settled into the loss when
the env is done and for every env at the window's end, there is no critic;
the loss is divided by steps_num x num_envs. The gradients are
nan_to_num-ed and scaled by min(1, grad_norm / (norm + 1e-12)); the
optimizer is Adam with the config's betas or plain gradient descent
(``algo: gd``/``sgd``), at optax's ``linear_schedule(lr, 1e-5,
max_epochs)`` evaluated at the step count, or optax's L-BFGS with its zoom
line search (``algo: lbfgs``, optim/lbfgs.py), whose every probe re-runs
the whole window from the same env state, statistics, trackers and
generator states. The observations are normalized with the statistics
frozen at the window's start while a live copy updates.

Random draws (actor noise) come from one ``torch.Generator`` on the
trainer's device, or from the ``noise`` argument of ``rollout`` and
``train_epoch``; env resets from the env's own. The host reads the epoch's
statistics once, in one transfer.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import default_device, optim
from .. import envs as env_registry
from ..models import ActorDeterministicMLP, ActorStochasticMLP
from ..utils import AverageMeter, RunningMeanStd, TimeReport, print_info
from ..utils.time_report import epoch_span
from .shac import _global_norm, clip_and_step, linear_schedule
from .trainer import Trainer


def make_optimizer(name: str, params, lr: float, betas):
    """The optimizer ``algo.name`` names: adam (also for the generic
    "bptt"), gd/sgd, or lbfgs (optax.lbfgs(memory_size=10) with
    scale_by_zoom_linesearch(max_linesearch_steps=8), the JAX trainer's)."""
    name = name.lower()
    if name in ("bptt", "adam"):
        return optim.adam(params, lr, b1=betas[0], b2=betas[1])
    if name in ("gd", "sgd"):
        return optim.gd(params, lr)
    if name == "lbfgs":
        return optim.LBFGS(params)
    raise ValueError(f"unknown optimizer '{name}'")


class BPTT(Trainer):
    def __init__(self, cfg: Dict[str, Any], device=None):
        params = cfg["params"]
        general = params.get("general", {})
        config = params["config"]
        diff_env = params["diff_env"]
        self.device = default_device(device)

        self.seed = general.get("seed", 0)
        self.env = env_registry.make(
            diff_env["name"],
            num_envs=config["num_actors"],
            seed=self.seed,
            episode_length=diff_env.get("episode_length", 250),
            stochastic_init=diff_env.get("stochastic_env", False),
            MM_caching_frequency=diff_env.get("MM_caching_frequency", 1),
            sim_backward=diff_env.get("sim_backward"),
            device=self.device,
        )
        self.num_envs = self.env.num_envs
        self.num_obs = self.env.num_obs
        self.num_actions = self.env.num_acts

        self.gamma = config.get("gamma", 0.99)
        self.steps_num = config["steps_num"]
        self.max_epochs = config["max_epochs"]
        self.actor_lr = float(config["actor_learning_rate"])
        self.lr_schedule = config.get("lr_schedule", "linear")
        self.rew_scale = config.get("rew_scale", 1.0)
        self.use_obs_rms = config.get("obs_rms", False)
        self.truncate_grad = config.get("truncate_grads", True)
        self.grad_norm = config.get("grad_norm", 1.0)
        self.name = config.get("name", "bptt")
        self.log_dir = general.get("logdir", "./logs")
        self._make_log_dir()
        self.save_interval = config.get("save_interval", 500)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        cfg_network = params.get("network", {})
        actor_name = cfg_network.get("actor", "ActorStochasticMLP")
        actor_cls = {"ActorStochasticMLP": ActorStochasticMLP,
                     "ActorDeterministicMLP": ActorDeterministicMLP}[actor_name]
        self.actor = actor_cls(self.num_obs, self.num_actions, cfg_network,
                               device=self.device, generator=self.generator)
        self.stochastic_actor = actor_name == "ActorStochasticMLP"

        betas = tuple(config.get("betas", (0.7, 0.95)))
        algo_name = params.get("algo", {}).get("name", "adam")
        self.actor_opt = make_optimizer(algo_name, self.actor.parameters(),
                                        self.actor_lr, betas)
        self.is_lbfgs = algo_name.lower() == "lbfgs"
        self.actor_updates = 0

        self.obs_rms = (RunningMeanStd((self.num_obs,), device=self.device)
                        if self.use_obs_rms else None)

        self.env_state = self.env.reset()
        E, dev = self.num_envs, self.device
        self.episode_trackers = dict(
            ep_loss=torch.zeros(E, device=dev),
            ep_disc_loss=torch.zeros(E, device=dev),
            ep_gamma=torch.ones(E, device=dev),
            ep_len=torch.zeros(E, dtype=torch.int32, device=dev),
        )

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
        self.time_report = TimeReport()
        self.scalars: Dict[str, list] = {}

    # ------------------------------------------------------------ one epoch

    def _act(self, obs_n, eps, deterministic):
        if not self.stochastic_actor:
            return self.actor(obs_n)
        if deterministic or eps is None:
            return self.actor(obs_n, deterministic=deterministic,
                              generator=self.generator)
        return self.actor(obs_n, deterministic=True) + eps * torch.exp(
            self.actor.logstd)

    def rollout(self, deterministic: bool = False,
                noise: Optional[torch.Tensor] = None):
        """The window from the current env state, with gradients through
        the simulator; ``noise`` [H, E, A] holds the stochastic actor's
        standard normal draws (else they come from the generator). Returns
        (loss, outs) with outs the per-step [H, E] episode records;
        advances env_state, the trackers and the live obs statistics."""
        env, H, E = self.env, self.steps_num, self.num_envs
        gamma_c = self.gamma
        env_state, obs = env.initialize_trajectory(self.env_state)

        rms = None
        if self.obs_rms is not None:
            rms = self.obs_rms.copy()           # frozen for the whole window
            self.obs_rms.update(obs)

        trk = self.episode_trackers
        rew_acc = torch.zeros(E, device=self.device)
        gamma = torch.ones(E, device=self.device)
        loss = torch.zeros((), device=self.device)
        outs = {k: [] for k in ("done", "ep_loss_done", "ep_disc_done",
                                "ep_len_done")}
        for i in range(H):
            obs_n = rms.normalize(obs) if rms is not None else obs
            actions = torch.tanh(self._act(
                obs_n, None if noise is None else noise[i], deterministic))
            env_state, obs, rew_raw, done, _ = env.step(env_state, actions)
            rew = rew_raw * self.rew_scale
            if self.obs_rms is not None:
                self.obs_rms.update(obs)

            rew_acc = rew_acc + gamma * rew
            settle = done if i < H - 1 else torch.ones_like(done)
            loss = loss + torch.where(settle, -rew_acc,
                                      torch.zeros_like(rew_acc)).sum()
            gamma = torch.where(done, torch.ones_like(gamma), gamma * gamma_c)
            rew_acc = torch.where(done, torch.zeros_like(rew_acc), rew_acc)

            with torch.no_grad():
                raw = rew_raw.detach()
                ep_loss = trk["ep_loss"] - raw
                ep_disc = trk["ep_disc_loss"] - trk["ep_gamma"] * raw
                ep_len = trk["ep_len"] + 1
                z = torch.zeros_like(ep_loss)
                outs["done"].append(done)
                outs["ep_loss_done"].append(torch.where(done, ep_loss, z))
                outs["ep_disc_done"].append(torch.where(done, ep_disc, z))
                outs["ep_len_done"].append(torch.where(
                    done, ep_len, torch.zeros_like(ep_len)))
                trk = dict(
                    ep_loss=torch.where(done, z, ep_loss),
                    ep_disc_loss=torch.where(done, z, ep_disc),
                    ep_gamma=torch.where(done, torch.ones_like(ep_loss),
                                         trk["ep_gamma"] * gamma_c),
                    ep_len=torch.where(done, torch.zeros_like(ep_len),
                                       ep_len),
                )

        self.env_state = env_state.detach()
        self.episode_trackers = trk
        return loss / (H * E), {k: torch.stack(v) for k, v in outs.items()}

    def apply_actor_grads(self):
        """One clipped optimizer step from the gradients in the actor's
        .grad, at the scheduled learning rate. Returns the norm before the
        clip."""
        lr = (linear_schedule(self.actor_lr, 1e-5, self.max_epochs,
                              self.actor_updates)
              if self.lr_schedule == "linear" else self.actor_lr)
        gnorm, _ = clip_and_step(self.actor_opt, list(self.actor.parameters()),
                                 lr, self.grad_norm, self.truncate_grad)
        self.actor_updates += 1
        return gnorm

    @epoch_span("bptt.epoch")
    def train_epoch(self, noise: Optional[torch.Tensor] = None):
        """One BPTT epoch; returns its statistics as device tensors."""
        if self.is_lbfgs:
            return self._lbfgs_epoch(noise)
        loss, outs = self.rollout(noise=noise)
        self.actor_opt.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = self.apply_actor_grads()
        return dict(actor_loss=loss.detach(), gnorm=gnorm, **outs)

    def _window_state(self):
        """What a window changes: the env state, the trackers, a copy of
        the live observation statistics and the generators' states (the
        actor's noise and the env's resets)."""
        gens = [self.generator, getattr(self.env, "generator", None)]
        return (self.env_state, self.episode_trackers,
                self.obs_rms.copy() if self.obs_rms is not None else None,
                [g.get_state() if g is not None else None for g in gens])

    def _set_window_state(self, saved):
        self.env_state, self.episode_trackers, rms, gen_states = saved
        if rms is not None:
            self.obs_rms.load_state_dict(rms.state_dict())
        for g, st in zip((self.generator, getattr(self.env, "generator",
                                                  None)), gen_states):
            if g is not None:
                g.set_state(st)

    def _window_grads(self, loss):
        params = list(self.actor.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)]

    def _lbfgs_epoch(self, noise):
        """One L-BFGS update (the JAX trainer's actor_update with optax's
        lbfgs): the window's gradient, nan_to_num-ed and clipped, gives
        the direction; each line-search probe re-runs the whole window
        from the state it started from, with the same draws, and takes its
        plain gradient. The trainer then carries on from the first run's
        end."""
        opt = self.actor_opt
        start = self._window_state()
        loss, outs = self.rollout(noise=noise)
        end = self._window_state()
        grads = [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                 for g in self._window_grads(loss)]
        gnorm = _global_norm(grads)
        if self.truncate_grad:
            scale = torch.clamp(self.grad_norm / (gnorm + 1e-12), max=1.0)
            grads = [g * scale for g in grads]

        def value_and_grad(w):
            opt.set_params(w)
            self._set_window_state(start)
            with torch.enable_grad():
                probe, _ = self.rollout(noise=noise)
                return probe.detach(), opt.flat_grad(
                    self._window_grads(probe))

        opt.step(loss.detach(), opt.flat_grad(grads), value_and_grad)
        self._set_window_state(end)
        self.actor_updates += 1
        return dict(actor_loss=loss.detach(), gnorm=gnorm, **outs)

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
            torch.stack([stats["actor_loss"], stats["gnorm"]]),
            stats["done"].to(torch.float32).reshape(-1),
            stats["ep_loss_done"].reshape(-1),
            stats["ep_disc_done"].reshape(-1),
            stats["ep_len_done"].to(torch.float32).reshape(-1),
        ]).cpu().numpy()
        self.actor_loss, gnorm = float(host[0]), float(host[1])
        done, ep_losses, ep_disc, ep_lens = host[2:].reshape(4, H * E)
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
            policy_loss=mean_policy_loss,
            rewards=-mean_policy_loss if np.isfinite(mean_policy_loss)
            else np.nan,
            episode_lengths=mean_episode_length,
            fps=fps,
        )
        print(f"iter {self.iter_count}: ep loss {mean_policy_loss:.2f}, "
              f"ep discounted loss {mean_policy_discounted_loss:.2f}, "
              f"ep len {mean_episode_length:.1f}, fps total {fps:.2f}, "
              f"grad norm {gnorm:.2f}")
        if self.save_interval > 0 and self.iter_count % self.save_interval == 0:
            self.save(f"{self.name}policy_iter{self.iter_count}")

    # ----------------------------------------------------------- evaluation

    def evaluate_policy(self, num_games, deterministic=False):
        """Batched evaluation on the training env (batched_eval): (mean
        episode loss, mean discounted loss, mean length)."""
        from .eval_utils import batched_eval, policy_act_fn

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        mean_rew, mean_disc, mean_len = batched_eval(
            self.env, policy_act_fn(self.actor, self.obs_rms, deterministic),
            num_games, gamma=self.gamma, generator=gen)
        return -mean_rew, -mean_disc, mean_len

    def run(self, num_games):
        mean_loss, mean_disc, mean_len = self.evaluate_policy(num_games)
        print_info(f"mean episode loss = {mean_loss}, mean discounted loss = "
                   f"{mean_disc}, mean episode length = {mean_len}")
        return mean_loss, mean_len


    # ---------------------------------------------------------- checkpoints

    def _snapshot(self, copy_state: bool = False):
        state = {
            "actor": self.actor.state_dict(),
            "obs_rms": (self.obs_rms.state_dict()
                        if self.obs_rms is not None else None),
            "actor_opt_state": self.actor_opt.state_dict(),
            "actor_updates": self.actor_updates,
            "iter_count": self.iter_count,
            "step_count": self.step_count,
        }
        return copy.deepcopy(state) if copy_state else state


    def load(self, path):
        state = torch.load(path, map_location=self.device)
        self.actor.load_state_dict(state["actor"])
        if state.get("obs_rms") is not None:
            self.obs_rms.load_state_dict(state["obs_rms"])
        if state.get("actor_opt_state") is not None:   # not in a JAX
            self.actor_opt.load_state_dict(state["actor_opt_state"])
        self.actor_updates = state.get("actor_updates", 0)
        self.iter_count = state.get("iter_count", 0)
        self.step_count = state.get("step_count", 0)

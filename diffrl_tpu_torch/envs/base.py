"""Batched environment layer (port of diffrl_tpu/envs/base.py).

``DiffEnv.step`` keeps the reference ordering exactly: clip actions -> map
them to controls -> simulate -> observations and reward from the
nan_to_num-sanitized state -> done = time limit | termination | invalid ->
non-finite reward to 0 -> in-graph partial reset with fresh states drawn
from the env's generator. The returned obs comes from the post-reset state;
``info`` carries the pre-reset obs and the episode flags.

The hooks work on the whole batch ([E, ...] tensors, env-leading) where the
JAX package vmaps single-env hooks. The simulator is forward-only for now
(``simulate_batched_lb`` raises on inputs that require grad).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .. import default_device
from ..sim.articulation_lb import simulate_batched_lb
from ..sim.model import Model


@dataclass
class EnvState:
    """Batched env state, env-leading."""

    joint_q: torch.Tensor      # [E, C]
    joint_qd: torch.Tensor     # [E, D]
    actions: torch.Tensor      # [E, A] last applied actions
    progress: torch.Tensor     # [E] int32

    def detach(self) -> "EnvState":
        return EnvState(self.joint_q.detach(), self.joint_qd.detach(),
                        self.actions.detach(), self.progress)


def _sanitize(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class DiffEnv:
    """Base class of the batched environments.

    Subclasses build ``self.model`` and implement the batched hooks. The env
    owns a ``torch.Generator`` on its device (seeded with ``seed``) that
    draws every initial and reset state.
    """

    num_obs: int = 0
    num_acts: int = 0

    dt = 1.0 / 60.0
    sim_substeps = 16

    def __init__(
        self,
        num_envs: int = 64,
        seed: int = 0,
        episode_length: int = 1000,
        stochastic_init: bool = False,
        MM_caching_frequency: int = 1,
        early_termination: bool = True,
        device=None,
    ):
        self.device = default_device(device)
        self.num_envs = num_envs
        self.seed = seed
        self.episode_length = episode_length
        self.stochastic_init = stochastic_init
        self.mm_caching_frequency = MM_caching_frequency
        self.early_termination = early_termination
        if self.sim_substeps % max(MM_caching_frequency, 1):
            raise ValueError(
                "sim_substeps must be a multiple of MM_caching_frequency")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.model: Model = self.build_model()

    # -- batched hooks ---------------------------------------------------------

    def build_model(self) -> Model:
        raise NotImplementedError

    def action_to_controls(self, actions) -> Tuple[Optional[torch.Tensor],
                                                   Optional[torch.Tensor]]:
        """Clipped actions [E, A] -> (joint_act [E, D] | None,
        muscle_act [E, M] | None)."""
        raise NotImplementedError

    def observations(self, joint_q, joint_qd, actions) -> torch.Tensor:
        raise NotImplementedError

    def reward(self, obs, actions) -> torch.Tensor:
        raise NotImplementedError

    def termination(self, obs) -> torch.Tensor:
        """Early-termination flags [E] (bool). Default: never."""
        return torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)

    def initial_state(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """n start states (joint_q [n, C], joint_qd [n, D]), drawn from
        ``self.generator`` when stochastic_init."""
        raise NotImplementedError

    def invalid_mask(self, obs, joint_q, joint_qd) -> torch.Tensor:
        """NaN/inf/blow-up defense flags [E]; default none."""
        return torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)

    def zero_reward_on_invalid(self) -> bool:
        return False

    # -- public API --------------------------------------------------------------

    def batch_observations(self, env_state: EnvState) -> torch.Tensor:
        return self.observations(
            env_state.joint_q, env_state.joint_qd, env_state.actions)

    def reset(self) -> EnvState:
        """Fresh EnvState with all envs at (possibly stochastic) start state."""
        q, qd = self.initial_state(self.num_envs)
        return EnvState(
            joint_q=q,
            joint_qd=qd,
            actions=torch.zeros((self.num_envs, self.num_acts),
                                dtype=torch.float32, device=self.device),
            progress=torch.zeros((self.num_envs,), dtype=torch.int32,
                                 device=self.device),
        )

    def step(self, env_state: EnvState, actions
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor,
                        Dict[str, Any]]:
        """One env step for the whole batch.

        Returns (next_state, obs, reward, done, info): reward and done from
        the pre-reset state, obs from the post-reset state, the pre-reset obs
        in info['obs_before_reset'].
        """
        actions = torch.clamp(
            actions.reshape(self.num_envs, self.num_acts), -1.0, 1.0)
        joint_act, muscle_act = self.action_to_controls(actions)

        q, qd = simulate_batched_lb(
            self.model, env_state.joint_q, env_state.joint_qd, joint_act,
            muscle_act, dt=self.dt, substeps=self.sim_substeps,
            mass_matrix_freq=self.mm_caching_frequency)

        progress = env_state.progress + 1

        # obs and reward from the sanitized state; invalidity from the raw one
        obs = self.observations(_sanitize(q), _sanitize(qd), actions)
        rew = self.reward(obs, actions)
        truncation = progress > self.episode_length - 1
        done = truncation
        term = self.termination(obs)
        if self.early_termination:
            done = done | term
        invalid = self.invalid_mask(obs, q, qd)
        done = done | invalid
        rew = torch.where(torch.isfinite(rew), rew, torch.zeros_like(rew))
        if self.zero_reward_on_invalid():
            rew = torch.where(invalid, torch.zeros_like(rew), rew)

        # in-graph partial reset: fresh states for every env, taken where done
        q0, qd0 = self.initial_state(self.num_envs)
        d = done[:, None]
        q_safe = torch.where(d, _sanitize(q), q)
        qd_safe = torch.where(d, _sanitize(qd), qd)
        q_new = torch.where(d, q0, q_safe)
        qd_new = torch.where(d, qd0, qd_safe)
        actions_new = torch.where(d, torch.zeros_like(actions), actions)
        progress_new = torch.where(done, torch.zeros_like(progress), progress)

        obs_reset = self.observations(q_new, qd_new, actions_new)
        obs_out = torch.where(d, obs_reset, obs)

        new_state = EnvState(joint_q=q_new, joint_qd=qd_new,
                             actions=actions_new, progress=progress_new)
        info = {
            "obs_before_reset": obs,
            "episode_end": term | invalid,
            "invalid": invalid,
            "truncation": truncation,
        }
        return new_state, obs_out, rew, done, info

    def initialize_trajectory(self, env_state: EnvState):
        """Cut the graph to previous windows; returns (detached state,
        current observations)."""
        detached = env_state.detach()
        return detached, self.batch_observations(detached)

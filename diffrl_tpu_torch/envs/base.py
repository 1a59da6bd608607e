"""Batched environment layer (port of diffrl_tpu/envs/base.py).

``DiffEnv.step`` keeps the reference ordering exactly: clip actions -> map
them to controls -> simulate -> observations and reward from the
nan_to_num-sanitized state -> done = time limit | termination | invalid ->
non-finite reward to 0 -> in-graph partial reset with fresh states drawn
from the env's generator. The returned obs comes from the post-reset state;
``info`` carries the pre-reset obs and the episode flags.

The hooks work on the whole batch ([E, ...] tensors, env-leading) where the
JAX package vmaps single-env hooks. The step is differentiable: gradients
reach actions and the incoming state through the simulator's reverse pass
(``sim_backward``), and ``grad_nan_guard`` sanitizes the cotangents of its
inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .. import config, default_device
from ..sim.articulation import simulate
from ..sim.articulation_lb import simulate_batched_lb
from ..sim.model import Model, State


# the reverse passes an env takes (DiffEnv's docstring)
SIM_BACKWARDS = ("auto", "lb", "pallas", "lb_ad", "remat", "manual")


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


def clip(x, lo: float, hi: float):
    """jnp.clip's semantics: the maximum with lo, then the minimum with hi,
    so that at a tie each side takes half the cotangent (torch.clamp would
    pass all of it). The bounds are filled on x's device: a tensor made
    from a host number would be a synchronizing copy on every call."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _sanitize(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class _GradNanGuard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sanitize(g)


def grad_nan_guard(x):
    """Identity whose backward nan_to_nums the cotangent (the JAX package's
    grad_nan_guard, diffrl_tpu/envs/base.py). Once one env's physics blows
    up, its NaN primals make NaN cotangents whatever gradient comes in;
    guarding the simulator's inputs zeroes exactly those entries, so one
    bad env cannot NaN the whole batch's parameter gradient. None and
    tensors that need no gradient pass through."""
    if x is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradNanGuard.apply(x)


class DiffEnv:
    """Base class of the batched environments.

    Subclasses build ``self.model`` and implement the batched hooks. The env
    owns a ``torch.Generator`` on its device (seeded with ``seed``) that
    draws every initial and reset state.

    ``sim_backward`` chooses the simulator and its reverse pass; every
    route takes the same ``grad_nan_guard`` on the simulator's inputs:

    - ``"lb"`` and ``"pallas"``: the link-batched env-minor engine with the
      replay reverse pass (``simulate_batched_lb``), whose cached substeps
      run in the hand-written kernels K1 and K2 on CUDA tensors (their
      plain versions on the CPU). The JAX package's ``"pallas"`` runs its
      Pallas substep kernels, whose ports are K1 and K2: both names take
      this path;
    - ``"lb_ad"``: the same engine with ``reverse="residual"``: each
      cached substep is an autograd node (K1 forward, K2 backward on its
      saved inputs, no replay), the refresh substep is differentiated by
      autograd through its plain code;
    - ``"remat"``: ``sim.articulation.simulate``, autograd through
      ``torch.utils.checkpoint`` per substep (``remat_granularity`` cached
      substeps per region), the general path (particles included);
    - ``"manual"``: ``simulate(backward="manual")``, the hand-written
      reverse pass over the plain substeps (articulations only);
    - ``None``: ``config.default_sim_backward``; ``"auto"``: the JAX
      package's rule, ``"lb"`` when the model qualifies (no particles,
      links, substeps a multiple of MM_caching_frequency), else
      ``"remat"``.

    While ``config.verify_fp`` is set, ``step`` raises FloatingPointError
    on a non-finite output (``config.enable_fp_verification``).
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
        remat_granularity: int = 1,
        sim_backward: Optional[str] = None,
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
        self.remat_granularity = remat_granularity
        if sim_backward is None:
            sim_backward = config.default_sim_backward
        if sim_backward not in SIM_BACKWARDS:
            raise ValueError(f"unknown sim_backward {sim_backward!r}")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.model: Model = self.build_model()
        if sim_backward == "auto":
            lb_ok = (self.model.particle_count == 0
                     and self.model.link_count > 0)
            sim_backward = "lb" if lb_ok else "remat"
        self.sim_backward = sim_backward

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

        # per-entry gradient firewall on the simulator's inputs
        q, qd = self.simulate(*map(grad_nan_guard, (
            env_state.joint_q, env_state.joint_qd, joint_act, muscle_act)))

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

        # in-graph partial reset: fresh states for every env, taken where
        # done; the draws carry no gradient to the past
        q0, qd0 = (x.detach() for x in self.initial_state(self.num_envs))
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
        if config.verify_fp:
            config.check_finite(q_new, qd_new, obs_out, rew,
                                name=f"{type(self).__name__}.step")
        return new_state, obs_out, rew, done, info

    def simulate(self, q, qd, joint_act, muscle_act):
        """One env step of the simulator on the env's reverse pass
        (``sim_backward``): joint_q [E, C], joint_qd [E, D], joint_act
        [E, D] | None, muscle_act [E, M] | None -> (joint_q', joint_qd')."""
        if self.sim_backward in ("lb", "pallas", "lb_ad"):
            return simulate_batched_lb(
                self.model, q, qd, joint_act, muscle_act, dt=self.dt,
                substeps=self.sim_substeps,
                mass_matrix_freq=self.mm_caching_frequency,
                reverse="residual" if self.sim_backward == "lb_ad"
                else "replay")
        s = simulate(self.model, State(joint_q=q, joint_qd=qd),
                     joint_act=joint_act, muscle_act=muscle_act, dt=self.dt,
                     substeps=self.sim_substeps,
                     mass_matrix_freq=self.mm_caching_frequency,
                     remat_granularity=self.remat_granularity,
                     backward=self.sim_backward)
        return s.joint_q, s.joint_qd

    def initialize_trajectory(self, env_state: EnvState):
        """Cut the graph to previous windows; returns (detached state,
        current observations)."""
        detached = env_state.detach()
        return detached, self.batch_observations(detached)

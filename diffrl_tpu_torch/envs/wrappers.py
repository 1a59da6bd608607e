"""Stateful environment adapter: the reference's DFlexEnv API (port of
diffrl_tpu/envs/wrappers.py).

The reference exposes a stateful vectorized env (envs/dflex_env.py):
``obs = env.reset()``, ``obs, rew, done, info = env.step(actions)``, and
the gradient-window helpers ``clear_grad()``, ``initialize_trajectory()``
and ``get_checkpoint()``. The port's envs, like the JAX package's, step an
EnvState the caller carries; this wrapper carries it, so that code written
against the reference's API runs unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

try:
    from gymnasium import spaces as _spaces
except ImportError:
    _spaces = None

from .base import DiffEnv, EnvState


class StatefulEnv:
    """Wraps a DiffEnv with carried state (the DFlexEnv surface).

    Resets draw from the env's generator, which the wrapper seeds with
    ``seed``: each ``reset()`` draws fresh initial states, and the first
    one after construction is the same for the same seed.
    ``observation_space`` and ``action_space`` (gymnasium Boxes) exist
    where gymnasium imports.
    """

    def __init__(self, env: DiffEnv, seed: int = 0):
        self.env = env
        self.seed = seed
        env.generator.manual_seed(seed)
        self.state: Optional[EnvState] = None
        self.extras: Dict[str, Any] = {}

        if _spaces is not None:
            ones_o = np.ones(env.num_obs, dtype=np.float32) * np.inf
            ones_a = np.ones(env.num_acts, dtype=np.float32)
            self.observation_space = _spaces.Box(-ones_o, ones_o)
            self.action_space = _spaces.Box(-ones_a, ones_a)

    # -- reference DFlexEnv properties ---------------------------------------

    @property
    def num_envs(self):
        return self.env.num_envs

    @property
    def num_obs(self):
        return self.env.num_obs

    @property
    def num_actions(self):
        return self.env.num_acts

    @property
    def episode_length(self):
        return self.env.episode_length

    # -- stateful API ---------------------------------------------------------

    def reset(self, force_reset: bool = True):
        if self.state is None or force_reset:
            self.state = self.env.reset()
        return self.env.batch_observations(self.state)

    def step(self, actions):
        if self.state is None:
            raise RuntimeError("call reset() first")
        self.state, obs, rew, done, info = self.env.step(self.state, actions)
        self.extras = info
        return obs, rew, done, info

    def clear_grad(self):
        """Detach the carried state from the graph of earlier steps
        (the reference's envs/ant.py clear_grad)."""
        if self.state is not None:
            self.state = self.state.detach()

    def initialize_trajectory(self):
        """Cut the graph and return the current observations (the
        reference's envs/ant.py initialize_trajectory)."""
        self.clear_grad()
        return self.env.batch_observations(self.state)

    def get_checkpoint(self):
        """A copy of the carried state."""
        return dataclasses.replace(self.state, **{
            f.name: getattr(self.state, f.name).clone()
            for f in dataclasses.fields(self.state)})

    def load_checkpoint(self, ckpt):
        self.state = ckpt

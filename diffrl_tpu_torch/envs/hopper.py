"""Hopper env with a planar base (port of diffrl_tpu/envs/hopper.py).

The root is a chain of two slides and a hinge in the x-z plane of the MJCF
file, with no free joint, tilted into the y-up world: 6 links, 6
coordinates, 6 dofs; the 3 leg hinges are actuated.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..sim.importers.mjcf import parse_mjcf
from ..sim.model import ModelBuilder, np_quat_from_axis_angle, np_transform
from .base import DiffEnv, clip

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


class HopperEnv(DiffEnv):
    num_obs = 11
    num_acts = 3

    dt = 1.0 / 60.0
    sim_substeps = 16

    termination_height = -0.45
    termination_angle = np.pi / 6.0
    termination_height_tolerance = 0.15
    termination_angle_tolerance = 0.05
    height_rew_scale = 1.0
    action_strength = 200.0
    action_penalty = -1e-1

    def __init__(self, num_envs=4096, seed=0, episode_length=1000,
                 stochastic_init=False, MM_caching_frequency=1,
                 early_termination=True, device=None):
        super().__init__(
            num_envs=num_envs, seed=seed, episode_length=episode_length,
            stochastic_init=stochastic_init,
            MM_caching_frequency=MM_caching_frequency,
            early_termination=early_termination, device=device,
        )
        self.joint_q_init = torch.as_tensor(self.model.joint_q_init,
                                            device=self.device)

    def build_model(self):
        builder = ModelBuilder()
        parse_mjcf(
            os.path.join(_ASSETS, "hopper.xml"),
            builder,
            density=1000.0,
            stiffness=0.0,
            damping=2.0,
            contact_ke=2.0e4,
            contact_kd=1.0e3,
            contact_kf=1.0e3,
            contact_mu=0.9,
            limit_ke=1.0e3,
            limit_kd=1.0e1,
            armature=1.0,
            radians=True,
            load_stiffness=True,
        )
        # tilt the planar base into the y-up world
        builder.joint_X_pj[0] = np_transform(
            (0.0, 0.0, 0.0),
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5))
        model = builder.finalize()
        return dataclasses.replace(
            model, ground=True,
            gravity=np.array([0.0, -9.81, 0.0], np.float32))

    def action_to_controls(self, actions):
        joint_act = torch.cat(
            [actions.new_zeros((actions.shape[0], 3)),
             actions * self.action_strength], dim=-1)
        return joint_act, None

    def observations(self, joint_q, joint_qd, actions):
        return torch.cat([joint_q[:, 1:], joint_qd], dim=-1)

    def reward(self, obs, actions):
        height_diff = obs[:, 0] - (self.termination_height
                                   + self.termination_height_tolerance)
        height_reward = clip(height_diff, -1.0, 0.3)
        height_reward = torch.where(height_reward < 0.0,
                                    -200.0 * height_reward ** 2, height_reward)
        height_reward = torch.where(height_reward > 0.0,
                                    self.height_rew_scale * height_reward,
                                    height_reward)

        angle_reward = 1.0 * (-(obs[:, 1] ** 2) / (self.termination_angle ** 2)
                              + 1.0)
        progress_reward = obs[:, 5]
        return (
            progress_reward + height_reward + angle_reward
            + torch.sum(actions ** 2, dim=-1) * self.action_penalty
        )

    def termination(self, obs):
        return obs[:, 0] < self.termination_height

    def initial_state(self, n):
        C, D = self.model.coord_count, self.model.dof_count
        q0 = self.joint_q_init.expand(n, C)
        qd0 = torch.zeros((n, D), device=self.device)
        if not self.stochastic_init:
            return q0.clone(), qd0

        def uniform(*shape):
            return torch.rand(shape, generator=self.generator,
                              device=self.device)

        base = q0[:, 0:2] + 0.05 * (uniform(n, 2) - 0.5) * 2.0
        rot = (uniform(n, 1) - 0.5) * 0.1
        joints = q0[:, 3:] + 0.05 * (uniform(n, C - 3) - 0.5) * 2.0
        q0 = torch.cat([base, rot, joints], dim=-1)
        qd0 = 0.05 * (uniform(n, D) - 0.5) * 2.0
        return q0, qd0

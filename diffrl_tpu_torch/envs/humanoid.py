"""Humanoid locomotion env (port of diffrl_tpu/envs/humanoid.py).

The MJCF humanoid: a free torso and 21 hinges (several per body in the
hips, abdomen, shoulders and ankles, each a link of its own), 22 links,
28 coordinates and 27 dofs, 48 substeps per env step.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..ops import quat_conjugate
from ..sim.importers.mjcf import parse_mjcf
from ..sim.model import ModelBuilder, np_quat_from_axis_angle
from .base import DiffEnv, clip
from .locomotion import free_base_initial_state, free_base_observations

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")

_MOTOR_STRENGTHS = (
    200, 200, 200, 200, 200, 600, 400, 100, 100, 200, 200,
    600, 400, 100, 100, 100, 100, 200, 100, 100, 200,
)


class HumanoidEnv(DiffEnv):
    num_obs = 76
    num_acts = 21

    dt = 1.0 / 60.0
    sim_substeps = 48

    termination_height = 0.74
    motor_scale = 0.35
    action_penalty = -0.002
    joint_vel_obs_scaling = 0.1
    termination_tolerance = 0.1
    height_rew_scale = 10.0
    start_height = 1.35

    def __init__(self, num_envs=4096, seed=0, episode_length=1000,
                 stochastic_init=False, MM_caching_frequency=1,
                 early_termination=True, device=None):
        super().__init__(
            num_envs=num_envs, seed=seed, episode_length=episode_length,
            stochastic_init=stochastic_init,
            MM_caching_frequency=MM_caching_frequency,
            early_termination=early_termination, device=device,
        )
        dev = self.device
        self.start_rotation = torch.as_tensor(
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5),
            dtype=torch.float32, device=dev)
        self.inv_start_rot = quat_conjugate(self.start_rotation)
        self.start_pos = torch.tensor([0.0, self.start_height, 0.0],
                                      device=dev)
        self.targets = torch.tensor([200.0, 0.0, 0.0], device=dev)
        self.motor_strengths = torch.tensor(_MOTOR_STRENGTHS,
                                            dtype=torch.float32, device=dev)
        self.joint_q_init = torch.as_tensor(self.model.joint_q_init,
                                            device=dev)

    def build_model(self):
        builder = ModelBuilder()
        parse_mjcf(
            os.path.join(_ASSETS, "humanoid.xml"),
            builder,
            stiffness=5.0,
            damping=0.1,
            contact_ke=2.0e4,
            contact_kd=5.0e3,
            contact_kf=1.0e3,
            contact_mu=0.75,
            limit_ke=1.0e3,
            limit_kd=1.0e1,
            armature=0.007,
            load_stiffness=True,
            load_armature=True,
        )
        builder.joint_q[0:3] = [0.0, self.start_height, 0.0]
        builder.joint_q[3:7] = list(
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5))
        model = builder.finalize()
        return dataclasses.replace(
            model, ground=True,
            gravity=np.array([0.0, -9.81, 0.0], np.float32))

    def action_to_controls(self, actions):
        joint_act = torch.cat(
            [actions.new_zeros((actions.shape[0], 6)),
             actions * self.motor_scale * self.motor_strengths], dim=-1)
        return joint_act, None

    def observations(self, joint_q, joint_qd, actions):
        # 0 height, 1:5 rotation, 5:8 and 8:11 velocities, 11:32 joint
        # angles, 32:53 joint velocities, 53 up, 54 heading, 55:76 actions
        return free_base_observations(self, joint_q, joint_qd, actions)

    def reward(self, obs, actions):
        up_reward = 0.1 * obs[:, 53]
        heading_reward = obs[:, 54]

        height_diff = obs[:, 0] - (self.termination_height
                                   + self.termination_tolerance)
        height_reward = clip(height_diff, -1.0, self.termination_tolerance)
        height_reward = torch.where(height_reward < 0.0,
                                    -200.0 * height_reward ** 2, height_reward)
        height_reward = torch.where(height_reward > 0.0,
                                    self.height_rew_scale * height_reward,
                                    height_reward)

        progress_reward = obs[:, 5]
        return (
            progress_reward + up_reward + heading_reward + height_reward
            + torch.sum(actions ** 2, dim=-1) * self.action_penalty
        )

    def termination(self, obs):
        return obs[:, 0] < self.termination_height

    def invalid_mask(self, obs, joint_q, joint_qd):
        return (
            torch.any(~torch.isfinite(obs), dim=-1)
            | torch.any(~torch.isfinite(joint_q), dim=-1)
            | torch.any(~torch.isfinite(joint_qd), dim=-1)
            | torch.any(torch.abs(joint_q) > 1e6, dim=-1)
            | torch.any(torch.abs(joint_qd) > 1e6, dim=-1)
        )

    def zero_reward_on_invalid(self):
        # as the JAX env: an invalid (blown-up) env is reset and its reward
        # zeroed, so its NaN reward cannot reach the episode statistics or
        # the window's actor loss
        return True

    def initial_state(self, n):
        return free_base_initial_state(self, n)

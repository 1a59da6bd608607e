"""Ant locomotion env (port of diffrl_tpu/envs/ant.py)."""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..ops import quat_conjugate
from ..sim.importers.mjcf import parse_mjcf
from ..sim.model import ModelBuilder, np_quat_from_axis_angle
from .base import DiffEnv
from .locomotion import free_base_initial_state, free_base_observations

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


class AntEnv(DiffEnv):
    num_obs = 37
    num_acts = 8

    dt = 1.0 / 60.0
    sim_substeps = 16

    termination_height = 0.27
    action_strength = 200.0
    action_penalty = 0.0
    joint_vel_obs_scaling = 0.1

    start_height = 0.75
    start_joint_q = (0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0)

    def __init__(self, num_envs=4096, seed=0, episode_length=1000,
                 stochastic_init=False, MM_caching_frequency=1,
                 early_termination=True, device=None, **kw):
        super().__init__(
            num_envs=num_envs, seed=seed, episode_length=episode_length,
            stochastic_init=stochastic_init,
            MM_caching_frequency=MM_caching_frequency,
            early_termination=early_termination, device=device,
            **kw,
        )
        dev = self.device
        self.start_rotation = torch.as_tensor(
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5),
            dtype=torch.float32, device=dev)
        self.inv_start_rot = quat_conjugate(self.start_rotation)
        self.start_pos = torch.tensor([0.0, self.start_height, 0.0],
                                      device=dev)
        self.targets = torch.tensor([10000.0, 0.0, 0.0], device=dev)
        self.joint_q_init = torch.as_tensor(self.model.joint_q_init,
                                            device=dev)

    def build_model(self):
        builder = ModelBuilder()
        parse_mjcf(
            os.path.join(_ASSETS, "ant.xml"),
            builder,
            density=1000.0,
            stiffness=0.0,
            damping=1.0,
            contact_ke=4.0e4,
            contact_kd=1.0e4,
            contact_kf=3.0e3,
            contact_mu=0.75,
            limit_ke=1.0e3,
            limit_kd=1.0e1,
            armature=0.05,
        )
        builder.joint_q[0:3] = [0.0, self.start_height, 0.0]
        builder.joint_q[3:7] = list(
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5))
        builder.joint_q[7:15] = list(self.start_joint_q)
        builder.joint_target[7:15] = list(self.start_joint_q)
        model = builder.finalize()
        return dataclasses.replace(
            model, ground=True,
            gravity=np.array([0.0, -9.81, 0.0], np.float32))

    def action_to_controls(self, actions):
        joint_act = torch.cat(
            [actions.new_zeros((actions.shape[0], 6)),
             actions * self.action_strength], dim=-1)
        return joint_act, None

    def observations(self, joint_q, joint_qd, actions):
        # 0 height, 1:5 rotation, 5:8 and 8:11 velocities, 11:19 joint
        # angles, 19:27 joint velocities, 27 up, 28 heading, 29:37 actions
        return free_base_observations(self, joint_q, joint_qd, actions)

    def reward(self, obs, actions):
        up_reward = 0.1 * obs[:, 27]
        heading_reward = obs[:, 28]
        height_reward = obs[:, 0] - self.termination_height
        progress_reward = obs[:, 5]
        return (
            progress_reward + up_reward + heading_reward + height_reward
            + torch.sum(actions ** 2, dim=-1) * self.action_penalty
        )

    def termination(self, obs):
        return obs[:, 0] < self.termination_height

    def initial_state(self, n):
        return free_base_initial_state(self, n)

"""Half-cheetah env with a planar base (port of diffrl_tpu/envs/cheetah.py).

The root is a chain of two slides and a hinge, as Hopper's, raised and
tilted into the y-up world: 9 links, 9 coordinates, 9 dofs; the 6 leg
hinges are actuated. No early termination.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..sim.importers.mjcf import parse_mjcf
from ..sim.model import ModelBuilder, np_quat_from_axis_angle, np_transform
from .base import DiffEnv

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


class CheetahEnv(DiffEnv):
    num_obs = 17
    num_acts = 6

    dt = 1.0 / 60.0
    sim_substeps = 16

    action_strength = 200.0
    action_penalty = -0.1
    start_height = -0.2

    def __init__(self, num_envs=4096, seed=0, episode_length=1000,
                 stochastic_init=False, MM_caching_frequency=1,
                 early_termination=False, device=None):
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
            os.path.join(_ASSETS, "half_cheetah.xml"),
            builder,
            density=1000.0,
            stiffness=0.0,
            damping=1.0,
            contact_ke=2.0e4,
            contact_kd=1.0e3,
            contact_kf=1.0e3,
            contact_mu=1.0,
            limit_ke=1.0e3,
            limit_kd=1.0e1,
            armature=0.1,
            radians=True,
            load_stiffness=True,
        )
        # raise and tilt the planar base into the y-up world
        builder.joint_X_pj[0] = np_transform(
            (0.0, 1.0, 0.0),
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5))
        builder.joint_q[1] = self.start_height
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
        progress_reward = obs[:, 8]
        return progress_reward + torch.sum(actions ** 2, dim=-1) * \
            self.action_penalty

    def initial_state(self, n):
        C, D = self.model.coord_count, self.model.dof_count
        q0 = self.joint_q_init.expand(n, C)
        qd0 = torch.zeros((n, D), device=self.device)
        if not self.stochastic_init:
            return q0.clone(), qd0

        def uniform(*shape):
            return torch.rand(shape, generator=self.generator,
                              device=self.device)

        base = q0[:, 0:2] + 0.1 * (uniform(n, 2) - 0.5) * 2.0
        rot = (uniform(n, 1) - 0.5) * 0.2
        joints = q0[:, 3:] + 0.1 * (uniform(n, C - 3) - 0.5) * 2.0
        q0 = torch.cat([base, rot, joints], dim=-1)
        qd0 = 0.5 * (uniform(n, D) - 0.5)
        return q0, qd0

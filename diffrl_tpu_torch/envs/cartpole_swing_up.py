"""CartPole swing-up (port of diffrl_tpu/envs/cartpole_swing_up.py).

The URDF cart-pole: a fixed root link (the slide bar, which carries the
world transform in its joint frame), a prismatic cart and a revolute pole;
3 links, 2 coordinates, 2 dofs, no ground. The pole starts hanging down,
and one action pushes the cart.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..sim.importers.urdf import urdf_load
from ..sim.model import ModelBuilder, np_quat_from_axis_angle, np_transform
from .base import DiffEnv

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


class CartPoleSwingUpEnv(DiffEnv):
    num_obs = 5
    num_acts = 1

    dt = 1.0 / 60.0
    sim_substeps = 4

    action_strength = 1000.0
    pole_angle_penalty = 1.0
    pole_velocity_penalty = 0.1
    cart_position_penalty = 0.05
    cart_velocity_penalty = 0.1
    cart_action_penalty = 0.0

    def __init__(self, num_envs=1024, seed=0, episode_length=240,
                 stochastic_init=False, MM_caching_frequency=1,
                 early_termination=False, device=None, **kw):
        super().__init__(
            num_envs=num_envs, seed=seed, episode_length=episode_length,
            stochastic_init=stochastic_init,
            MM_caching_frequency=MM_caching_frequency,
            early_termination=early_termination, device=device,
            **kw,
        )
        self.joint_q_init = torch.as_tensor(self.model.joint_q_init,
                                            device=self.device)
        self.joint_qd_init = torch.as_tensor(self.model.joint_qd_init,
                                             device=self.device)

    def build_model(self):
        builder = ModelBuilder()
        urdf_load(
            builder,
            os.path.join(_ASSETS, "cartpole.urdf"),
            np_transform(
                (0.0, 2.5, 0.0),
                np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5),
            ),
            floating=False,
            shape_kd=1.0e4,
            limit_kd=1.0,
        )
        builder.joint_q[1] = -math.pi  # pole starts hanging down
        model = builder.finalize()
        return dataclasses.replace(
            model, ground=False,
            gravity=np.array([0.0, -9.81, 0.0], np.float32))

    def action_to_controls(self, actions):
        joint_act = torch.cat(
            [actions[:, 0:1] * self.action_strength,
             actions.new_zeros((actions.shape[0], self.model.dof_count - 1))],
            dim=-1)
        return joint_act, None

    def observations(self, joint_q, joint_qd, actions):
        x, theta = joint_q[:, 0], joint_q[:, 1]
        xdot, theta_dot = joint_qd[:, 0], joint_qd[:, 1]
        return torch.stack([x, xdot, torch.sin(theta), torch.cos(theta),
                            theta_dot], dim=-1)

    def reward(self, obs, actions):
        x, xdot, theta_dot = obs[:, 0], obs[:, 1], obs[:, 4]
        theta = torch.atan2(obs[:, 2], obs[:, 3])  # the angle in (-pi, pi]
        return (
            -(theta ** 2) * self.pole_angle_penalty
            - (theta_dot ** 2) * self.pole_velocity_penalty
            - (x ** 2) * self.cart_position_penalty
            - (xdot ** 2) * self.cart_velocity_penalty
            - torch.sum(actions ** 2, dim=-1) * self.cart_action_penalty
        )

    def initial_state(self, n):
        """n start states: the model's, or with ``stochastic_init`` the
        reference's perturbation drawn from ``self.generator`` (coordinates
        +-pi/2, velocities +-0.25)."""
        C, D = self.model.coord_count, self.model.dof_count
        q0 = self.joint_q_init.expand(n, C).clone()
        qd0 = self.joint_qd_init.expand(n, D).clone()
        if self.stochastic_init:
            q0 = q0 + math.pi * (torch.rand(
                (n, C), generator=self.generator, device=self.device) - 0.5)
            qd0 = qd0 + 0.5 * (torch.rand(
                (n, D), generator=self.generator, device=self.device) - 0.5)
        return q0, qd0

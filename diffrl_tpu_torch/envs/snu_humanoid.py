"""SNU lower-body humanoid driven by muscle-tendon units (port of
diffrl_tpu/envs/snu_humanoid.py).

The SNU/MASS skeleton cut to the pelvis and legs: a free pelvis, 4 ball
joints (hips and ankles) and 6 hinges; 11 links, 29 coordinates, 24 dofs,
88 ground contacts, 48 substeps per env step. Each of the 152 muscles of
``muscle284.xml`` that anchors only on kept bones is one action: an
activation in [0, 1] times its strength. ``mtu_actuations=False`` is the
torque variant (one action per joint dof).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..ops import quat_conjugate, quat_from_angle_axis, quat_mul, \
    safe_normalize
from ..sim.importers.snu import SnuGains, load_snu
from ..sim.model import ModelBuilder, np_quat_from_axis_angle
from .base import DiffEnv
from .locomotion import torso_observations

_ASSETS = os.path.join(os.path.dirname(__file__), "assets", "snu")

_FILTER = {
    "Pelvis", "FemurR", "TibiaR", "TalusR", "FootThumbR", "FootPinkyR",
    "FemurL", "TibiaL", "TalusL", "FootThumbL", "FootPinkyL",
}


class SNUHumanoidEnv(DiffEnv):
    dt = 1.0 / 60.0
    sim_substeps = 48

    # bones kept from the full skeleton; a subclass may keep fewer (the
    # tests' 3-bone variant runs the same ball-joint and muscle code)
    body_filter = _FILTER

    termination_height = 0.46
    termination_tolerance = 0.05
    height_rew_scale = 4.0
    action_strength = 100.0
    action_penalty = -0.001
    joint_vel_obs_scaling = 0.1
    str_scale = 0.6
    start_height = 1.0

    def __init__(self, num_envs=4096, seed=0, episode_length=1000,
                 stochastic_init=False, MM_caching_frequency=1,
                 early_termination=True, mtu_actuations=True, device=None, **kw):
        self.mtu_actuations = mtu_actuations
        super().__init__(
            num_envs=num_envs, seed=seed, episode_length=episode_length,
            stochastic_init=stochastic_init,
            MM_caching_frequency=MM_caching_frequency,
            early_termination=early_termination, device=device,
            **kw,
        )
        C, D = self.model.coord_count, self.model.dof_count
        self.num_acts = (self.model.topology.muscle_count if mtu_actuations
                         else D - 6)
        # 11 torso entries, the joint coordinates and scaled joint
        # velocities past the free pelvis, up and heading (the actions too
        # in the torque variant): 53 for the lower body with muscles
        self._up = 11 + (C - 7) + (D - 6)
        self.num_obs = self._up + 2 + (0 if mtu_actuations else self.num_acts)
        dev = self.device
        self.start_rotation = torch.as_tensor(
            np_quat_from_axis_angle((0.0, 1.0, 0.0), math.pi * 0.5),
            dtype=torch.float32, device=dev)
        self.inv_start_rot = quat_conjugate(self.start_rotation)
        self.start_pos = torch.tensor([0.0, self.start_height, 0.0],
                                      device=dev)
        self.targets = torch.tensor([10000.0, 0.0, 0.0], device=dev)
        # the reference scales each muscle's peak force by str_scale twice
        # (kept for parity)
        self.muscle_strengths = torch.tensor(
            [self.str_scale * self.str_scale * m.muscle_strength
             for m in self.skeleton.muscles], dtype=torch.float32,
            device=dev)
        self.joint_q_init = torch.as_tensor(self.model.joint_q_init,
                                            device=dev)

    def build_model(self):
        builder = ModelBuilder()
        self.skeleton = load_snu(
            os.path.join(_ASSETS, "human.xml"),
            os.path.join(_ASSETS, "muscle284.xml") if self.mtu_actuations
            else None,
            builder,
            include=self.body_filter,
            gains=SnuGains(
                joint_stiffness=5.0,
                joint_damping=2.0,
                joint_armature=0.05,
                limit_ke=1.0e3,
                limit_kd=1.0e1,
                shape_ke=5.0e3,
                shape_kd=2.0e3,
                shape_kf=1.0e3,
                shape_mu=0.5,
            ),
        )
        builder.joint_q[0:3] = [0.0, self.start_height, 0.0]
        builder.joint_q[3:7] = list(
            np_quat_from_axis_angle((0.0, 1.0, 0.0), math.pi * 0.5))
        model = builder.finalize()
        return dataclasses.replace(
            model, ground=True,
            gravity=np.array([0.0, -9.81, 0.0], np.float32))

    def action_to_controls(self, actions):
        if self.mtu_actuations:
            # [-1, 1] -> an activation in [0, 1] times the strength
            return None, (actions * 0.5 + 0.5) * self.muscle_strengths
        joint_act = torch.cat(
            [actions.new_zeros((actions.shape[0], 6)),
             actions * self.action_strength], dim=-1)
        return joint_act, None

    def observations(self, joint_q, joint_qd, actions):
        torso_pos, torso_rot, lin_vel, ang_vel, up_y, heading = \
            torso_observations(joint_q, joint_qd, self.inv_start_rot,
                               self.targets, self.start_pos)
        parts = [
            torso_pos[:, 1:2],                                # 0
            torso_rot,                                        # 1:5
            lin_vel,                                          # 5:8
            ang_vel,                                          # 8:11
            joint_q[:, 7:],                                   # 11:33
            self.joint_vel_obs_scaling * joint_qd[:, 6:],     # 33:51
            up_y[:, None],                                    # 51
            heading[:, None],                                 # 52
        ]
        if not self.mtu_actuations:
            parts.append(actions)
        return torch.cat(parts, dim=-1)

    def reward(self, obs, actions):
        # the JAX env reads up and heading at 51 and 52, their places in
        # the lower body's observation; here they come from the model's
        # sizes (the same places for the lower body). As in the reference,
        # no height reward enters the sum.
        up_reward = 0.1 * obs[:, self._up]
        heading_reward = obs[:, self._up + 1]
        progress_reward = obs[:, 5]
        act_penalty = torch.sum(torch.abs(actions), dim=-1) \
            * self.action_penalty
        return progress_reward + up_reward + heading_reward + act_penalty

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
        return True

    def initial_state(self, n):
        """n start states: the model's coordinates and zero velocities, or
        with ``stochastic_init`` the reference's perturbation drawn from
        ``self.generator`` (pelvis position +-0.1, a rotation of up to
        pi/24 about a random axis, velocities +-0.25; the joint
        coordinates, quaternions among them, stay)."""
        C, D = self.model.coord_count, self.model.dof_count
        q0 = self.joint_q_init.expand(n, C)
        qd0 = torch.zeros((n, D), device=self.device)
        if not self.stochastic_init:
            return q0.clone(), qd0

        def uniform(*shape):
            return torch.rand(shape, generator=self.generator,
                              device=self.device)

        pos = q0[:, 0:3] + 0.1 * (uniform(n, 3) - 0.5) * 2.0
        angle = (uniform(n) - 0.5) * math.pi / 12.0
        axis = safe_normalize(uniform(n, 3) - 0.5)
        rot = quat_mul(q0[:, 3:7], quat_from_angle_axis(angle, axis))
        q0 = torch.cat([pos, rot, q0[:, 7:]], dim=-1)
        qd0 = 0.5 * (uniform(n, D) - 0.5)
        return q0, qd0

"""Shared observation and start-state machinery for free-base locomotion
envs, Ant and Humanoid (port of diffrl_tpu/envs/locomotion.py, batched over
envs)."""

from __future__ import annotations

import math

import torch

from ..ops import quat_from_angle_axis, quat_mul, quat_rotate, safe_normalize


def torso_observations(joint_q, joint_qd, inv_start_rot, targets, start_pos):
    """joint_q [E, C], joint_qd [E, D] -> (torso_pos [E, 3], torso_rot
    [E, 4], lin_vel [E, 3], ang_vel [E, 3], up_vec_y [E], heading_proj [E]).

    lin_vel converts the spatial twist's linear part to the world-frame
    velocity of the body origin.
    """
    torso_pos = joint_q[:, 0:3]
    torso_rot = joint_q[:, 3:7]
    lin_vel = joint_qd[:, 3:6]
    ang_vel = joint_qd[:, 0:3]

    lin_vel = lin_vel - torch.linalg.cross(torso_pos, ang_vel, dim=-1)

    to_target = targets + start_pos - torso_pos
    to_target = torch.stack(
        [to_target[:, 0], torch.zeros_like(to_target[:, 1]), to_target[:, 2]],
        dim=-1)
    target_dirs = safe_normalize(to_target)

    torso_quat = quat_mul(torso_rot, inv_start_rot.expand_as(torso_rot))
    # basis vectors made on the device (a host list would be a synchronizing
    # copy on every call)
    basis = torch.eye(3, dtype=torso_quat.dtype, device=torso_quat.device)
    up_vec = quat_rotate(torso_quat, basis[1])
    heading_vec = quat_rotate(torso_quat, basis[0])
    heading_proj = torch.sum(heading_vec * target_dirs, dim=-1)

    return torso_pos, torso_rot, lin_vel, ang_vel, up_vec[:, 1], heading_proj


def free_base_observations(env, joint_q, joint_qd, actions):
    """The Ant and Humanoid observation [E, 11 + (C - 7) + (D - 6) + 2 + A]:
    torso height, rotation, linear and angular velocity; joint angles; joint
    velocities times ``env.joint_vel_obs_scaling``; the up and heading
    projections; the actions."""
    torso_pos, torso_rot, lin_vel, ang_vel, up_y, heading = \
        torso_observations(joint_q, joint_qd, env.inv_start_rot, env.targets,
                           env.start_pos)
    return torch.cat(
        [
            torso_pos[:, 1:2],
            torso_rot,
            lin_vel,
            ang_vel,
            joint_q[:, 7:],
            env.joint_vel_obs_scaling * joint_qd[:, 6:],
            up_y[:, None],
            heading[:, None],
            actions,
        ],
        dim=-1,
    )


def free_base_initial_state(env, n):
    """n start states of a free-base env: ``env.joint_q_init`` and zero
    velocities, or with ``env.stochastic_init`` the reference's perturbation
    drawn from ``env.generator`` (position +-0.1, a rotation of up to
    pi/24 about a random axis, joint angles +-0.2, velocities +-0.25)."""
    C, D = env.model.coord_count, env.model.dof_count
    q0 = env.joint_q_init.expand(n, C)
    qd0 = torch.zeros((n, D), device=env.device)
    if not env.stochastic_init:
        return q0.clone(), qd0

    def uniform(*shape):
        return torch.rand(shape, generator=env.generator, device=env.device)

    pos = q0[:, 0:3] + 0.1 * (uniform(n, 3) - 0.5) * 2.0
    angle = (uniform(n) - 0.5) * math.pi / 12.0
    axis = safe_normalize(uniform(n, 3) - 0.5)
    rot = quat_mul(q0[:, 3:7], quat_from_angle_axis(angle, axis))
    joints = q0[:, 7:] + 0.2 * (uniform(n, C - 7) - 0.5) * 2.0
    q0 = torch.cat([pos, rot, joints], dim=-1)
    qd0 = 0.5 * (uniform(n, D) - 0.5)
    return q0, qd0

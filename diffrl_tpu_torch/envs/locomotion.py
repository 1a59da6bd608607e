"""Shared observation machinery for free-base locomotion envs (port of
diffrl_tpu/envs/locomotion.py, batched over envs)."""

from __future__ import annotations

import torch

from ..ops import quat_mul, quat_rotate, safe_normalize


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

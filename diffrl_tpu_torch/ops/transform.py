"""Rigid transforms as flat 7-vectors ``[px, py, pz, qx, qy, qz, qw]`` (port
of diffrl_tpu/ops/transform.py); every function broadcasts over leading
batch dimensions."""

from __future__ import annotations

import torch

from .quat import _f32, quat_inverse, quat_mul, quat_rotate


def transform(p, q):
    p, q = _f32(p), _f32(q)
    p, _ = torch.broadcast_tensors(p, q[..., :3])
    return torch.cat([p, q], dim=-1)


def transform_identity(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                        device=device)


def transform_get_translation(t):
    return t[..., 0:3]


def transform_get_rotation(t):
    return t[..., 3:7]


def transform_multiply(t, u):
    """Compose: result = t * u."""
    p = quat_rotate(t[..., 3:7], u[..., 0:3]) + t[..., 0:3]
    q = quat_mul(t[..., 3:7], u[..., 3:7])
    return torch.cat([p, q], dim=-1)


def transform_inverse(t):
    q_inv = quat_inverse(t[..., 3:7])
    p = -quat_rotate(q_inv, t[..., 0:3])
    return torch.cat([p, q_inv], dim=-1)


def transform_point(t, x):
    """Transform a point: p + R x."""
    return t[..., 0:3] + quat_rotate(t[..., 3:7], x)


def transform_vector(t, x):
    """Rotate a vector (no translation)."""
    return quat_rotate(t[..., 3:7], x)

"""Quaternion operations on tensors (port of diffrl_tpu/ops/quat.py).

Quaternions are stored ``[x, y, z, w]`` (imaginary part first), and every
function broadcasts over leading batch dimensions: a "quat" is a tensor whose
last axis has size 4, a "vec3" one whose last axis has size 3.
"""

from __future__ import annotations

import torch

_EPS = 1.0e-6


def quat_from_angle_axis(angle, axis):
    """Unit quaternion from an angle and an axis (assumed normalized)."""
    half = angle * 0.5
    return torch.cat(
        [axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_mul(a, b):
    """Hamilton product, (x, y, z, w) layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + bw * ax + ay * bz - by * az,
            aw * by + bw * ay + az * bx - bz * ax,
            aw * bz + bw * az + ax * by - bx * ay,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([-q[..., 0:3], q[..., 3:4]], dim=-1)


def quat_rotate(q, v):
    """Rotate vec3 ``v`` by quaternion ``q``."""
    qv = q[..., 0:3]
    w = q[..., 3:4]
    return (
        v * (2.0 * w * w - 1.0)
        + torch.linalg.cross(qv, v.expand_as(qv)) * w * 2.0
        + qv * torch.sum(qv * v, dim=-1, keepdim=True) * 2.0
    )


def safe_normalize(v, eps=_EPS):
    """v / |v|, and 0 where |v| <= eps (the reference's guarded normalize)."""
    l2 = torch.sum(v * v, dim=-1, keepdim=True)
    safe = l2 > eps * eps
    inv = torch.where(
        safe, 1.0 / torch.sqrt(torch.where(safe, l2, torch.ones_like(l2))),
        torch.zeros_like(l2))
    return v * inv

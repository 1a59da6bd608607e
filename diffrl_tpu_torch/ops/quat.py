"""Quaternion operations on tensors (port of diffrl_tpu/ops/quat.py).

Quaternions are stored ``[x, y, z, w]`` (imaginary part first), and every
function broadcasts over leading batch dimensions: a "quat" is a tensor whose
last axis has size 4, a "vec3" one whose last axis has size 3. Where the
reference guards a primal (``normalize`` returning identity for tiny norms)
both the value and a finite gradient are kept with the double-``where``
pattern.
"""

from __future__ import annotations

import torch

_EPS = 1.0e-6


def _f32(x):
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float32)


def cross(a, b):
    """a x b over the last axis, the batch axes broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat(x, y, z, w):
    return torch.stack(torch.broadcast_tensors(*map(_f32, (x, y, z, w))),
                       dim=-1)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion from an (unnormalized) axis and an angle."""
    axis, angle = _f32(axis), _f32(angle)
    half = angle * 0.5
    return torch.cat(
        [axis * torch.sin(half)[..., None], torch.cos(half)[..., None]],
        dim=-1)


def quat_from_angle_axis(angle, axis):
    """Unit quaternion from an angle and an axis (assumed normalized)."""
    return quat_from_axis_angle(axis, angle)


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


# the reference calls conjugation "inverse" (unit quaternions assumed)
quat_inverse = quat_conjugate


def quat_rotate(q, v):
    """Rotate vec3 ``v`` by quaternion ``q``."""
    qv = q[..., 0:3]
    w = q[..., 3:4]
    return (
        v * (2.0 * w * w - 1.0)
        + cross(qv, v) * w * 2.0
        + qv * torch.sum(qv * v, dim=-1, keepdim=True) * 2.0
    )


def quat_rotate_inv(q, v):
    """Rotate by the inverse rotation."""
    qv = q[..., 0:3]
    w = q[..., 3:4]
    return (
        v * (2.0 * w * w - 1.0)
        - cross(qv, v) * w * 2.0
        + qv * torch.sum(qv * v, dim=-1, keepdim=True) * 2.0
    )


def quat_normalize(q):
    """Normalize with the reference's tiny-norm guard: identity where
    |q| <= eps, with a zero gradient there instead of NaN."""
    l2 = torch.sum(q * q, dim=-1, keepdim=True)
    safe = l2 > _EPS * _EPS
    l = torch.sqrt(torch.where(safe, l2, torch.ones_like(l2)))
    # the identity made on the device (a host list would be a copy per call)
    ident = torch.zeros_like(q)
    ident[..., 3] = 1.0
    return torch.where(safe, q / l, ident)


def quat_to_matrix(q):
    """3x3 rotation matrix whose columns are the rotated basis vectors."""
    basis = torch.eye(3, dtype=q.dtype, device=q.device)
    return torch.stack([quat_rotate(q, basis[k]) for k in range(3)], dim=-1)

"""6D spatial algebra on tensors (port of diffrl_tpu/ops/spatial.py).

Spatial vectors are flat 6-vectors ``[w(3), v(3)]``, angular on top;
spatial matrices are 6x6. Every function broadcasts over leading batch
dimensions.
"""

from __future__ import annotations

import torch

from .quat import _EPS, cross, quat_rotate
from .transform import transform_inverse


def spatial_vector(w, v):
    return torch.cat(torch.broadcast_tensors(w, v), dim=-1)


def spatial_top(a):
    return a[..., 0:3]


def spatial_bottom(a):
    return a[..., 3:6]


def spatial_dot(a, b):
    return torch.sum(a * b, dim=-1)


def spatial_cross(a, b):
    """Motion x motion cross product."""
    w = cross(a[..., 0:3], b[..., 0:3])
    v = cross(a[..., 3:6], b[..., 0:3]) + cross(a[..., 0:3], b[..., 3:6])
    return torch.cat([w, v], dim=-1)


def spatial_cross_dual(a, b):
    """Motion x* force cross product."""
    w = cross(a[..., 0:3], b[..., 0:3]) + cross(a[..., 3:6], b[..., 3:6])
    v = cross(a[..., 0:3], b[..., 3:6])
    return torch.cat([w, v], dim=-1)


def spatial_transform_twist(t, x):
    """Change of frame for a twist."""
    q = t[..., 3:7]
    p = t[..., 0:3]
    w = quat_rotate(q, x[..., 0:3])
    v = quat_rotate(q, x[..., 3:6]) + cross(p, w)
    return torch.cat([w, v], dim=-1)


def spatial_transform_wrench(t, x):
    """Change of frame for a wrench."""
    q = t[..., 3:7]
    p = t[..., 0:3]
    v = quat_rotate(q, x[..., 3:6])
    w = quat_rotate(q, x[..., 0:3]) + cross(p, v)
    return torch.cat([w, v], dim=-1)


def skew(v):
    """Skew-symmetric cross-product matrix of vec3."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def spatial_adjoint(R, S):
    """6x6 adjoint ``[[R, 0], [S, R]]`` from the rotation block R and the
    lower-left block S."""
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([S, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spatial_transform_inertia(t, I):
    """A body-frame spatial inertia in the parent/space frame:
    ``T^T I T`` with ``T = Ad(t^-1)``, differentiable end to end."""
    t_inv = transform_inverse(t)
    q = t_inv[..., 3:7]
    p = t_inv[..., 0:3]
    basis = torch.eye(3, dtype=t.dtype, device=t.device)
    R = torch.stack([quat_rotate(q, basis[k]) for k in range(3)], dim=-1)
    S = torch.matmul(skew(p), R)
    T = spatial_adjoint(R, S)
    return torch.matmul(torch.matmul(T.transpose(-1, -2), I), T)


def spatial_inertia_matvec(t, I_m, x):
    """``spatial_transform_inertia(t, I_m) @ x`` without materializing the
    6x6 (I_m block-diagonal)."""
    u = spatial_transform_twist(transform_inverse(t), x)
    I3 = I_m[..., 0:3, 0:3]
    m = I_m[..., 3, 3]
    y = torch.cat(
        [torch.einsum("...ij,...j->...i", I3, u[..., 0:3]),
         m[..., None] * u[..., 3:6]], dim=-1)
    return spatial_transform_wrench(t, y)


def safe_normalize(v, eps=_EPS):
    """v / |v|, and 0 with a zero gradient where |v| <= eps (the reference's
    guarded normalize, double-where pattern)."""
    l2 = torch.sum(v * v, dim=-1, keepdim=True)
    safe = l2 > eps * eps
    inv = torch.where(
        safe, 1.0 / torch.sqrt(torch.where(safe, l2, torch.ones_like(l2))),
        torch.zeros_like(l2))
    return v * inv

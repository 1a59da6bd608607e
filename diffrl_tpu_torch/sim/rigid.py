"""Maximal-coordinate rigid bodies (port of diffrl_tpu/sim/rigid.py): per
body (x, r, v, w) state with semi-implicit integration and ground contacts,
batched over leading axes (bodies, or envs of bodies)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import quat_mul, quat_normalize, quat_rotate, quat_rotate_inv
from ..ops.quat import cross
from .articulation_lb import _fan, _gather, _scatter_sum


def integrate_rigids(x, r, v, w, f, t, inv_m, inv_I, gravity, dt):
    """Semi-implicit Euler in maximal coordinates. inv_I is the body-frame
    inverse inertia [..., 3, 3]; gravity acts only on dynamic bodies
    (nonzero inverse mass, a zero-gradient mask). Returns (x', r', v', w').
    """
    dynamic = (inv_m > 0.0).to(x.dtype)[..., None]

    v1 = v + (f * inv_m[..., None] + gravity * dynamic) * dt
    x1 = x + v1 * dt

    # rotate angular quantities into the body frame, integrate, rotate back
    wb = quat_rotate_inv(r, w)
    tb = quat_rotate_inv(r, t)
    w1 = quat_rotate(r, wb + torch.einsum("...ij,...j->...i", inv_I, tb)
                     * dt)
    dr = quat_mul(torch.cat([w1, torch.zeros_like(w1[..., :1])], dim=-1), r)
    r1 = quat_normalize(r + dr * 0.5 * dt)
    return x1, r1, v1, w1


def eval_rigid_contacts(x, r, v, w, contact_body, contact_point,
                        contact_dist, contact_mat):
    """Ground contacts of maximal-coordinate bodies: penalty normal +
    damping + box Coulomb friction. x/v/w [B, 3], r [B, 4]; contact_body
    [K] (host indices), contact_point [K, 3], contact_dist [K],
    contact_mat [K, 4] (ke, kd, kf, mu). Returns (force [B, 3], torque
    [B, 3]) summed per body in a fixed order."""
    B = x.shape[0]
    fan = _fan(np.asarray(torch.as_tensor(contact_body).cpu(), np.int64), B,
               x.device)

    def const(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    contact_point, contact_dist, contact_mat = map(
        const, (contact_point, contact_dist, contact_mat))
    xb, rb, vb, wb = (_gather(a, fan) for a in (x, r, v, w))
    n = x.new_tensor([0.0, 1.0, 0.0])

    ke, kd, kf, mu = contact_mat.unbind(-1)

    p = xb + quat_rotate(rb, contact_point) - n * contact_dist[:, None]
    arm = p - xb
    dpdt = vb + cross(wb, arm)

    zero = torch.zeros_like(ke)
    c = torch.minimum(torch.sum(n * p, dim=-1), zero)
    vn = torch.sum(n * dpdt, dim=-1)
    vt = dpdt - n * vn[:, None]

    fn = c * ke
    step_c = (c < 0.0).to(x.dtype)
    fd = torch.minimum(vn, zero) * kd * step_c

    lower = mu * (fn + fd)
    upper = -lower
    vx = torch.minimum(torch.maximum(kf * vt[:, 0], lower), upper)
    vz = torch.minimum(torch.maximum(kf * vt[:, 2], lower), upper)
    ft = torch.stack([vx, zero, vz], dim=-1) * step_c[:, None]

    f_total = n * (fn + fd)[:, None] + ft
    t_total = cross(arm, f_total)

    return _scatter_sum(-f_total, fan), _scatter_sum(-t_total, fan)

"""Particle / deformable dynamics: springs, cloth FEM, bending, tets, contacts
(port of diffrl_tpu/sim/particles.py).

Every function takes a leading env axis: positions and velocities are
[E, P, 3] tensors, and the Model's element tables are shared by all envs.
Each reference kernel (one thread per element, atomic adds into the force
buffer) is a gather -> vectorized math -> per-particle sum over the element
axis. The sums run in a fixed order (``articulation_lb._Fan``: padded
per-particle tables, left to right, also for the cotangents of the element
gathers, whose indices repeat), so the forces and their gradients are the
same bits run after run on the card. The hashed self-collision's candidate
indices change every substep; its sums go through ``index_put_`` with
``accumulate=True``, which on CUDA sorts the indices stably and adds each
destination's entries in order (the same holds for the cotangent of its
advanced-indexing gathers).

Gradient conventions match the reference adjoints: ``step``/``sign`` carry
zero gradient, ``min``/``max``/``clip`` pick the active branch (a tie splits
it, as in JAX), bending's ``acos`` is clamped away from |1|, and every
shape SDF branch is evaluated and combined with ``where`` behind guarded
norms (``_safe_len``, ``safe_normalize``) so a masked branch cannot put
0 * inf into the gradient.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import quat_rotate, safe_normalize, transform_inverse, \
    transform_multiply, transform_point
from ..ops.quat import _EPS, cross
from .articulation_lb import _Fan, _fan, _gather, _scatter_sum
from .model import Model

_CONTACT_RADIUS2 = 0.01          # self-collision: squared distance 0.1^2
_SELF_KE = 1.0e5                 # self-collision penalty stiffness


def _clip(x, lo, hi):
    """jnp.clip: the maximum with lo, then the minimum with hi (a tie splits
    the cotangent)."""
    lo = lo if torch.is_tensor(lo) else x.new_full((), lo)
    hi = hi if torch.is_tensor(hi) else x.new_full((), hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _take(x, fan: _Fan):
    """x[:, fan.idx] for x [E, P, ...]; the cotangent is summed per particle
    in a fixed order."""
    return _gather(x.transpose(0, 1), fan).transpose(0, 1)


def _sum_into(c, fan: _Fan):
    """Per-particle sums [E, P, ...] of element rows c [E, N, ...] by
    destination fan.idx, each left to right in row order."""
    return _scatter_sum(c.transpose(0, 1), fan).transpose(0, 1)


def _det3(a, b, c):
    """Determinant of the 3x3 matrices with columns a, b, c ([..., 3])."""
    return torch.sum(a * cross(b, c), dim=-1)


@dataclass(frozen=True, eq=False)
class _Consts:
    """Device tensors and fixed-order sum tables of one Model's particle
    family (one per Model, device and dtype)."""

    inv_mass: Optional[torch.Tensor]        # [P]
    gravity: torch.Tensor                   # [3]
    ground_n: torch.Tensor                  # [3], +y
    spring_fan: Optional[_Fan]              # over [i; j]
    spring_idx: Optional[torch.Tensor]      # [2, S]
    spring_rest: Optional[torch.Tensor]
    spring_ke: Optional[torch.Tensor]
    spring_kd: Optional[torch.Tensor]
    tri_fan: Optional[_Fan]                 # over [i; j; k]
    tri_idx: Optional[torch.Tensor]         # [3, T] int32
    tri_Dm: Optional[torch.Tensor]          # [T, 2, 2]
    tri_act: Optional[torch.Tensor]
    edge_fan: Optional[_Fan]                # over [i; j; k; l]
    edge_rest: Optional[torch.Tensor]
    tet_fan: Optional[_Fan]                 # over [i; j; k; l]
    tet_idx: Optional[torch.Tensor]         # [4, Q]
    tet_Dm: Optional[torch.Tensor]          # [Q, 3, 3]
    tet_act: Optional[torch.Tensor]
    tet_mat: Optional[torch.Tensor]         # [Q, 3]
    shape_transform: Optional[torch.Tensor]  # [G, 7]
    shape_has_body: Optional[torch.Tensor]  # [G, 1] bool
    shape_body_fan: Optional[_Fan]          # shape -> body (0 for static)
    shape_geo: Optional[torch.Tensor]       # [G, 1] int
    shape_scale: Optional[torch.Tensor]     # [G, 3]
    shape_mesh: Optional[torch.Tensor]      # [G, 1] bool: has a baked SDF
    sdf: tuple                              # per shape: (grid, lower, inv
    #                                         spacing) or None


_CONSTS: "weakref.WeakKeyDictionary[Model, Dict[tuple, _Consts]]" = (
    weakref.WeakKeyDictionary())


def _consts(model: Model, like: torch.Tensor) -> _Consts:
    key = (like.device, like.dtype)
    per_model = _CONSTS.setdefault(model, {})
    c = per_model.get(key)
    if c is None:
        c = per_model[key] = _build_consts(model, *key)
    return c


def _build_consts(model: Model, device, dtype) -> _Consts:
    P = model.particle_count

    def f(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=device).to(dtype)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def fan_of(idx):
        return None if idx is None else _fan(np.asarray(idx).T.reshape(-1),
                                             P, device)

    sdf = ()
    shape_fields = [None] * 6
    if model.shape_body is not None:
        body = np.asarray(model.shape_body, np.int64)
        geo = np.asarray(model.shape_geo_type, np.int64)
        sid = (np.full(len(body), -1) if model.shape_sdf_id is None
               else np.asarray(model.shape_sdf_id))
        # GEO_MESH shapes with a baked grid
        sdf = tuple((f(model.sdf_grid[s]), f(model.sdf_lower[s]),
                     1.0 / f(model.sdf_spacing[s]))
                    if g == 3 and s >= 0 else None
                    for g, s in zip(geo, sid))
        shape_fields = [
            f(model.shape_transform),
            torch.as_tensor(body[:, None] >= 0, device=device),
            _fan(np.maximum(body, 0), max(model.link_count, 1), device),
            i64(geo[:, None]),
            f(model.shape_geo_scale),
            torch.as_tensor(np.array([[x is not None] for x in sdf]),
                            device=device)]
    return _Consts(
        inv_mass=f(model.particle_inv_mass),
        gravity=f(model.gravity),
        ground_n=f([0.0, 1.0, 0.0]),
        spring_fan=fan_of(model.spring_indices),
        spring_idx=(None if model.spring_indices is None
                    else i64(np.asarray(model.spring_indices).T)),
        spring_rest=f(model.spring_rest_length),
        spring_ke=f(model.spring_stiffness),
        spring_kd=f(model.spring_damping),
        tri_fan=fan_of(model.tri_indices),
        tri_idx=(None if model.tri_indices is None else torch.as_tensor(
            np.asarray(model.tri_indices, np.int32).T.copy(), device=device)),
        tri_Dm=f(model.tri_poses),
        tri_act=f(model.tri_activations),
        edge_fan=fan_of(model.edge_indices),
        edge_rest=f(model.edge_rest_angle),
        tet_fan=fan_of(model.tet_indices),
        tet_idx=(None if model.tet_indices is None
                 else i64(np.asarray(model.tet_indices).T)),
        tet_Dm=f(model.tet_poses),
        tet_act=f(model.tet_activations),
        tet_mat=f(model.tet_materials),
        shape_transform=shape_fields[0],
        shape_has_body=shape_fields[1],
        shape_body_fan=shape_fields[2],
        shape_geo=shape_fields[3],
        shape_scale=shape_fields[4],
        shape_mesh=shape_fields[5],
        sdf=sdf,
    )


# ---------------------------------------------------------------------------
# force kernels (semi-implicit path)


def eval_springs(model, x, v):
    """Damped spring forces [E, P, 3]."""
    c = _consts(model, x)
    S = c.spring_rest.shape[0]
    xi, xj = _take(x, c.spring_fan).split(S, dim=1)
    vi, vj = _take(v, c.spring_fan).split(S, dim=1)
    xij = xi - xj
    vij = vi - vj

    l2 = torch.sum(xij * xij, dim=-1)
    l = torch.sqrt(torch.clamp(l2, min=1e-12))
    dir = xij / l[..., None]

    cc = l - c.spring_rest
    dcdt = torch.sum(dir * vij, dim=-1)

    fs = dir * (c.spring_ke * cc + c.spring_kd * dcdt)[..., None]
    return _sum_into(torch.cat([-fs, fs], dim=1), c.spring_fan)


def eval_triangles(model, x, v):
    """FEM triangle: neo-Hookean membrane + area preservation + lift/drag."""
    c = _consts(model, x)
    T = c.tri_Dm.shape[0]
    p, q, r = _take(x, c.tri_fan).split(T, dim=1)
    vp, vq, vr = _take(v, c.tri_fan).split(T, dim=1)

    qp = q - p
    rp = r - p

    Dm = c.tri_Dm
    inv_rest_area = (Dm[:, 0, 0] * Dm[:, 1, 1] - Dm[:, 0, 1] * Dm[:, 1, 0]) \
        * 2.0
    rest_area = 1.0 / inv_rest_area

    k_mu = model.tri_ke * rest_area
    k_lambda = model.tri_ka * rest_area
    k_damp = model.tri_kd * rest_area

    # deformation gradient columns F = Xs * Dm
    f1 = qp * Dm[:, 0, 0, None] + rp * Dm[:, 1, 0, None]
    f2 = qp * Dm[:, 0, 1, None] + rp * Dm[:, 1, 1, None]

    # neo-Hookean deviatoric part: force = mu * F * Dm^T
    fq = (f1 * Dm[:, 0, 0, None] + f2 * Dm[:, 0, 1, None]) * k_mu[:, None]
    fr = (f1 * Dm[:, 1, 0, None] + f2 * Dm[:, 1, 1, None]) * k_mu[:, None]
    alpha = 1.0 + model.tri_ke / model.tri_ka

    # area preservation
    n = cross(qp, rp)
    n_len = torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1), min=1e-24))
    area = n_len * 0.5

    cc = area * inv_rest_area - alpha + c.tri_act
    n_hat = n / n_len[..., None]
    dcdq = cross(rp, n_hat) * (inv_rest_area * 0.5)[:, None]
    dcdr = cross(n_hat, qp) * (inv_rest_area * 0.5)[:, None]

    f_area = k_lambda * cc

    # area damping
    dcdt = (
        torch.sum(dcdq * vq, dim=-1)
        + torch.sum(dcdr * vr, dim=-1)
        - torch.sum((dcdq + dcdr) * vp, dim=-1)
    )
    f_damp = k_damp * dcdt

    fq = fq + dcdq * (f_area + f_damp)[..., None]
    fr = fr + dcdr * (f_area + f_damp)[..., None]
    fp = fq + fr

    # lift + drag cloth aerodynamics
    if model.tri_drag > 0.0 or model.tri_lift > 0.0:
        vmid = (vp + vr + vq) * 0.3333
        vdir = safe_normalize(vmid)
        ndotv = torch.sum(n_hat * vmid, dim=-1)
        f_drag = vmid * (model.tri_drag * area * torch.abs(ndotv))[..., None]
        cosang = _clip(torch.sum(n_hat * vdir, dim=-1), -1.0 + 1e-6,
                       1.0 - 1e-6)
        f_lift = (
            n_hat
            * (model.tri_lift * area * (1.57079 - torch.arccos(cosang)))[
                ..., None]
            * torch.sum(vmid * vmid, dim=-1)[..., None]
        )
        fp = fp - f_drag - f_lift
        fq = fq + f_drag + f_lift
        fr = fr + f_drag + f_lift

    return _sum_into(torch.cat([fp, -fq, -fr], dim=1), c.tri_fan)


def _dot(u, v):
    """u . v of vectors given as their 3 components."""
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _closest_bary(a, b, c, p):
    """The barycentric coordinates [u, v, w] of the point of triangle (abc)
    closest to p, every vector given as its 3 components (broadcastable
    tensors): a branchless where-cascade over the 7 Voronoi regions, each
    coordinate selected on its own."""
    ab = [y - x for x, y in zip(a, b)]
    ac = [y - x for x, y in zip(a, c)]
    ap = [y - x for x, y in zip(a, p)]

    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)

    bp = [y - x for x, y in zip(b, p)]
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)

    cp = [y - x for x, y in zip(c, p)]
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    # where's scalar branches stand for the JAX package's zeros_like /
    # ones_like arrays (the same values and cotangents, no allocation)
    def safe_div(n, d):
        return n / torch.where(torch.abs(d) > 1e-12, d, 1.0)

    d43 = d4 - d3
    d56 = d5 - d6
    v_ab = safe_div(d1, d1 - d3)
    w_ac = safe_div(d2, d2 - d6)
    w_bc = safe_div(d43, d43 + d56)
    denom = safe_div(1.0, va + vb + vc)
    v_in = vb * denom
    w_in = vc * denom

    out = [1.0 - v_in - w_in, v_in, w_in]
    for cond, bary in (
            ((va <= 0.0) & (d43 >= 0.0) & (d56 >= 0.0),
             (0.0, w_bc, 1.0 - w_bc)),
            ((vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0),
             (1.0 - w_ac, 0.0, w_ac)),
            ((d6 >= 0.0) & (d5 <= d6), (0.0, 0.0, 1.0)),
            ((vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0),
             (1.0 - v_ab, v_ab, 0.0)),
            ((d3 >= 0.0) & (d4 <= d3), (0.0, 1.0, 0.0)),
            ((d1 <= 0.0) & (d2 <= 0.0), (1.0, 0.0, 0.0))):
        out = [torch.where(cond, b_, o) for b_, o in zip(bary, out)]
    return out


def triangle_closest_point_barycentric(a, b, c, p):
    """Closest point on triangle (abc) to p ([..., 3] each), as barycentric
    coordinates [..., 3]."""
    return torch.stack(_closest_bary(a.unbind(-1), b.unbind(-1),
                                     c.unbind(-1), p.unbind(-1)), dim=-1)


def _self_contact(p, q, r, pos, inactive):
    """The self-collision penalty of triangles with vertices p, q, r on the
    points pos, all given as their 3 components ([E, T, 1] and [E, T, K]
    tensors: the self-collision's pair arrays stay contiguous per component,
    so every dot product is elementwise); ``inactive`` [.., T, K] masks
    pairs out. Returns (fn, the force on each point, as 3 components
    [E, T, K]; the per-vertex sums [E, 3T, 3] in the triangle fan's
    order)."""
    u = _closest_bary(p, q, r, pos)
    diff = [s - (pa * u[0] + qa * u[1] + ra * u[2])
            for s, pa, qa, ra in zip(pos, p, q, r)]
    dist = _dot(diff, diff)
    # safe_normalize(diff), its squared length being dist
    safe = dist > _EPS * _EPS
    inv = torch.where(safe, 1.0 / torch.sqrt(torch.where(safe, dist, 1.0)),
                      0.0)
    c = torch.minimum(dist - _CONTACT_RADIUS2, dist.new_zeros(()))
    c = torch.where(inactive, 0.0, c)

    fn = [d * inv * c * _SELF_KE for d in diff]
    f_ijk = torch.cat([torch.stack([torch.sum(f * w, dim=2) for f in fn],
                                   dim=-1) for w in u], dim=1)
    return fn, f_ijk


def _vertices(x, c):
    """The triangles' vertices p, q, r of x [E, P, 3], each as 3 components
    [E, T, 1]."""
    T = c.tri_Dm.shape[0]
    return [[t[..., d, None] for d in range(3)]
            for t in _take(x, c.tri_fan).split(T, dim=1)]


def eval_triangles_contact(model, x, v):
    """All-pairs particle-vs-triangle penalty contact, O(T * P) like the
    reference."""
    c = _consts(model, x)
    P = x.shape[1]
    p, q, r = _vertices(x, c)
    pos = [x[:, None, :, d] for d in range(3)]               # [E, 1, P]

    # skip a particle against its own triangle (the reference early-returns)
    pid = torch.arange(P, device=x.device)
    i, j, k = c.tri_idx
    own = (i[:, None] == pid) | (j[:, None] == pid) | (k[:, None] == pid)

    fn, f_ijk = _self_contact(p, q, r, pos, own)
    return (-torch.stack([torch.sum(f, dim=1) for f in fn], dim=-1)
            + _sum_into(f_ijk, c.tri_fan))


def _hash_cells(cells, num_buckets):
    """FNV-style spatial hash of integer cell coords [..., 3] -> [...]: the
    int32 products and their XOR wrap to signed 32 bits as in XLA
    (computed in int64 and folded), then the floor-mod by the bucket
    count."""
    c = cells.to(torch.int64)
    h = (c[..., 0] * 73856093) ^ (c[..., 1] * 19349663) ^ \
        (c[..., 2] * 83492791)
    h = torch.remainder(h + 2 ** 31, 2 ** 32) - 2 ** 31
    return torch.remainder(h, num_buckets)


def _cells(x, inv_h):
    return torch.floor(x * inv_h).to(torch.int32)


def hash_table(model, x):
    """The particle hash table [E, B, C] of the hashed self-collision
    (sentinel P), and the bucket [E, P] and slot [E, P] of every particle:
    particles sorted stably by bucket take the slots 0, 1, ... of their
    bucket, and a particle whose slot is >= capacity is dropped."""
    E, P = x.shape[0], x.shape[1]
    B = model.tri_collision_buckets
    C = model.tri_collision_capacity
    hp = _hash_cells(_cells(x, 1.0 / model.tri_collision_cell_size), B)
    order = torch.argsort(hp, dim=1, stable=True)
    hs = torch.gather(hp, 1, order)
    slot = torch.arange(P, device=x.device) - torch.searchsorted(
        hs, hs, right=False)
    # the dropped particles write to a spare column that is cut off
    dest = (torch.arange(E, device=x.device)[:, None] * B + hs) * (C + 1) \
        + torch.clamp(slot, max=C)
    table = torch.full((E * B * (C + 1),), P, dtype=torch.int64,
                       device=x.device)
    table[dest.reshape(-1)] = order.reshape(-1)
    bucket = torch.empty_like(hp).scatter_(1, order, hs)
    slot_of = torch.empty_like(hp).scatter_(1, order, slot)
    return table.reshape(E, B, C + 1)[..., :C], bucket, slot_of


def eval_triangles_contact_hashed(model, x, v):
    """Spatial-hash broad-phase cloth self-collision.

    Beyond the reference, which ships only the O(T * P) all-pairs kernel:
    particles are binned into a fixed-capacity hash table [B, C] and each
    triangle is tested only against the 27 cells around its centroid,
    O(T * 27 * C) pair tests. Hash-colliding duplicate cells are masked so
    no pair is counted twice. Exact (equal to all-pairs) whenever
    ``tri_collision_cell_size >= 0.1 + max centroid-to-vertex distance``
    and no bucket overflows; an overflowing bucket drops its particles past
    the capacity silently, as in the JAX package.

    Each particle is written to its (bucket, slot) of the table (xtab
    [E, B + 1, C, 3], the last row a zero sentinel), which is gathered per
    triangle neighbour cell, and the pair tests run per component; the
    particle forces are summed per (bucket, slot) over the triangles'
    cells and read back by the particle in that slot. That sum and the
    cotangent of the per-cell gather go through
    index_put_(accumulate=True), which adds each destination's entries in
    index order on the CPU and in a stable sorted order on CUDA: the same
    bits run after run. Every other index is unique per destination: no
    slot, empty or not, is scattered into a shared sentinel (on CUDA the
    sorted accumulation adds one destination's entries in one warp, so a
    sentinel that took every empty slot serialized the whole table).
    """
    c = _consts(model, x)
    E, P = x.shape[0], x.shape[1]
    T = c.tri_Dm.shape[0]
    B = model.tri_collision_buckets
    C = model.tri_collision_capacity
    dev = x.device
    e_idx = torch.arange(E, device=dev)

    table, bucket, slot = hash_table(model, x)
    table_pad = torch.cat(
        [table, torch.full((E, 1, C), P, dtype=table.dtype, device=dev)],
        dim=1)                                                # [E, B+1, C]

    # --- candidates: 27 neighbour cells of each triangle centroid ---
    p, q, r = _vertices(x, c)
    cen = torch.stack([(a + b_ + c_)[..., 0] / 3.0
                       for a, b_, c_ in zip(p, q, r)], dim=-1)
    tcell = _cells(cen.detach(), 1.0 / model.tri_collision_cell_size)
    d = torch.arange(-1, 2, device=dev, dtype=torch.int32)
    offs = torch.stack(torch.meshgrid(d, d, d, indexing="ij"),
                       dim=-1).reshape(27, 3)
    nh = _hash_cells(tcell[:, :, None, :] + offs, B)          # [E, T, 27]
    # mask neighbour cells whose hash collides with an earlier neighbour
    eq = nh[..., :, None] == nh[..., None, :]
    earlier = torch.tril(torch.ones((27, 27), dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup = torch.any(eq & earlier, dim=-1)
    nh = torch.where(dup, torch.full_like(nh, B), nh)         # sentinel row

    # the table's particles [E, B + 1, C, 3], each written to its slot (the
    # dropped ones to a spare column that is cut off; the sentinel row B
    # stays 0), then per component, triangle and candidate [3, E, T, 27 C]
    ee = e_idx[:, None, None]
    ep = e_idx[:, None].expand(E, P)
    xtab = x.new_zeros((E, B + 1, C + 1, 3)).index_put(
        (ep, bucket, torch.clamp(slot, max=C)), x)[:, :, :C]
    pos = xtab.permute(3, 0, 1, 2)[:, ee, nh].reshape(3, E, T, 27 * C)
    cand = table_pad.to(torch.int32)[ee, nh].reshape(E, T, 27 * C)

    i, j, k = c.tri_idx
    own = ((i[:, None] == cand) | (j[:, None] == cand) |
           (k[:, None] == cand) | (cand >= P))
    fn, f_ijk = _self_contact(p, q, r, pos, own)

    # per (bucket, slot) over the triangles' cells, then read by the
    # particle in that slot (a dropped particle reads 0)
    fn = torch.stack(fn, dim=-1).reshape(E, T, 27, C, 3)
    acc = x.new_zeros((E, B + 1, C, 3)).index_put(
        (ee.expand_as(nh), nh), fn, accumulate=True)
    f_particle = torch.where((slot < C)[..., None],
                             acc[ep, bucket, torch.clamp(slot, max=C - 1)],
                             0.0)
    return -f_particle + _sum_into(f_ijk, c.tri_fan)


def eval_triangles_rigid_contacts(
    model, x, v, rigid_x, rigid_r, rigid_v, rigid_w,
    contact_body, contact_point, contact_dist, contact_mat,
):
    """Cloth-vs-rigid-body contact: each rigid contact point tests against
    every triangle; penalty normal + damping + box Coulomb friction applied
    to the triangle vertices barycentrically (the reference leaves the
    rigid-side reaction out; so does this). Rigid bodies in maximal
    coordinates, batched like x: rigid_x/v/w [E, Bd, 3], rigid_r [E, Bd, 4].
    contact_body [K] (host indices), contact_point [K, 3], contact_dist [K],
    contact_mat [K, 4] (ke, kd, kf, mu), shared by the envs.
    Returns the particle forces [E, P, 3]."""
    c = _consts(model, x)
    T = c.tri_Dm.shape[0]
    body = np.asarray(torch.as_tensor(contact_body).cpu(), np.int64)
    cfan = _fan(body, rigid_x.shape[1], x.device)

    def const(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    contact_point, contact_dist, contact_mat = map(
        const, (contact_point, contact_dist, contact_mat))
    xb, rb, vb, wb = (_take(a, cfan) for a in (rigid_x, rigid_r, rigid_v,
                                                rigid_w))
    ke, kd, kf, mu = contact_mat.unbind(-1)

    pos = xb + quat_rotate(rb, contact_point)                 # [E, K, 3]
    arm = pos - xb
    rhat = safe_normalize(arm)
    pos = pos + rhat * contact_dist[:, None]                  # shape thickness
    dpdt = vb + cross(wb, arm)                                # point velocity

    p, q, r = (t[:, :, None, :] for t in _take(x, c.tri_fan).split(T, dim=1))
    vp, vq, vr = (t[:, :, None, :] for t in _take(v, c.tri_fan).split(T,
                                                                    dim=1))
    pos_b = pos[:, None, :, :]                                # [E, 1, K, 3]

    bary = triangle_closest_point_barycentric(p, q, r, pos_b)  # [E, T, K, 3]
    closest = p * bary[..., 0:1] + q * bary[..., 1:2] + r * bary[..., 2:3]

    diff = pos_b - closest
    dist = torch.sum(diff * diff, dim=-1)
    n = safe_normalize(diff)                                  # into the body
    cc = torch.minimum(dist - 0.05, torch.zeros_like(dist))   # [E, T, K]

    fn = cc * ke                                              # normal (< 0)

    vtri = vp * bary[..., 0:1] + vq * bary[..., 1:2] + vr * bary[..., 2:3]
    vrel = vtri - dpdt[:, None, :, :]
    vn = torch.sum(n * vrel, dim=-1)
    vt = vrel - n * vn[..., None]

    step_c = (cc < 0.0).to(x.dtype)
    fd = -torch.maximum(vn, torch.zeros_like(vn)) * kd * step_c

    lower = mu * (fn + fd)
    upper = -lower

    basis = torch.eye(3, dtype=x.dtype, device=x.device)
    nx = cross(n, basis[2])
    nz = cross(n, basis[0])
    vx = _clip(torch.sum(nx * kf[:, None] * vt, dim=-1), lower, upper)
    vz = _clip(torch.sum(nz * kf[:, None] * vt, dim=-1), lower, upper)
    ft = (nx * vx[..., None] + nz * vz[..., None]) * (-step_c[..., None])

    f_total = n * (fn + fd)[..., None] + ft                   # [E, T, K, 3]
    f_ijk = torch.cat([torch.sum(f_total * bary[..., k:k + 1], dim=2)
                       for k in range(3)], dim=1)
    return _sum_into(f_ijk, c.tri_fan)


def eval_bending(model, x, v):
    """Discrete-hinge bending (Bridson)."""
    c = _consts(model, x)
    nb = c.edge_rest.shape[0]
    x1, x2, x3, x4 = _take(x, c.edge_fan).split(nb, dim=1)
    v1, v2, v3, v4 = _take(v, c.edge_fan).split(nb, dim=1)

    n1 = cross(x3 - x1, x4 - x1)
    n2 = cross(x4 - x2, x3 - x2)

    n1_len = torch.sqrt(torch.clamp(torch.sum(n1 * n1, dim=-1), min=1e-24))
    n2_len = torch.sqrt(torch.clamp(torch.sum(n2 * n2, dim=-1), min=1e-24))
    rcp_n1 = 1.0 / n1_len
    rcp_n2 = 1.0 / n2_len

    cos_theta = torch.sum(n1 * n2, dim=-1) * rcp_n1 * rcp_n2

    n1h = n1 * (rcp_n1 * rcp_n1)[..., None]
    n2h = n2 * (rcp_n2 * rcp_n2)[..., None]

    e = x4 - x3
    e_hat = safe_normalize(e)
    e_len = torch.sqrt(torch.clamp(torch.sum(e * e, dim=-1), min=1e-24))

    s = torch.sign(torch.sum(cross(n2, n1) * e_hat, dim=-1))
    # the clamp keeps d(acos)/dx finite at flat configurations
    angle = torch.arccos(_clip(cos_theta, -1.0 + 1e-6, 1.0 - 1e-6)) * s

    d1 = n1h * e_len[..., None]
    d2 = n2h * e_len[..., None]
    d3 = (n1h * torch.sum((x1 - x4) * e_hat, dim=-1)[..., None]
          + n2h * torch.sum((x2 - x4) * e_hat, dim=-1)[..., None])
    d4 = (n1h * torch.sum((x3 - x1) * e_hat, dim=-1)[..., None]
          + n2h * torch.sum((x3 - x2) * e_hat, dim=-1)[..., None])

    f_elastic = model.edge_ke * (angle - c.edge_rest)
    f_damp = model.edge_kd * (
        torch.sum(d1 * v1, dim=-1) + torch.sum(d2 * v2, dim=-1)
        + torch.sum(d3 * v3, dim=-1) + torch.sum(d4 * v4, dim=-1))
    f_total = (-e_len * (f_elastic + f_damp))[..., None]

    return _sum_into(torch.cat([d1 * f_total, d2 * f_total, d3 * f_total,
                                d4 * f_total], dim=1), c.edge_fan)


def _tet_rest(c):
    """(inverse rest volume, rest volume) of every tet [Q]: 6 det(Dm)."""
    Dm = c.tet_Dm
    inv_rest_volume = _det3(Dm[..., 0], Dm[..., 1], Dm[..., 2]) * 6.0
    return inv_rest_volume, 1.0 / inv_rest_volume


def eval_tetrahedra(model, x, v):
    """Stable neo-Hookean FEM tets (Smith 2018) + damping. Determinants are
    the 3x3 triple products (the JAX package takes an LU determinant: the
    same value up to float32 rounding, and the same derivative)."""
    c = _consts(model, x)
    Q = c.tet_Dm.shape[0]
    x0, x1, x2, x3 = _take(x, c.tet_fan).split(Q, dim=1)
    v0, v1, v2, v3 = _take(v, c.tet_fan).split(Q, dim=1)

    act = c.tet_act
    k_mu0, k_lambda0, k_damp0 = c.tet_mat.unbind(-1)

    x10, x20, x30 = x1 - x0, x2 - x0, x3 - x0
    v10, v20, v30 = v1 - v0, v2 - v0, v3 - v0

    Ds = torch.stack([x10, x20, x30], dim=-1)                 # [E, Q, 3, 3]
    Dm = c.tet_Dm

    inv_rest_volume, rest_volume = _tet_rest(c)

    alpha = 1.0 + k_mu0 / k_lambda0 - k_mu0 / (4.0 * k_lambda0)

    k_mu = k_mu0 * rest_volume
    k_lambda = k_lambda0 * rest_volume
    k_damp = k_damp0 * rest_volume

    F = Ds @ Dm
    dFdt = torch.stack([v10, v20, v30], dim=-1) @ Dm

    Ic = torch.sum(F * F, dim=(-2, -1))

    P_stress = F * (k_mu * (1.0 - 1.0 / (Ic + 1.0)))[..., None, None] \
        + dFdt * k_damp[:, None, None]
    H = P_stress @ Dm.transpose(-1, -2)

    f1 = H[..., 0]
    f2 = H[..., 1]
    f3 = H[..., 2]

    # hydrostatic part
    J = _det3(F[..., 0], F[..., 1], F[..., 2])
    s = (inv_rest_volume / 6.0)[:, None]
    dJdx1 = cross(x20, x30) * s
    dJdx2 = cross(x30, x10) * s
    dJdx3 = cross(x10, x20) * s

    f_volume = (J - alpha + act) * k_lambda
    f_damp = (torch.sum(dJdx1 * v1, dim=-1) + torch.sum(dJdx2 * v2, dim=-1)
              + torch.sum(dJdx3 * v3, dim=-1)) * k_damp
    f_total = (f_volume + f_damp)[..., None]

    f1 = f1 + dJdx1 * f_total
    f2 = f2 + dJdx2 * f_total
    f3 = f3 + dJdx3 * f_total
    f0 = -(f1 + f2 + f3)

    return _sum_into(torch.cat([-f0, -f1, -f2, -f3], dim=1), c.tet_fan)


def eval_ground_contacts(model, x, v):
    """Particle-vs-ground penalty contact with box Coulomb friction."""
    n = _consts(model, x).ground_n
    c = torch.minimum(torch.sum(n * x, dim=-1) - 0.01,
                      torch.zeros_like(x[..., 0]))

    vn = torch.sum(n * v, dim=-1)
    vt = v - n * vn[..., None]

    fn = n * (c * model.contact_ke)[..., None]
    fd = n * (torch.minimum(vn, torch.zeros_like(vn))
              * model.contact_kd)[..., None]

    lower = model.contact_mu * c * model.contact_ke  # <= 0
    upper = -lower

    vx = _clip(model.contact_kf * vt[..., 0], lower, upper)
    vz = _clip(model.contact_kf * vt[..., 2], lower, upper)
    ft = torch.stack([vx, torch.zeros_like(vx), vz], dim=-1)

    step_c = (c < 0.0).to(x.dtype)[..., None]   # step() has zero gradient
    return -(fn + (fd + ft) * step_c)


# ---------------------------------------------------------------------------
# shape SDFs + particle-vs-rigid soft contacts


def _safe_len(x):
    """|x| with a zero (not NaN) gradient at x == 0: every shape SDF branch
    is evaluated for every shape and combined with where, and sqrt's
    backward at 0 would turn a masked branch's cotangent into 0 * inf."""
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1), min=1e-24))


def sphere_sdf(radius, p):
    return _safe_len(p) - radius


def sphere_sdf_grad(radius, p):
    return safe_normalize(p)


def box_sdf(upper, p):
    """``upper`` = half extents."""
    q = torch.abs(p) - upper
    e = torch.maximum(q, torch.zeros_like(q))
    return _safe_len(e) + torch.minimum(torch.amax(q, dim=-1),
                                        torch.zeros_like(q[..., 0]))


def box_sdf_grad(upper, p):
    q = torch.abs(p) - upper
    outside = torch.any(q > 0.0, dim=-1)

    closest = _clip(p, -upper, upper)
    g_out = safe_normalize(p - closest)

    sgn = torch.sign(p)
    qx, qy, qz = q.unbind(-1)
    zero = torch.zeros_like(qx)
    g_in = torch.where(
        ((qx > qy) & (qx > qz))[..., None],
        torch.stack([sgn[..., 0], zero, zero], dim=-1),
        torch.where(
            ((qy > qx) & (qy > qz))[..., None],
            torch.stack([zero, sgn[..., 1], zero], dim=-1),
            torch.stack([zero, zero, sgn[..., 2]], dim=-1),
        ),
    )
    return torch.where(outside[..., None], g_out, g_in)


def mesh_sdf(grid, lower, inv_spacing, p):
    """Trilinear sample of a baked voxel SDF (model.bake_mesh_sdf).

    Beyond the reference, whose soft-contact kernel evaluates only
    sphere/box/capsule SDFs. grid [R, R, R]; lower/inv_spacing [3]; p
    [..., 3] in the shape's local frame. Queries outside the grid clamp to
    its (positive, padded) boundary."""
    R = grid.shape[0]
    u = _clip((p - lower) * inv_spacing, 0.0, R - 1 - 1e-4)
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0.to(u.dtype)
    i1 = torch.clamp(i0 + 1, max=R - 1)

    ix0, iy0, iz0 = i0.unbind(-1)
    ix1, iy1, iz1 = i1.unbind(-1)
    fx, fy, fz = f.unbind(-1)

    c00 = grid[ix0, iy0, iz0] * (1 - fx) + grid[ix1, iy0, iz0] * fx
    c10 = grid[ix0, iy1, iz0] * (1 - fx) + grid[ix1, iy1, iz0] * fx
    c01 = grid[ix0, iy0, iz1] * (1 - fx) + grid[ix1, iy0, iz1] * fx
    c11 = grid[ix0, iy1, iz1] * (1 - fx) + grid[ix1, iy1, iz1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def mesh_sdf_grad(grid, lower, inv_spacing, p):
    """Outward normal of a baked voxel SDF: central differences of the
    trilinear field at half-cell offsets, normalized."""
    h = 0.5 / inv_spacing
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    g = [mesh_sdf(grid, lower, inv_spacing, p + eye[k] * h[k])
         - mesh_sdf(grid, lower, inv_spacing, p - eye[k] * h[k])
         for k in range(3)]
    return safe_normalize(torch.stack(g, dim=-1))


def capsule_sdf(radius, half_width, p):
    """x-aligned capsule."""
    px = _clip(p[..., 0], -half_width, half_width)
    zero = torch.zeros_like(px)
    d = p - torch.stack([px, zero, zero], dim=-1)
    return _safe_len(d) - radius


def capsule_sdf_grad(radius, half_width, p):
    px = _clip(p[..., 0], -half_width, half_width)
    zero = torch.zeros_like(px)
    return safe_normalize(p - torch.stack([px, zero, zero], dim=-1))


def eval_soft_contacts(model, x, v, body_X_sc=None, body_v_s=None):
    """Particle vs rigid-shape contacts through shape-local SDFs.

    x, v [E, P, 3]; body_X_sc [E, L, 7] and body_v_s [E, L, 6] (the links'
    transforms and spatial velocities) or None for static shapes only.
    Returns (particle_f [E, P, 3], body_f [E, L, 6]); body wrenches are
    about the space origin like the reference."""
    c = _consts(model, x)
    E, P = x.shape[0], x.shape[1]
    G = c.shape_transform.shape[0]
    L = model.link_count
    has_body = c.shape_has_body                               # [G, 1]

    ident = torch.zeros((E, G, 7), dtype=x.dtype, device=x.device)
    ident[..., 6] = 1.0
    if body_X_sc is None:
        X_sc = ident
        v_sc = x.new_zeros((E, G, 6))
    else:
        X_sc = torch.where(has_body, _take(body_X_sc, c.shape_body_fan),
                           ident)
        v_sc = torch.where(has_body, _take(body_v_s, c.shape_body_fan),
                           torch.zeros_like(ident[..., :6]))

    X_so = transform_multiply(X_sc, c.shape_transform)       # [E, G, 7]
    X_os = transform_inverse(X_so)

    # [E, G, P, 3] particle positions in each shape's local frame
    x_local = transform_point(X_os[:, :, None, :], x[:, None, :, :])

    margin = 0.01
    geo = c.shape_geo                                         # [G, 1]
    scale = c.shape_scale                                     # [G, 3]

    c_sphere = sphere_sdf(scale[:, 0:1], x_local)
    g_sphere = sphere_sdf_grad(scale[:, 0:1], x_local)
    c_box = box_sdf(scale[:, None, :], x_local)
    g_box = box_sdf_grad(scale[:, None, :], x_local)
    c_capsule = capsule_sdf(scale[:, 0:1], scale[:, 1:2], x_local)
    g_capsule = capsule_sdf_grad(scale[:, 0:1], scale[:, 1:2], x_local)

    # GEO_SPHERE=0, GEO_BOX=1, GEO_CAPSULE=2; other types -> no contact
    c_raw = torch.where(geo == 0, c_sphere,
                        torch.where(geo == 1, c_box, c_capsule))
    g_raw = torch.where((geo == 0)[..., None], g_sphere,
                        torch.where((geo == 1)[..., None], g_box, g_capsule))
    active_shape = geo <= 2

    # GEO_MESH=3 through the baked voxel SDFs, only where a shape has one
    if any(s is not None for s in c.sdf):
        zc = torch.zeros_like(c_raw[:, 0])
        zg = torch.zeros_like(g_raw[:, 0])
        c_m = torch.stack([zc if s is None else mesh_sdf(*s, x_local[:, g])
                           for g, s in enumerate(c.sdf)], dim=1)
        g_m = torch.stack([zg if s is None
                           else mesh_sdf_grad(*s, x_local[:, g])
                           for g, s in enumerate(c.sdf)], dim=1)
        c_raw = torch.where(c.shape_mesh, c_m, c_raw)
        g_raw = torch.where(c.shape_mesh[..., None], g_m, g_raw)
        active_shape = active_shape | c.shape_mesh

    cc = torch.where(active_shape,
                     torch.minimum(c_raw - margin, torch.zeros_like(c_raw)),
                     torch.zeros_like(c_raw))

    # rotate the SDF gradient to world space
    n = quat_rotate(X_so[:, :, None, 3:7], g_raw)

    # body velocity at the particle position (world)
    w_b = v_sc[:, :, None, 0:3]
    v_b = v_sc[:, :, None, 3:6]
    bv = v_b + cross(w_b, x[:, None, :, :])

    vrel = v[:, None, :, :] - bv
    vn = torch.sum(n * vrel, dim=-1)
    vt = vrel - n * vn[..., None]

    ke, kd, kf, mu = (model.contact_ke, model.contact_kd, model.contact_kf,
                      model.contact_mu)

    fn = n * (cc * ke)[..., None]
    fd = n * (torch.minimum(vn, torch.zeros_like(vn)) * kd)[..., None]

    lower = mu * cc * ke
    upper = -lower
    vx = _clip(kf * vt[..., 0], lower, upper)
    vz = _clip(kf * vt[..., 2], lower, upper)
    ft = torch.stack([vx, torch.zeros_like(vx), vz], dim=-1)

    step_c = (cc < 0.0).to(x.dtype)[..., None]
    f_total = fn + (fd + ft) * step_c                         # [E, G, P, 3]
    t_total = cross(x[:, None, :, :], f_total)

    particle_f = -torch.sum(f_total, dim=1)

    if L:
        wrench = torch.cat([t_total, f_total], dim=-1)        # [E, G, P, 6]
        per_shape = torch.sum(wrench, dim=2)                  # [E, G, 6]
        per_shape = torch.where(has_body, per_shape,
                                torch.zeros_like(per_shape))
        body_f = -_sum_into(per_shape, c.shape_body_fan)
    else:
        body_f = x.new_zeros((E, 0, 6))
    return particle_f, body_f


# ---------------------------------------------------------------------------


def particle_forces(model, x, v):
    """Sum all enabled particle force kernels in the reference launch
    order."""
    f = torch.zeros_like(x)
    if model.spring_indices is not None:
        f = f + eval_springs(model, x, v)
    if model.tri_indices is not None and model.tri_ke > 0.0:
        f = f + eval_triangles(model, x, v)
        if model.enable_tri_collisions == "hashed":
            f = f + eval_triangles_contact_hashed(model, x, v)
        elif model.enable_tri_collisions:
            f = f + eval_triangles_contact(model, x, v)
    if model.edge_indices is not None:
        f = f + eval_bending(model, x, v)
    if model.ground:
        f = f + eval_ground_contacts(model, x, v)
    if model.tet_indices is not None:
        f = f + eval_tetrahedra(model, x, v)
    return f


def integrate_particles(x, v, f, inv_mass, gravity, dt):
    """Semi-implicit Euler. Gravity acts only on dynamic particles (a
    step(-w) mask with zero gradient). inv_mass [P], gravity [3]."""
    dynamic = (inv_mass > 0.0).to(x.dtype)[:, None]
    v1 = v + (f * inv_mass[:, None] + gravity * dynamic) * dt
    x1 = x + v1 * dt
    return x1, v1


# ---------------------------------------------------------------------------
# XPBD (position-based) solver family


def solve_springs(model, x, v, inv_mass, dt):
    """Spring distance-constraint deltas. With ``model.xpbd_compliance`` the
    denominator gains the XPBD compliance term alpha = 1/(ke dt^2); the
    reference computes alpha but keeps it out of the denominator, so the
    default (False) reproduces its shipped behaviour."""
    c = _consts(model, x)
    S = c.spring_rest.shape[0]
    xi, xj = _take(x, c.spring_fan).split(S, dim=1)
    i, j = c.spring_idx

    xij = xi - xj
    l = torch.sqrt(torch.clamp(torch.sum(xij * xij, dim=-1), min=1e-12))
    dir = xij / l[..., None]
    cc = l - c.spring_rest

    wi = inv_mass[i]
    wj = inv_mass[j]
    denom = wi + wj
    if model.xpbd_compliance and c.spring_ke is not None:
        alpha = 1.0 / torch.clamp(c.spring_ke * dt * dt, min=1e-12)
        denom = denom + alpha
    multiplier = cc / torch.where(denom > 0.0, denom, torch.ones_like(denom))
    xd = dir * multiplier[..., None]

    return _sum_into(torch.cat([-xd * wi[:, None], xd * wj[:, None]], dim=1),
                     c.spring_fan)


def solve_tetrahedra(model, x, v, inv_mass, dt, relaxation=1.0):
    """XPBD tet constraints: C_sqrt deviatoric + volume."""
    c = _consts(model, x)
    Q = c.tet_Dm.shape[0]
    x0, x1, x2, x3 = _take(x, c.tet_fan).split(Q, dim=1)
    w0, w1, w2, w3 = (inv_mass[ix] for ix in c.tet_idx)

    k_mu = c.tet_mat[:, 0]
    k_lambda = c.tet_mat[:, 1]

    x10, x20, x30 = x1 - x0, x2 - x0, x3 - x0
    Ds = torch.stack([x10, x20, x30], dim=-1)
    Dm = c.tet_Dm

    inv_rest_volume, rest_volume = _tet_rest(c)

    F = Ds @ Dm

    tr = torch.sum(F * F, dim=(-2, -1))
    r_s_abs = torch.sqrt(torch.clamp(torch.abs(tr - 3.0), min=1e-12))
    C = r_s_abs
    r_s = torch.where(tr < 3.0, -r_s_abs, r_s_abs)

    dCdx = F @ Dm.transpose(-1, -2) / r_s[..., None, None]

    grad1 = dCdx[..., 0]
    grad2 = dCdx[..., 1]
    grad3 = dCdx[..., 2]
    grad0 = -(grad1 + grad2 + grad3)

    denom = (
        torch.sum(grad0 * grad0, dim=-1) * w0
        + torch.sum(grad1 * grad1, dim=-1) * w1
        + torch.sum(grad2 * grad2, dim=-1) * w2
        + torch.sum(grad3 * grad3, dim=-1) * w3
    )
    multiplier = C / (denom + 1.0 / (k_mu * dt * dt * rest_volume))
    # degenerate r_s == 0: the reference early-returns
    multiplier = torch.where(r_s_abs > 1e-6, multiplier,
                             torch.zeros_like(multiplier))

    d0 = grad0 * multiplier[..., None]
    d1 = grad1 * multiplier[..., None]
    d2 = grad2 * multiplier[..., None]
    d3 = grad3 * multiplier[..., None]

    # volume (hydrostatic) constraint
    alpha = 1.0 + k_mu / k_lambda
    J = _det3(F[..., 0], F[..., 1], F[..., 2])
    C_vol = J - alpha

    s = (inv_rest_volume / 6.0)[:, None]
    g1 = cross(x20, x30) * s
    g2 = cross(x30, x10) * s
    g3 = cross(x10, x20) * s
    g0 = -(g1 + g2 + g3)

    denom_v = (
        torch.sum(g0 * g0, dim=-1) * w0
        + torch.sum(g1 * g1, dim=-1) * w1
        + torch.sum(g2 * g2, dim=-1) * w2
        + torch.sum(g3 * g3, dim=-1) * w3
    )
    mult_v = (C_vol / (denom_v + 1.0 / (k_lambda * dt * dt * rest_volume))
              )[..., None]

    d0 = d0 + g0 * mult_v
    d1 = d1 + g1 * mult_v
    d2 = d2 + g2 * mult_v
    d3 = d3 + g3 * mult_v

    return _sum_into(torch.cat([
        -d0 * (w0[:, None] * relaxation), -d1 * (w1[:, None] * relaxation),
        -d2 * (w2[:, None] * relaxation), -d3 * (w3[:, None] * relaxation)],
        dim=1), c.tet_fan)


def solve_ground_contacts(model, x, v, inv_mass, dt):
    """Ground position constraint + friction."""
    n = _consts(model, x).ground_n
    c = torch.sum(n * x, dim=-1) - 0.01
    inside = c <= 0.0

    delta_n = n * c[..., None]

    vn = torch.sum(n * v, dim=-1)
    vt = v - n * vn[..., None]
    vt_len = torch.sqrt(torch.clamp(torch.sum(vt * vt, dim=-1), min=1e-12))

    lambda_f = torch.maximum(model.contact_mu * c, -vt_len * dt)
    delta_f = (vt / vt_len[..., None]) * lambda_f[..., None]

    delta = delta_f - delta_n
    return torch.where(inside[..., None], delta, torch.zeros_like(delta))


def apply_deltas(x_orig, x_pred, delta, dt):
    x_new = x_pred + delta
    v_new = (x_new - x_orig) / dt
    return x_new, v_new


def xpbd_substep(model, x, v, dt, relaxation=1.0):
    """One XPBD substep: predict -> solve constraints -> apply."""
    c = _consts(model, x)
    x_pred, v_pred = integrate_particles(x, v, torch.zeros_like(x),
                                         c.inv_mass, c.gravity, dt)

    delta = torch.zeros_like(x)
    if model.ground:
        delta = delta + solve_ground_contacts(model, x_pred, v_pred,
                                              c.inv_mass, dt)
    if model.spring_indices is not None:
        delta = delta + solve_springs(model, x_pred, v_pred, c.inv_mass, dt)
    if model.tet_indices is not None:
        delta = delta + solve_tetrahedra(model, x_pred, v_pred, c.inv_mass,
                                         dt, relaxation)

    return apply_deltas(x, x_pred, delta, dt)

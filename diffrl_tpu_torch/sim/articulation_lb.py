"""Link-batched articulation dynamics in env-minor layout (port of
diffrl_tpu/sim/articulation_lb.py).

Layout: env-minor. Every tensor carries components on the second-to-last
axis and the env batch E on the LAST axis: [C, E] coords, [D, E] dofs,
[L, 7, E] transforms, [L, 6, E] spatial vectors. On the GPU that axis is
the one adjacent threads walk, so every per-env load is coalesced.

Topology handling: links are regrouped level-major (_plan_for): within a
tree level, links of the same joint type form one group evaluated as a
single batched formula. Parent access is one gather per level (with an
appended identity row for roots), force accumulation is one subtree-mask
contraction, and canonical coord/dof order is restored by one permutation
gather at the stage boundary.

Every sum over rows that share a destination runs in a fixed order, so the
plain version gives the same bits run after run on CUDA as on the CPU
(``_Fan``): the contact wrenches and the muscle segment ends are added per
link left to right through padded tables, in the order of the sequential
``index_add_`` the kernels follow, and so are the cotangents of every
gather whose indices repeat (a parent's children, a link's dofs, contacts
and segment ends), which autograd would otherwise scatter with atomics.

``substep_lb`` is the plain PyTorch version of the cached-substep kernel
and ``substep_vjp_lb`` that of its adjoint kernel (sim/substep_kernels.py);
``simulate_batched_lb`` sends its cached substeps, forward and reverse, to
those kernels' wrappers, which launch the kernels on CUDA tensors and run
the plain versions on CPU tensors. Its reverse pass is the reference's
replay (the refresh substeps are replayed under autograd), or with
``reverse="residual"`` autograd through the saved substeps: each cached
substep an autograd node of the two kernels (``_CachedSubstep``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.time_report import span, traced
from .model import (
    JOINT_BALL,
    JOINT_FIXED,
    JOINT_FREE,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    Model,
)

_QEPS = 1.0e-6


# --------------------------------------------------------------------------
# env-minor math: component axis is -2, env axis is -1. Consts broadcast as
# [..., c, 1].
# --------------------------------------------------------------------------


def _cross(a, b):
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2
    )


def _qmul(a, b):
    ax, ay, az, aw = (a[..., i, :] for i in range(4))
    bx, by, bz, bw = (b[..., i, :] for i in range(4))
    return torch.stack(
        [
            aw * bx + bw * ax + ay * bz - by * az,
            aw * by + bw * ay + az * bx - bz * ax,
            aw * bz + bw * az + ax * by - bx * ay,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-2,
    )


def _qrot(q, v):
    qv = q[..., 0:3, :]
    w = q[..., 3:4, :]
    return (
        v * (2.0 * w * w - 1.0)
        + _cross(qv, v) * w * 2.0
        + qv * torch.sum(qv * v, dim=-2, keepdim=True) * 2.0
    )


def _qrot_inv(q, v):
    qv = q[..., 0:3, :]
    w = q[..., 3:4, :]
    return (
        v * (2.0 * w * w - 1.0)
        - _cross(qv, v) * w * 2.0
        + qv * torch.sum(qv * v, dim=-2, keepdim=True) * 2.0
    )


def _qconj(q):
    return torch.cat([-q[..., 0:3, :], q[..., 3:4, :]], dim=-2)


def _qnormalize(q):
    l2 = torch.sum(q * q, dim=-2, keepdim=True)
    safe = l2 > _QEPS * _QEPS
    l = torch.sqrt(torch.where(safe, l2, torch.ones_like(l2)))
    ident = torch.zeros_like(q)
    ident[..., 3, :] = 1.0
    return torch.where(safe, q / l, ident)


def _tmul(t, u):
    p = _qrot(t[..., 3:7, :], u[..., 0:3, :]) + t[..., 0:3, :]
    q = _qmul(t[..., 3:7, :], u[..., 3:7, :])
    return torch.cat([p, q], dim=-2)


def _tinv(t):
    q_inv = _qconj(t[..., 3:7, :])
    p = -_qrot(q_inv, t[..., 0:3, :])
    return torch.cat([p, q_inv], dim=-2)


def _tpoint(t, x):
    return t[..., 0:3, :] + _qrot(t[..., 3:7, :], x)


def _scross(a, b):
    w = _cross(a[..., 0:3, :], b[..., 0:3, :])
    v = _cross(a[..., 3:6, :], b[..., 0:3, :]) + _cross(
        a[..., 0:3, :], b[..., 3:6, :]
    )
    return torch.cat([w, v], dim=-2)


def _scross_dual(a, b):
    w = _cross(a[..., 0:3, :], b[..., 0:3, :]) + _cross(
        a[..., 3:6, :], b[..., 3:6, :]
    )
    v = _cross(a[..., 0:3, :], b[..., 3:6, :])
    return torch.cat([w, v], dim=-2)


def _twist_xform(t, x):
    q = t[..., 3:7, :]
    p = t[..., 0:3, :]
    w = _qrot(q, x[..., 0:3, :])
    v = _qrot(q, x[..., 3:6, :]) + _cross(p, w)
    return torch.cat([w, v], dim=-2)


def _wrench_xform(t, x):
    q = t[..., 3:7, :]
    p = t[..., 0:3, :]
    v = _qrot(q, x[..., 3:6, :])
    w = _qrot(q, x[..., 0:3, :]) + _cross(p, v)
    return torch.cat([w, v], dim=-2)


def _inertia_matvec(t, I3, m, x):
    """Factored spatial-inertia apply: y = T^T I_m T x with T = Ad(t^-1);
    I3 [L,3,3,1], m [L,1,1]."""
    u = _twist_xform(_tinv(t), x)
    top = torch.sum(I3 * u[..., None, 0:3, :], dim=-2)
    y = torch.cat([top, m * u[..., 3:6, :]], dim=-2)
    return _wrench_xform(t, y)


def _twist_inv_T(t, y):
    """EXACT transpose of the linear map x -> _twist_xform(_tinv(t), x).

    For unit quaternions this equals _wrench_xform(t, .), but FK quats
    carry float32 drift and env states may hold unnormalized root quats;
    the exact transpose keeps the Gram-form mass matrix symmetric for any
    quaternion (_qrot_inv(q, .) == _qrot(q, .)^T)."""
    qi = _qconj(t[..., 3:7, :])
    p_inv = -_qrot(qi, t[..., 0:3, :])
    yw = y[..., 0:3, :]
    yv = y[..., 3:6, :]
    w = _qrot_inv(qi, yw - _cross(p_inv, yv))
    v = _qrot_inv(qi, yv)
    return torch.cat([w, v], dim=-2)


def _inertia_gram_matvec(t, I3, m, x):
    """y = T^T I_m T x with the exact transpose (see _twist_inv_T)."""
    u = _twist_xform(_tinv(t), x)
    top = torch.sum(I3 * u[..., None, 0:3, :], dim=-2)
    y = torch.cat([top, m * u[..., 3:6, :]], dim=-2)
    return _twist_inv_T(t, y)


def _safe_normalize(v, eps=_QEPS):
    l2 = torch.sum(v * v, dim=-2, keepdim=True)
    safe = l2 > eps * eps
    inv = torch.where(
        safe, 1.0 / torch.sqrt(torch.where(safe, l2, torch.ones_like(l2))),
        torch.zeros_like(l2))
    return v * inv


class _SolveFrozenInv(torch.autograd.Function):
    """x = Hinv @ b, env-minor ([D,D,E] x [D,E]), with the reference's
    frozen-factor gradient convention (diffrl_tpu/sim/articulation_lb.py
    _solve_frozen_inv): lam = Hinv g in the forward's index order,
    adj_b = lam, adj_H = -lam x^T, and Hinv gets no gradient."""

    @staticmethod
    def forward(ctx, H, Hinv, b):
        x = torch.sum(Hinv * b[..., None, :, :], dim=-2)
        ctx.save_for_backward(Hinv, x)
        return x

    @staticmethod
    def backward(ctx, g):
        Hinv, x = ctx.saved_tensors
        lam = torch.sum(Hinv * g[..., None, :, :], dim=-2)
        adj_H = (-lam[..., :, None, :] * x[..., None, :, :]
                 if ctx.needs_input_grad[0] else None)
        return adj_H, None, lam


def _solve_frozen_inv(H, Hinv, b):
    """qdd = Hinv @ b with Hinv the frozen factorization from the last
    refresh substep; H takes the gradient (_SolveFrozenInv)."""
    return _SolveFrozenInv.apply(H, Hinv, b)


@dataclass(frozen=True, eq=False)
class _Fan:
    """A gather ``x[idx]`` whose indices repeat, and its adjoint: the sum
    of rows back into their sources. ``table[r]`` lists, in increasing
    order, the positions j with idx[j] == r, padded with len(idx) (a zero
    row), so that row r's sum is taken left to right whatever the device."""

    idx: torch.Tensor       # [N] source row of each gathered row
    table: torch.Tensor     # [R, W] positions per source row, padded with N


def _fan(idx, rows: int, device) -> _Fan:
    idx = np.asarray(idx, np.int64).reshape(-1)
    # positions whose index names no row (a root's parent) are in no list
    order = np.nonzero(idx < rows)[0]
    order = order[np.argsort(idx[order], kind="stable")]
    counts = np.bincount(idx[order], minlength=rows)
    width = max([1] + counts.tolist())
    table = np.full((rows, width), len(idx), np.int64)
    first = np.cumsum(counts) - counts
    table[idx[order], np.arange(len(order)) - first[idx[order]]] = order
    return _Fan(torch.as_tensor(idx, device=device),
                torch.as_tensor(table, device=device))


def _fixed_sum(x, table):
    """out[r] = x[table[r, 0]] + x[table[r, 1]] + ..., left to right, the
    pad position reading a zero row."""
    pad = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    rows = pad[table]
    out = rows[:, 0]
    for k in range(1, table.shape[1]):
        out = out + rows[:, k]
    return out


class _FanGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fan):
        ctx.fan = fan
        return x.index_select(0, fan.idx)

    @staticmethod
    def backward(ctx, g):
        return _FanSum.apply(g, ctx.fan), None


class _FanSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fan):
        ctx.fan = fan
        return _fixed_sum(x, fan.table)

    @staticmethod
    def backward(ctx, g):
        return _FanGather.apply(g, ctx.fan), None


def _gather(x, fan: _Fan):
    """x[fan.idx] along the first axis; its cotangent is summed per source
    row in a fixed order."""
    return _FanGather.apply(x, fan)


def _scatter_sum(x, fan: _Fan):
    """[R, ...] sums of the rows of x per destination fan.idx, each taken
    left to right in row order (the sequential index_add_'s order)."""
    return _FanSum.apply(x, fan)


# --------------------------------------------------------------------------
# topology plan: level-major link regrouping, all static index/const tables
# --------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class _Group:
    jtype: int
    level: int
    start: int          # proc-row range [start, stop); groups are contiguous
    stop: int
    links: np.ndarray   # original link ids, len n
    q_idx: np.ndarray   # [n, cq] canonical coord indices (cq by joint type)
    qd_idx: np.ndarray  # [n, cd] canonical dof indices
    # device tensors
    q_idx_t: torch.Tensor
    qd_idx_t: torch.Tensor
    axis: torch.Tensor       # [n, 3, 1]
    X_pj: torch.Tensor       # [n, 7, 1]
    # per-link gains / per-coord targets+limits (scalar-joint groups), [n, 1]
    target_ke: torch.Tensor
    target_kd: torch.Tensor
    limit_ke: torch.Tensor
    limit_kd: torch.Tensor
    target: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor


@dataclass(frozen=True, eq=False)
class _Plan:
    """Host index tables (numpy) and device constants of one Model."""

    groups: Tuple[_Group, ...]
    levels: Tuple[Tuple[int, int], ...]   # contiguous proc-row span per level
    order: np.ndarray                     # link id at each proc row
    row_of: np.ndarray                    # proc row of each link id
    parent_row: np.ndarray                # parent proc row; L for roots
    subtree: np.ndarray                   # [L, L] f32, proc order
    coord_perm: np.ndarray                # group-chunk order -> canonical
    dof_perm: np.ndarray
    inv_coord_perm: np.ndarray
    inv_dof_perm: np.ndarray
    dof_row: np.ndarray                   # [D] proc row owning each chunk-dof
    anc_pair: np.ndarray                  # [D, D] bool, chunk order
    contact_rows: np.ndarray              # [K] proc rows
    seg_row0: np.ndarray                  # muscle segments (proc rows)
    seg_row1: np.ndarray
    seg_m: np.ndarray
    # device tensors
    X_pj: torch.Tensor                    # [L, 7, 1] proc order
    X_cm: torch.Tensor                    # [L, 7, 1]
    I3: torch.Tensor                      # [L, 3, 3, 1]
    m: torch.Tensor                       # [L, 1, 1]
    gravity: torch.Tensor                 # [1, 3, 1]
    ground_normal: torch.Tensor           # [1, 3, 1], +y
    subtree_t: torch.Tensor
    parent_fan: _Fan                      # parent rows of [L + 1] rows
    level_parent_fan: Tuple[_Fan, ...]    # per level, into the rows above
    inv_coord_perm_t: torch.Tensor
    inv_dof_perm_t: torch.Tensor
    dof_fan: _Fan                         # owning row of each chunk-dof
    anc_pair_t: torch.Tensor              # [D, D, 1] bool
    armature: torch.Tensor                # [D, 1] canonical order
    contact_rows_t: torch.Tensor
    contact_fan: _Fan
    contact_point: torch.Tensor           # [K, 3, 1]
    contact_dist: torch.Tensor            # [K, 1, 1]
    contact_mat: torch.Tensor             # [4, K, 1, 1] (ke, kd, kf, mu)
    seg_row0_fan: _Fan
    seg_row1_fan: _Fan
    seg_end_fan: _Fan                     # [row0 ends; row1 ends] -> link
    seg_m_fan: _Fan
    seg_r0: torch.Tensor                  # [S, 3, 1]
    seg_r1: torch.Tensor


_N_COORDS = {
    JOINT_PRISMATIC: 1, JOINT_REVOLUTE: 1, JOINT_BALL: 4,
    JOINT_FIXED: 0, JOINT_FREE: 7,
}
_N_DOFS = {
    JOINT_PRISMATIC: 1, JOINT_REVOLUTE: 1, JOINT_BALL: 3,
    JOINT_FIXED: 0, JOINT_FREE: 6,
}

# One plan per (Model object, device, dtype). A Model is immutable and
# hashed by identity, so a changed parameter means a new Model and a new
# plan. The engine runs in float32; a float64 plan serves reference runs of
# the plain version (its constants are the float32 model values, widened).
_PLANS: "weakref.WeakKeyDictionary[Model, Dict[tuple, _Plan]]" = (
    weakref.WeakKeyDictionary())


def _plan_for(model: Model, device, dtype=torch.float32) -> _Plan:
    key = (torch.device(device), dtype)
    per_model = _PLANS.setdefault(model, {})
    plan = per_model.get(key)
    if plan is None:
        plan = per_model[key] = _build_plan(model, *key)
    return plan


def _build_plan(model: Model, device: torch.device,
                dtype=torch.float32) -> _Plan:
    topo = model.topology
    L = topo.link_count
    parent = np.asarray(topo.joint_parent, np.int64)
    jtype = np.asarray(topo.joint_type, np.int64)
    qs = np.asarray(topo.joint_q_start, np.int64)
    ds = np.asarray(topo.joint_qd_start, np.int64)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(
            dtype)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    depth = np.zeros(L, np.int64)
    for i in range(L):
        depth[i] = 0 if parent[i] < 0 else depth[parent[i]] + 1

    # level-major processing order; same-type links contiguous within a level
    order: List[int] = []
    groups: List[_Group] = []
    levels: List[Tuple[int, int]] = []
    t_ke = np.asarray(model.joint_target_ke, np.float32)
    t_kd = np.asarray(model.joint_target_kd, np.float32)
    l_ke = np.asarray(model.joint_limit_ke, np.float32)
    l_kd = np.asarray(model.joint_limit_kd, np.float32)
    target = np.asarray(model.joint_target, np.float32)
    lower = np.asarray(model.joint_limit_lower, np.float32)
    upper = np.asarray(model.joint_limit_upper, np.float32)
    axis_all = np.asarray(model.joint_axis, np.float32)
    X_pj_all = np.asarray(model.joint_X_pj, np.float32)

    for lvl in range(int(depth.max()) + 1 if L else 0):
        lvl_start = len(order)
        in_lvl = np.nonzero(depth == lvl)[0]
        for t in sorted(set(jtype[in_lvl].tolist())):
            links = in_lvl[jtype[in_lvl] == t]
            n = len(links)
            start = len(order)
            order.extend(links.tolist())
            cq, cd = _N_COORDS[t], _N_DOFS[t]
            q_idx = np.stack(
                [qs[links] + k for k in range(cq)], axis=1
            ).astype(np.int64) if cq else np.zeros((n, 0), np.int64)
            qd_idx = np.stack(
                [ds[links] + k for k in range(cd)], axis=1
            ).astype(np.int64) if cd else np.zeros((n, 0), np.int64)
            scalar = t in (JOINT_PRISMATIC, JOINT_REVOLUTE)

            def per_coord(a):
                return f32((a[qs[links]] if scalar
                            else np.zeros(n, np.float32)).reshape(n, 1))

            groups.append(_Group(
                jtype=int(t), level=lvl, start=start, stop=start + n,
                links=links, q_idx=q_idx, qd_idx=qd_idx,
                q_idx_t=i64(q_idx), qd_idx_t=i64(qd_idx),
                axis=f32(axis_all[links].reshape(n, 3, 1)),
                X_pj=f32(X_pj_all[links].reshape(n, 7, 1)),
                target_ke=f32(t_ke[links].reshape(n, 1)),
                target_kd=f32(t_kd[links].reshape(n, 1)),
                limit_ke=f32(l_ke[links].reshape(n, 1)),
                limit_kd=f32(l_kd[links].reshape(n, 1)),
                target=per_coord(target),
                lower=per_coord(lower),
                upper=per_coord(upper),
            ))
        levels.append((lvl_start, len(order)))

    order_np = np.asarray(order, np.int64)
    row_of = np.zeros(L, np.int64)
    row_of[order_np] = np.arange(L)
    parent_row = np.where(
        parent[order_np] < 0, L, row_of[np.maximum(parent[order_np], 0)]
    )

    # subtree[i, j] = 1 iff proc-row i is an ancestor-or-self of proc-row j
    anc = np.zeros((L, L), np.float32)
    for j_link in range(L):
        a = j_link
        while a >= 0:
            anc[row_of[a], row_of[j_link]] = 1.0
            a = parent[a]

    coord_perm = np.concatenate(
        [g.q_idx.ravel() for g in groups]) if groups else np.zeros(0, np.int64)
    dof_perm = np.concatenate(
        [g.qd_idx.ravel() for g in groups]) if groups else np.zeros(0, np.int64)
    inv_coord_perm = np.argsort(coord_perm)
    inv_dof_perm = np.argsort(dof_perm)

    # mass-matrix tables (chunk-dof order): owning proc row per dof and the
    # ancestor-pair sparsity mask
    dof_row = np.concatenate(
        [np.repeat(np.arange(g.start, g.stop), _N_DOFS[g.jtype])
         for g in groups]
    ).astype(np.int64) if groups else np.zeros(0, np.int64)
    anc_pair = anc[np.ix_(dof_row, dof_row)].astype(bool)

    I_m = np.asarray(model.body_I_m, np.float32)[order_np]
    K = topo.contact_count
    has_contacts = K > 0 and bool(model.ground)
    cmat = (np.asarray(model.contact_mat, np.float32)
            if has_contacts else np.zeros((0, 4), np.float32))
    contact_rows = (row_of[np.asarray(topo.contact_body, np.int64)]
                    if has_contacts else np.zeros(0, np.int64))

    # muscle waypoint segments (static segment list)
    seg_i, seg_m = [], []
    M = topo.muscle_count
    if M:
        ms = topo.muscle_start
        mlinks = topo.muscle_links
        for mi in range(M):
            for i in range(ms[mi], ms[mi + 1] - 1):
                if mlinks[i] == mlinks[i + 1]:
                    continue
                seg_i.append(i)
                seg_m.append(mi)
    seg_i = np.asarray(seg_i, np.int64)
    seg_m_np = np.asarray(seg_m, np.int64)
    if len(seg_i):
        mlinks_np = np.asarray(topo.muscle_links, np.int64)
        mpts = np.asarray(model.muscle_points, np.float32)
        seg_row0 = row_of[mlinks_np[seg_i]]
        seg_row1 = row_of[mlinks_np[seg_i + 1]]
        seg_r0 = mpts[seg_i].reshape(-1, 3, 1)
        seg_r1 = mpts[seg_i + 1].reshape(-1, 3, 1)
    else:
        seg_row0 = seg_row1 = np.zeros(0, np.int64)
        seg_r0 = seg_r1 = np.zeros((0, 3, 1), np.float32)

    return _Plan(
        groups=tuple(groups),
        levels=tuple(levels),
        order=order_np,
        row_of=row_of,
        parent_row=parent_row,
        subtree=anc,
        coord_perm=coord_perm,
        dof_perm=dof_perm,
        inv_coord_perm=inv_coord_perm,
        inv_dof_perm=inv_dof_perm,
        dof_row=dof_row,
        anc_pair=anc_pair,
        contact_rows=contact_rows,
        seg_row0=seg_row0,
        seg_row1=seg_row1,
        seg_m=seg_m_np,
        X_pj=f32(X_pj_all[order_np].reshape(L, 7, 1)),
        X_cm=f32(np.asarray(model.joint_X_cm, np.float32)[order_np]
                 .reshape(L, 7, 1)),
        I3=f32(I_m[:, 0:3, 0:3].reshape(L, 3, 3, 1)),
        m=f32(I_m[:, 3, 3].reshape(L, 1, 1)),
        gravity=f32(np.asarray(model.gravity, np.float32).reshape(1, 3, 1)),
        ground_normal=f32(np.array([0.0, 1.0, 0.0]).reshape(1, 3, 1)),
        subtree_t=f32(anc),
        parent_fan=_fan(parent_row, L + 1, device),
        level_parent_fan=tuple(_fan(parent_row[s:e], s, device)
                               for (s, e) in levels),
        inv_coord_perm_t=i64(inv_coord_perm),
        inv_dof_perm_t=i64(inv_dof_perm),
        dof_fan=_fan(dof_row, L, device),
        anc_pair_t=torch.as_tensor(anc_pair[:, :, None], device=device),
        armature=f32(np.asarray(model.joint_armature, np.float32)
                     .reshape(-1, 1)),
        contact_rows_t=i64(contact_rows),
        contact_fan=_fan(contact_rows, L, device),
        contact_point=f32(np.asarray(model.contact_point, np.float32)
                          .reshape(-1, 3, 1) if has_contacts
                          else np.zeros((0, 3, 1), np.float32)),
        contact_dist=f32(np.asarray(model.contact_dist, np.float32)
                         .reshape(-1, 1, 1) if has_contacts
                         else np.zeros((0, 1, 1), np.float32)),
        contact_mat=f32(cmat.T.reshape(4, -1, 1, 1)),
        seg_row0_fan=_fan(seg_row0, L, device),
        seg_row1_fan=_fan(seg_row1, L, device),
        seg_end_fan=_fan(np.concatenate([seg_row0, seg_row1]), L, device),
        seg_m_fan=_fan(seg_m_np, M, device),
        seg_r0=f32(seg_r0),
        seg_r1=f32(seg_r1),
    )


# --------------------------------------------------------------------------
# stages (all env-minor; [.., E] tensors)
# --------------------------------------------------------------------------


def _identity_rows(n, E, like):
    row = torch.zeros((n, 7, E), dtype=like.dtype, device=like.device)
    row[:, 6, :] = 1.0
    return row


def _joint_transforms(plan: _Plan, q):
    """X_jc per link in proc order ([L, 7, E]), one formula per group."""
    E = q.shape[-1]
    chunks = []
    for g in plan.groups:
        n = g.stop - g.start
        if g.jtype == JOINT_PRISMATIC:
            pos = g.axis * q[g.q_idx_t[:, 0]][:, None, :]
            chunks.append(torch.cat([pos, _identity_rows(n, E, q)[:, 3:7]],
                                    dim=-2))
        elif g.jtype == JOINT_REVOLUTE:
            half = q[g.q_idx_t[:, 0]][:, None, :] * 0.5
            v = g.axis * torch.sin(half)
            w = torch.cos(half)
            pos = torch.zeros((n, 3, E), dtype=q.dtype, device=q.device)
            chunks.append(torch.cat([pos, v, w], dim=-2))
        elif g.jtype == JOINT_BALL:
            pos = torch.zeros((n, 3, E), dtype=q.dtype, device=q.device)
            chunks.append(torch.cat([pos, q[g.q_idx_t]], dim=-2))
        elif g.jtype == JOINT_FREE:
            chunks.append(q[g.q_idx_t])                      # [n, 7, E]
        else:  # fixed
            chunks.append(_identity_rows(n, E, q))
    return torch.cat(chunks, dim=0)


def _fk(plan: _Plan, q):
    """Level-synchronous FK: X_sc, X_sm [L, 7, E] in proc order."""
    X_local = _tmul(plan.X_pj, _joint_transforms(plan, q))   # [L, 7, E]
    acc = None
    for (s, e), pr in zip(plan.levels, plan.level_parent_fan):
        if s == 0:
            acc = X_local[s:e]        # roots: parent is the space frame
        else:
            acc = torch.cat([acc, _tmul(_gather(acc, pr), X_local[s:e])],
                            dim=0)
    X_sc = acc if acc is not None else q.new_zeros((0, 7, q.shape[-1]))
    X_sm = _tmul(X_sc, plan.X_cm)
    return X_sc, X_sm


def _motion_subspaces(plan: _Plan, q, X_sc):
    """Per-group S chunks ([n, cd, 6, E]) and the joint frames X_sj."""
    E = q.shape[-1]
    aug = torch.cat([X_sc, _identity_rows(1, E, q)], dim=0)
    X_sj = _tmul(_gather(aug, plan.parent_fan), plan.X_pj)

    S_chunks = []
    for g in plan.groups:
        n = g.stop - g.start
        sj = X_sj[g.start:g.stop]
        p = sj[:, 0:3, :]
        quat = sj[:, 3:7, :]
        if g.jtype == JOINT_REVOLUTE:
            w = _qrot(quat, g.axis)
            S = torch.cat([w, _cross(p, w)], dim=-2)[:, None]    # [n,1,6,E]
        elif g.jtype == JOINT_PRISMATIC:
            v = _qrot(quat, g.axis)
            S = torch.cat([torch.zeros_like(v), v], dim=-2)[:, None]
        elif g.jtype == JOINT_BALL:
            # the axes made on the device: setting an entry from a host
            # number would be a synchronizing copy on every call
            axes = torch.eye(3, dtype=q.dtype, device=q.device)
            rows = []
            for k in range(3):
                w = _qrot(quat, axes[k].reshape(1, 3, 1))
                rows.append(torch.cat([w, _cross(p, w)], dim=-2))
            S = torch.stack(rows, dim=1)                         # [n,3,6,E]
        elif g.jtype == JOINT_FREE:
            eye = torch.eye(6, dtype=q.dtype, device=q.device)
            S = eye.reshape(1, 6, 6, 1).expand(n, 6, 6, E)
        else:  # fixed
            S = q.new_zeros((n, 0, 6, E))
        S_chunks.append(S)
    return S_chunks, X_sj


def _id(plan: _Plan, q, qd, X_sc, X_sm):
    """Velocity/bias-force sweep. Returns (S_chunks, v_s [L,6,E],
    body_f [L,6,E]) in proc order."""
    E = q.shape[-1]
    S_chunks, _ = _motion_subspaces(plan, q, X_sc)

    vj_parts = []
    for g, S in zip(plan.groups, S_chunks):
        n = g.stop - g.start
        if g.jtype == JOINT_FREE:
            vj_parts.append(qd[g.qd_idx_t])                      # [n, 6, E]
        elif g.jtype == JOINT_FIXED:
            vj_parts.append(q.new_zeros((n, 6, E)))
        else:
            qd_g = qd[g.qd_idx_t]                                # [n, cd, E]
            vj_parts.append(torch.sum(S * qd_g[:, :, None, :], dim=1))
    v_j = torch.cat(vj_parts, dim=0)                             # [L, 6, E]

    v_acc = a_acc = None
    for (s, e), pr in zip(plan.levels, plan.level_parent_fan):
        vj_lvl = v_j[s:e]
        if s == 0:
            v_acc = vj_lvl
            a_acc = _scross(v_acc, vj_lvl)
        else:
            v_lvl = _gather(v_acc, pr) + vj_lvl
            a_lvl = _gather(a_acc, pr) + _scross(v_lvl, vj_lvl)
            v_acc = torch.cat([v_acc, v_lvl], dim=0)
            a_acc = torch.cat([a_acc, a_lvl], dim=0)

    gm = plan.gravity * plan.m                                   # [L, 3, 1]
    p_com = X_sm[:, 0:3, :]
    gm_b = gm.expand_as(p_com)
    f_g = torch.cat([_cross(p_com, gm_b), gm_b], dim=-2)

    Ia = _inertia_matvec(X_sm, plan.I3, plan.m, a_acc)
    Iv = _inertia_matvec(X_sm, plan.I3, plan.m, v_acc)
    body_f = Ia + _scross_dual(v_acc, Iv) - f_g
    return S_chunks, v_acc, body_f


def _contact_kinematics(plan: _Plan, X_sc, v_s):
    """What the ground contacts and their selects are made of: each
    contact's link frame X [K, 7, E], the link's angular and linear velocity
    w, v, the contact's world point p and its velocity dpdt = v + w x p
    ([K, 3, E] each)."""
    X = _gather(X_sc, plan.contact_fan)                          # [K, 7, E]
    v6 = _gather(v_s, plan.contact_fan)
    p = _tpoint(X, plan.contact_point) - plan.ground_normal * \
        plan.contact_dist
    w, v = v6[:, 0:3, :], v6[:, 3:6, :]
    return X, w, v, p, v + _cross(w, p)


def _segment_ends(plan: _Plan, X_sc):
    """The world points [S, 3, E] at both ends of every muscle segment."""
    return (_tpoint(_gather(X_sc, plan.seg_row0_fan), plan.seg_r0),
            _tpoint(_gather(X_sc, plan.seg_row1_fan), plan.seg_r1))


def _contacts(plan: _Plan, X_sc, v_s):
    """Ground contacts -> per-link wrenches [L, 6, E] in proc order."""
    if len(plan.contact_rows) == 0:
        return X_sc.new_zeros((X_sc.shape[0], 6, X_sc.shape[-1]))
    _, _, _, p, dpdt = _contact_kinematics(plan, X_sc, v_s)
    ke, kd, kf, mu = plan.contact_mat.unbind(0)

    n_c = plan.ground_normal
    c = p[:, 1:2, :]                                             # [K, 1, E]
    vn = dpdt[:, 1:2, :]
    vt = dpdt - n_c * vn

    fn = c * ke
    # minimum, not clamp: a tie at vn == 0 splits the gradient as JAX does
    fd = torch.minimum(vn, torch.zeros_like(vn)) * kd * (-c)

    vt_len2 = torch.sum(vt * vt, dim=-2, keepdim=True)
    safe = vt_len2 > 1e-12
    vt_len = torch.sqrt(torch.where(safe, vt_len2, torch.ones_like(vt_len2)))
    dirv = torch.where(safe, vt / vt_len, torch.zeros_like(vt))
    mag = torch.minimum(
        kf * torch.where(safe, vt_len, torch.zeros_like(vt_len)), -mu * c * ke)
    ft = dirv * mag

    f_total = n_c * (fn + fd) + ft
    f_total = torch.where(c < 0.0, f_total, torch.zeros_like(f_total))
    t_total = _cross(p, f_total)

    wrench = torch.cat([t_total, f_total], dim=-2)               # [K, 6, E]
    return _scatter_sum(wrench, plan.contact_fan)


def _muscles(plan: _Plan, X_sc, muscle_act):
    """MTU muscle wrenches -> [L, 6, E] proc order. muscle_act: [M, E]."""
    if len(plan.seg_row0) == 0:
        return X_sc.new_zeros((X_sc.shape[0], 6, X_sc.shape[-1]))
    act = _gather(muscle_act, plan.seg_m_fan)[:, None, :]        # [S, 1, E]
    pos0, pos1 = _segment_ends(plan, X_sc)
    f = _safe_normalize(pos1 - pos0) * act
    w0 = torch.cat([_cross(pos0, f), f], dim=-2)
    w1 = torch.cat([_cross(pos1, f), f], dim=-2)
    # per link: the -w0 of its first ends, then the w1 of its second ends
    return _scatter_sum(torch.cat([-w0, w1]), plan.seg_end_fan)


# a select counts as at its boundary when its argument lies within this
# many float32 units of it (select_margins' units): the next power of two
# above the largest float32 rounding of a select's argument that the plain
# path made at chip_smoke.py's checked states of every model on an NVIDIA
# H100 (194 units, SNU Humanoid's tangential guard; select_rounding). The
# kernels' own rounding cannot be read (their arguments stay in registers),
# and no kernel has taken a select's other side at those states, so no
# flipped env measures it
SELECT_ULPS = 256.0
# the selects of one substep whose side can flip the answer's derivative
SELECTS = ("contact depth c < 0", "normal speed min(vn, 0)",
           "tangential guard |vt|^2 > 1e-12",
           "friction cone min(kf |vt|, -mu c ke)",
           "muscle segment guard |d|^2 > 1e-12")
_ULP = 2.0 ** -23


def _select_terms(plan: _Plan, q, qd):
    """For each name of SELECTS that the model has: (its argument less its
    boundary, the size of the terms the argument is summed from, whether
    the instance is in or near contact), [N, E] each over its instances, in
    q's dtype. The scale is a contact's point and link origin for its
    depth, v + w x p for its speeds, both segment ends for a segment."""
    X_sc, X_sm = _fk(plan, q)
    out = {}
    if len(plan.contact_rows):
        _, v_s, _ = _id(plan, q, qd, X_sc, X_sm)
        X, w, v, p, dpdt = _contact_kinematics(plan, X_sc, v_s)
        ke, kd, kf, mu = (m[:, 0] for m in plan.contact_mat.unbind(0))
        c, vn = p[:, 1], dpdt[:, 1]
        vt_len = torch.linalg.vector_norm(
            dpdt - plan.ground_normal * dpdt[:, 1:2], dim=1)
        s_c = (X[:, 0:3].abs().amax(1) + plan.contact_point.abs().amax(1)
               + plan.contact_dist[:, 0].abs())
        s_v = v.abs().amax(1) + w.abs().amax(1) * p.abs().amax(1)
        live = (c < 0.0) | (c.abs() <= SELECT_ULPS * _ULP * s_c)
        out[SELECTS[0]] = (c, s_c, None)
        out[SELECTS[1]] = (vn, s_v, live)
        out[SELECTS[2]] = (vt_len - 1e-6, s_v, live)
        out[SELECTS[3]] = (kf * vt_len + mu * c * ke,
                           kf * s_v + mu * ke * s_c, live)
    if len(plan.seg_row0):
        pos0, pos1 = _segment_ends(plan, X_sc)
        out[SELECTS[4]] = (torch.linalg.vector_norm(pos1 - pos0, dim=1)
                           - 1e-6,
                           pos0.abs().amax(1) + pos1.abs().amax(1), None)
    return out


def select_margins(model: Model, q, qd):
    """How near each env's selects lie to their boundaries, in float32
    rounding units: for each name of ``SELECTS``, a float64 [E] tensor of
    the least |argument - boundary| / (2^-23 scale) over its instances
    (contacts, muscle segments; ``_select_terms``), the arguments computed
    in float64 at the env-minor state (q [C, E], qd [D, E]). A float32 path
    takes a select's other side only where its rounding reaches the
    boundary, so only a small margin lets it. The speed and friction
    selects count for contacts in or near contact (depth below 0 or within
    SELECT_ULPS units of it); an env without instances gets inf."""
    plan = _plan_for(model, q.device, torch.float64)
    inf = torch.full((q.shape[-1],), float("inf"), dtype=torch.float64,
                     device=q.device)
    out = dict.fromkeys(SELECTS, inf)
    tiny = torch.finfo(torch.float64).tiny
    for name, (arg, scale, live) in _select_terms(
            plan, q.double(), qd.double()).items():
        units = arg.abs() / (_ULP * scale + tiny)
        if live is not None:
            units = torch.where(live, units, torch.inf)
        out[name] = units.amin(0)
    return out


def select_rounding(model: Model, q, qd):
    """The float32 rounding of each select's argument on the plain path, in
    select_margins' units: for each name of ``SELECTS`` that the model has,
    the largest |argument in float32 - argument in float64| / (2^-23 scale)
    over all its instances and envs at the float32 state (q, qd): the
    measurement SELECT_ULPS is set from."""
    p32 = _plan_for(model, q.device, torch.float32)
    p64 = _plan_for(model, q.device, torch.float64)
    t32 = _select_terms(p32, q.float(), qd.float())
    tiny = torch.finfo(torch.float64).tiny
    return {name: float(((t32[name][0].double() - arg).abs()
                         / (_ULP * scale + tiny)).max())
            for name, (arg, scale, _) in _select_terms(
                p64, q.double(), qd.double()).items()}


def _tau(plan: _Plan, q, qd, joint_act, S_chunks, body_f):
    """Joint-space torques. Returns tau [D, E] in canonical dof order."""
    E = q.shape[-1]
    # subtree force accumulation: f_tot[i] = sum_{j in subtree(i)} body_f[j]
    f_tot = torch.einsum("ij,jke->ike", plan.subtree_t, body_f)

    chunks = []
    for g, S in zip(plan.groups, S_chunks):
        n = g.stop - g.start
        if g.jtype == JOINT_FIXED:
            continue
        f_g = f_tot[g.start:g.stop]                              # [n, 6, E]
        if g.jtype == JOINT_FREE:
            chunks.append((-f_g).reshape(n * 6, E))
            continue
        Sf = torch.sum(S * f_g[:, None, :, :], dim=-2)           # [n, cd, E]
        if g.jtype == JOINT_BALL:
            q_g = q[g.q_idx_t[:, 0:3]]                           # [n, 3, E]
            qd_g = qd[g.qd_idx_t]
            t = (-Sf - qd_g * g.target_kd[:, :, None]
                 - q_g * g.target_ke[:, :, None])
            chunks.append(t.reshape(n * 3, E))
        else:  # revolute / prismatic
            q_g = q[g.q_idx_t[:, 0]]                             # [n, E]
            qd_g = qd[g.qd_idx_t[:, 0]]
            act = joint_act[g.qd_idx_t[:, 0]]
            zero = torch.zeros_like(q_g)
            limit_f = torch.where(
                q_g < g.lower,
                g.limit_ke * (g.lower - q_g),
                torch.where(q_g > g.upper, g.limit_ke * (g.upper - q_g), zero),
            )
            damping_f = -g.limit_kd * qd_g
            t = (
                -Sf[:, 0, :]
                - g.target_ke * (q_g - g.target)
                - g.target_kd * qd_g
                + act
                + limit_f
                + damping_f
            )
            chunks.append(t)
    if not chunks:
        return q.new_zeros((0, E))
    return torch.cat(chunks, dim=0)[plan.inv_dof_perm_t]


def _integrate(plan: _Plan, q, qd, qdd, dt):
    """Semi-implicit joint integration. Returns (q' [C,E], qd' [D,E]) in
    canonical order."""
    E = q.shape[-1]
    q_chunks, qd_chunks = [], []
    for g in plan.groups:
        n = g.stop - g.start
        if g.jtype == JOINT_FIXED:
            continue
        if g.jtype in (JOINT_PRISMATIC, JOINT_REVOLUTE):
            qd_n = qd[g.qd_idx_t[:, 0]] + qdd[g.qd_idx_t[:, 0]] * dt
            q_chunks.append(q[g.q_idx_t[:, 0]] + qd_n * dt)
            qd_chunks.append(qd_n)
        elif g.jtype == JOINT_BALL:
            w_n = qd[g.qd_idx_t] + qdd[g.qd_idx_t] * dt           # [n, 3, E]
            r_j = q[g.q_idx_t]                                   # [n, 4, E]
            w_quat = torch.cat([w_n, q.new_zeros((n, 1, E))], dim=-2)
            drdt = _qmul(w_quat, r_j) * 0.5
            r_n = _qnormalize(r_j + drdt * dt)
            q_chunks.append(r_n.reshape(n * 4, E))
            qd_chunks.append(w_n.reshape(n * 3, E))
        elif g.jtype == JOINT_FREE:
            w_s = qd[g.qd_idx_t[:, 0:3]] + qdd[g.qd_idx_t[:, 0:3]] * dt
            v_s = qd[g.qd_idx_t[:, 3:6]] + qdd[g.qd_idx_t[:, 3:6]] * dt
            p_s = q[g.q_idx_t[:, 0:3]]
            dpdt = v_s + _cross(w_s, p_s)
            r_s = q[g.q_idx_t[:, 3:7]]
            w_quat = torch.cat([w_s, q.new_zeros((n, 1, E))], dim=-2)
            drdt = _qmul(w_quat, r_s) * 0.5
            p_n = p_s + dpdt * dt
            r_n = _qnormalize(r_s + drdt * dt)
            q_chunks.append(torch.cat([p_n, r_n], dim=-2).reshape(n * 7, E))
            qd_chunks.append(torch.cat([w_s, v_s], dim=-2).reshape(n * 6, E))
    q_new = (torch.cat(q_chunks, dim=0)[plan.inv_coord_perm_t]
             if q_chunks else torch.zeros_like(q))
    qd_new = (torch.cat(qd_chunks, dim=0)[plan.inv_dof_perm_t]
              if qd_chunks else torch.zeros_like(qd))
    return q_new, qd_new


def _chol_inverse_em(A):
    """Explicit SPD inverse, env-minor ([D, D, E]): unrolled
    Cholesky-Banachiewicz + row-substitution inverse on [E]-lane vectors."""
    D, E = A.shape[0], A.shape[-1]
    rows = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                rows[i][j] = s / rows[j][j]
    # invert L by forward substitution, row-vectorized over [D, E] blocks
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    inv_rows = []
    for i in range(D):
        e = eye[i][:, None].expand(D, E)
        if i:
            prev = torch.stack(inv_rows, dim=0)          # [i, D, E]
            Li = torch.stack(rows[i][:i], dim=0)         # [i, E]
            e = e - torch.sum(Li[:, None, :] * prev, dim=0)
        inv_rows.append(e / rows[i][i][None, :])
    Linv = torch.stack(inv_rows, dim=0)                  # [D(row), D, E]
    return torch.einsum("kiE,kjE->ijE", Linv, Linv)


def _mass_matrix_em(plan: _Plan, X_sm, S_chunks):
    """(H, Hinv) env-minor [D, D, E] in canonical dof order via link-batched
    CRBA. Hinv inverts H + diag(armature)."""
    E = X_sm.shape[-1]
    # per-link space-frame 6x6 inertia, columns via 6 factored matvecs
    basis = torch.eye(6, dtype=X_sm.dtype, device=X_sm.device).reshape(
        6, 1, 6, 1)
    I_s = torch.stack(
        [_inertia_gram_matvec(X_sm, plan.I3, plan.m, basis[k])
         for k in range(6)], dim=1)                      # [L, 6(col), 6, E]

    # composite (subtree-summed) inertia per link: one mask contraction
    Ic = torch.einsum("ij,jkrE->ikrE", plan.subtree_t, I_s)

    # S in chunk-dof order [D, 6, E]; U_d = I^C_{link(d)} S_d
    S_all = torch.cat(
        [S.reshape(-1, 6, E) for S in S_chunks if S.shape[1]], dim=0)
    U = torch.einsum("dkE,dkrE->drE", S_all, _gather(Ic, plan.dof_fan))

    # A[e, d] = S_e . U_d, valid when link(e) is ancestor-or-self of
    # link(d); the mirrored triangle comes from A^T (I^C symmetric)
    A = torch.einsum("erE,drE->edE", S_all, U)
    anc = plan.anc_pair_t
    H = torch.where(anc, A, torch.where(anc.transpose(0, 1),
                                        A.transpose(0, 1),
                                        torch.zeros_like(A)))

    # chunk order -> canonical on both axes
    inv = plan.inv_dof_perm_t
    H = H[inv][:, inv]
    D = H.shape[0]
    eye = torch.eye(D, dtype=H.dtype, device=H.device)[:, :, None]
    reg = H.detach() + eye * plan.armature[:, None, :]
    # contiguous [D, D, E]: the cached-substep kernel reads it at
    # (i * D + j) * E + e
    return H, _chol_inverse_em(reg).contiguous()


def _forces(plan: _Plan, model: Model, q, qd, joint_act, muscle_act):
    X_sc, X_sm = _fk(plan, q)
    S_chunks, v_s, body_f = _id(plan, q, qd, X_sc, X_sm)
    if model.ground:
        body_f = body_f + _contacts(plan, X_sc, v_s)
    if muscle_act is not None and muscle_act.shape[0]:
        body_f = body_f + _muscles(plan, X_sc, muscle_act)
    tau = _tau(plan, q, qd, joint_act, S_chunks, body_f)
    return X_sm, S_chunks, tau


def refresh_substep_lb(model: Model, q, qd, joint_act, muscle_act, dt):
    """One factorizing dynamics substep: the cached-substep chain plus the
    CRBA mass-matrix build and its unrolled inverse.
    Returns (q', qd', H, Hinv) with H/Hinv env-minor [D, D, E]; H carries
    gradients (the solve's frozen-factor cotangent and the caller's), Hinv
    is built from H.detach()."""
    plan = _plan_for(model, q.device, q.dtype)
    X_sm, S_chunks, tau = _forces(plan, model, q, qd, joint_act, muscle_act)
    H, Hinv = _mass_matrix_em(plan, X_sm, S_chunks)
    qdd = _solve_frozen_inv(H, Hinv, tau)
    q_new, qd_new = _integrate(plan, q, qd, qdd, dt)
    return q_new, qd_new, H, Hinv


def substep_lb(model: Model, q, qd, joint_act, muscle_act, dt, H, Hinv):
    """One cached dynamics substep, link-batched env-minor: the plain
    PyTorch version of the cached-substep kernel.

    q [C, E], qd/joint_act [D, E], muscle_act [M, E] | None,
    H/Hinv [D, D, E] (frozen factorization from the refresh substep; the
    value comes from Hinv, the gradient goes to H).
    Returns (q' [C, E], qd' [D, E]).
    """
    plan = _plan_for(model, q.device, q.dtype)
    _, _, tau = _forces(plan, model, q, qd, joint_act, muscle_act)
    return _integrate(plan, q, qd, _solve_frozen_inv(H, Hinv, tau), dt)


def substep_vjp_lb(model: Model, q, qd, joint_act, muscle_act, dt, H, Hinv,
                   gq, gqd):
    """VJP of one cached substep: the plain PyTorch version of the
    cached-substep adjoint kernel (autograd of ``substep_lb``).

    Cotangents gq [C, E], gqd [D, E] of the substep's outputs. Returns
    (dq [C, E], dqd [D, E], djoint_act [D, E], dmuscle_act [M, E] | None,
    dH [D, D, E]); Hinv is frozen.
    """
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, qd, joint_act, H)]
        ma = (muscle_act.detach().requires_grad_()
              if muscle_act is not None else None)
        q_new, qd_new = substep_lb(model, ins[0], ins[1], ins[2], ma, dt,
                                   ins[3], Hinv.detach())
        leaves = ins + ([ma] if ma is not None else [])
        grads = torch.autograd.grad((q_new, qd_new), leaves, (gq, gqd),
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    dq, dqd, dja, dH = grads[:4]
    return dq, dqd, dja, (grads[4] if ma is not None else None), dH


# --------------------------------------------------------------------------
# whole-batch simulate with the replay reverse pass
# --------------------------------------------------------------------------


def _simulate_forward(model, h, nblocks, mm, q, qd, ja, ma, save):
    """Blocks of one refresh and (mm - 1) cached substeps, env-minor. With
    ``save``, also returns per block (q0, qd0, [(q, qd) before each cached
    substep], H, Hinv), all the replay reverse pass needs."""
    from .substep_kernels import substep_forward

    blocks = []
    with torch.no_grad():
        for _ in range(nblocks):
            q0, qd0 = q, qd
            with span("sim.refresh"):
                q, qd, H, Hinv = refresh_substep_lb(model, q, qd, ja, ma, h)
            states = []
            with span("sim.cached"):
                for _ in range(mm - 1):
                    if save:
                        states.append((q, qd))
                    q, qd = substep_forward(model, q, qd, ja, ma, h, H, Hinv)
            if save:
                blocks.append((q0, qd0, states, H, Hinv))
    return q, qd, blocks


class _SimulateReplay(torch.autograd.Function):
    """simulate with the hand-written reverse pass of the reference's
    ``run_fwd``/``run_bwd`` (diffrl_tpu/sim/articulation_lb.py
    simulate_batched_lb, reverse="replay"): the forward saves (q, qd) before
    every cached substep and (q0, qd0, H, Hinv) per block; the backward
    walks the blocks from last to first, runs each cached substep's VJP
    (the adjoint kernel's wrapper) in reverse while dH accumulates, then
    replays the block's refresh substep under autograd with cotangents on
    (q1, qd1, H). The saved states go through save_for_backward, so autograd
    frees them after the backward unless the graph is retained, and a
    retained graph can be differentiated again."""

    @staticmethod
    def forward(ctx, model, h, nblocks, mm, q, qd, ja, ma):
        q, qd, blocks = _simulate_forward(model, h, nblocks, mm, q, qd, ja,
                                          ma, save=True)
        ctx.model, ctx.h, ctx.nblocks, ctx.mm = model, h, nblocks, mm
        flat = [t for q0, qd0, states, H, Hinv in blocks
                for t in (q0, qd0, H, Hinv, *(x for s in states for x in s))]
        ctx.save_for_backward(ja, ma, *flat)
        return q, qd

    @staticmethod
    @torch.autograd.function.once_differentiable
    @traced("sim.replay")
    def backward(ctx, gq, gqd):
        from .substep_kernels import substep_vjp

        model, h, mm = ctx.model, ctx.h, ctx.mm
        ja, ma, *flat = ctx.saved_tensors
        per_block = 4 + 2 * (mm - 1)
        gq, gqd = gq.contiguous(), gqd.contiguous()
        gja = torch.zeros_like(ja)
        gma = torch.zeros_like(ma) if ma is not None else None
        for b in reversed(range(ctx.nblocks)):
            q0, qd0, H, Hinv, *states = flat[b * per_block:
                                             (b + 1) * per_block]
            gH = torch.zeros_like(H)
            with span("sim.vjp"):
                for i in reversed(range(mm - 1)):
                    gq, gqd, dja, dma, dH = substep_vjp(
                        model, states[2 * i], states[2 * i + 1], ja, ma, h,
                        H, Hinv, gq, gqd)
                    gja += dja
                    gH += dH
                    if gma is not None:
                        gma += dma
            with span("sim.replay_refresh"), torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q0, qd0, ja)]
                if ma is not None:
                    leaves.append(ma.detach().requires_grad_())
                q1, qd1, H1, _ = refresh_substep_lb(
                    model, leaves[0], leaves[1], leaves[2],
                    leaves[3] if ma is not None else None, h)
                grads = torch.autograd.grad((q1, qd1, H1), leaves,
                                            (gq, gqd, gH))
            gq, gqd = grads[0].contiguous(), grads[1].contiguous()
            gja += grads[2]
            if gma is not None:
                gma += grads[3]
        return None, None, None, None, gq, gqd, gja, gma


class _CachedSubstep(torch.autograd.Function):
    """One cached substep as an autograd node (the reverse pass
    "residual", JAX's autodiff through the substep scan): the forward is
    the cached-substep kernel's wrapper (substep_forward) and saves its
    inputs; the backward is the adjoint kernel's wrapper (substep_vjp) on
    them, with no replay. H takes the frozen-factor cotangent, Hinv
    none."""

    @staticmethod
    def forward(ctx, model, h, q, qd, ja, ma, H, Hinv):
        from .substep_kernels import substep_forward

        ctx.model, ctx.h = model, h
        ctx.save_for_backward(q, qd, ja, ma, H, Hinv)
        return substep_forward(model, q, qd, ja, ma, h, H, Hinv)

    @staticmethod
    @torch.autograd.function.once_differentiable
    @traced("sim.vjp")
    def backward(ctx, gq, gqd):
        from .substep_kernels import substep_vjp

        q, qd, ja, ma, H, Hinv = ctx.saved_tensors
        dq, dqd, dja, dma, dH = substep_vjp(
            ctx.model, q, qd, ja, ma, ctx.h, H, Hinv, gq.contiguous(),
            gqd.contiguous())
        return None, None, dq, dqd, dja, dma, dH, None


def _simulate_residual(model, h, nblocks, mm, q, qd, ja, ma):
    """Blocks of one refresh and (mm - 1) cached substeps under autograd:
    the refresh differentiated through its plain code (autograd keeps its
    intermediates), each cached substep a _CachedSubstep."""
    for _ in range(nblocks):
        with span("sim.refresh"):
            q, qd, H, Hinv = refresh_substep_lb(model, q, qd, ja, ma, h)
        q, qd = q.contiguous(), qd.contiguous()
        with span("sim.cached"):
            for _ in range(mm - 1):
                q, qd = _CachedSubstep.apply(model, h, q, qd, ja, ma, H,
                                             Hinv)
    return q, qd


@traced("sim.simulate")
def simulate_batched_lb(
    model: Model,
    joint_q,
    joint_qd,
    joint_act=None,
    muscle_act=None,
    dt: float = 1.0 / 60.0,
    substeps: int = 16,
    mass_matrix_freq: int = 1,
    reverse: str = "replay",
):
    """Whole-batch simulate on the link-batched env-minor substep: blocks of
    one refresh substep and (mass_matrix_freq - 1) cached substeps.

    joint_q [E, C], joint_qd/joint_act [E, D], muscle_act [E, M] | None.
    Returns (joint_q' [E, C], joint_qd' [E, D]). Cached substeps run the
    kernel wrappers (substep_forward, and substep_vjp in the backward).
    When an input requires grad, ``reverse`` says how it is
    differentiated: "replay" by the replay reverse pass
    (_SimulateReplay), which saves only the states and factors;
    "residual" by autograd through the substeps (_simulate_residual), which
    keeps the refresh substeps' intermediates and each cached substep's
    inputs and replays nothing (the JAX package's autodiff through the
    scan). Otherwise nothing is saved.
    """
    if reverse not in ("replay", "residual"):
        raise ValueError(f"unknown reverse {reverse!r}")
    if substeps % mass_matrix_freq != 0:
        raise ValueError("substeps must be a multiple of mass_matrix_freq")
    nblocks = substeps // mass_matrix_freq
    h = dt / float(substeps)

    E = joint_q.shape[0]
    if joint_act is None:
        joint_act = joint_q.new_zeros((E, model.dof_count))
    q = joint_q.T.contiguous()
    qd = joint_qd.T.contiguous()
    ja = joint_act.T.contiguous()
    ma = muscle_act.T.contiguous() if muscle_act is not None else None

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, qd, ja, ma)):
        q, qd = (_SimulateReplay.apply if reverse == "replay"
                 else _simulate_residual)(model, h, nblocks,
                                          mass_matrix_freq, q, qd, ja, ma)
    else:
        q, qd, _ = _simulate_forward(model, h, nblocks, mass_matrix_freq, q,
                                     qd, ja, ma, save=False)
    return q.T, qd.T

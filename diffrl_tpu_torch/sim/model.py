"""Scene description: ModelBuilder (host-side) -> Model/State (port of
diffrl_tpu/sim/model.py).

A Model describes ONE scene template: at most one articulation, plus
particles, springs, cloth triangles, bending edges, FEM tetrahedra and
collision shapes (GEO_MESH shapes baked into voxel SDFs by
``bake_mesh_sdf``); environments are a batch axis. Model arrays stay
float32 numpy on the host: the engines' plans (sim/articulation_lb.py,
sim/particles.py) move what they need to the device once per
(Model, device, dtype).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import default_device

# geometry types
GEO_SPHERE = 0
GEO_BOX = 1
GEO_CAPSULE = 2
GEO_MESH = 3
GEO_SDF = 4
GEO_PLANE = 5
GEO_NONE = 6

# joint types
JOINT_PRISMATIC = 0
JOINT_REVOLUTE = 1
JOINT_BALL = 2
JOINT_FIXED = 3
JOINT_FREE = 4

# coords / dofs per joint type
JOINT_COORD_COUNT = {
    JOINT_PRISMATIC: 1,
    JOINT_REVOLUTE: 1,
    JOINT_BALL: 4,
    JOINT_FIXED: 0,
    JOINT_FREE: 7,
}
JOINT_DOF_COUNT = {
    JOINT_PRISMATIC: 1,
    JOINT_REVOLUTE: 1,
    JOINT_BALL: 3,
    JOINT_FIXED: 0,
    JOINT_FREE: 6,
}


# ---------------------------------------------------------------------------
# host-side math helpers (numpy; used only at build time)


def _np_quat_identity():
    return np.array([0.0, 0.0, 0.0, 1.0])


def np_quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    half = angle * 0.5
    return np.concatenate([axis * math.sin(half), [math.cos(half)]])


def np_quat_mul(a, b):
    return np.array(
        [
            a[3] * b[0] + b[3] * a[0] + a[1] * b[2] - b[1] * a[2],
            a[3] * b[1] + b[3] * a[1] + a[2] * b[0] - b[2] * a[0],
            a[3] * b[2] + b[3] * a[2] + a[0] * b[1] - b[0] * a[1],
            a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2],
        ]
    )


def np_quat_rotate(q, v):
    qv = np.asarray(q[0:3])
    w = q[3]
    v = np.asarray(v, dtype=np.float64)
    return v * (2.0 * w * w - 1.0) + np.cross(qv, v) * w * 2.0 + qv * np.dot(qv, v) * 2.0


def np_quat_to_matrix(q):
    c1 = np_quat_rotate(q, (1.0, 0.0, 0.0))
    c2 = np_quat_rotate(q, (0.0, 1.0, 0.0))
    c3 = np_quat_rotate(q, (0.0, 0.0, 1.0))
    return np.array([c1, c2, c3]).T


def np_quat_from_matrix(m):
    """Rotation matrix -> quaternion (Shepperd's method)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr >= 0.0:
        h = math.sqrt(tr + 1.0)
        w = 0.5 * h
        h = 0.5 / h
        x = (m[2, 1] - m[1, 2]) * h
        y = (m[0, 2] - m[2, 0]) * h
        z = (m[1, 0] - m[0, 1]) * h
    else:
        i = 0
        if m[1, 1] > m[0, 0]:
            i = 1
        if m[2, 2] > m[i, i]:
            i = 2
        if i == 0:
            h = math.sqrt((m[0, 0] - (m[1, 1] + m[2, 2])) + 1.0)
            x = 0.5 * h
            h = 0.5 / h
            y = (m[0, 1] + m[1, 0]) * h
            z = (m[2, 0] + m[0, 2]) * h
            w = (m[2, 1] - m[1, 2]) * h
        elif i == 1:
            h = math.sqrt((m[1, 1] - (m[2, 2] + m[0, 0])) + 1.0)
            y = 0.5 * h
            h = 0.5 / h
            z = (m[1, 2] + m[2, 1]) * h
            x = (m[0, 1] + m[1, 0]) * h
            w = (m[0, 2] - m[2, 0]) * h
        else:
            h = math.sqrt((m[2, 2] - (m[0, 0] + m[1, 1])) + 1.0)
            z = 0.5 * h
            h = 0.5 / h
            x = (m[2, 0] + m[0, 2]) * h
            y = (m[1, 2] + m[2, 1]) * h
            w = (m[1, 0] - m[0, 1]) * h
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def np_rpy2quat(roll, pitch, yaw):
    cy, sy = math.cos(yaw * 0.5), math.sin(yaw * 0.5)
    cr, sr = math.cos(roll * 0.5), math.sin(roll * 0.5)
    cp, sp = math.cos(pitch * 0.5), math.sin(pitch * 0.5)
    w = cy * cr * cp + sy * sr * sp
    x = cy * sr * cp - sy * cr * sp
    y = cy * cr * sp + sy * sr * cp
    z = sy * cr * cp - cy * sr * sp
    return np.array([x, y, z, w])


def np_transform(p, q):
    return np.concatenate([np.asarray(p, dtype=np.float64), np.asarray(q, dtype=np.float64)])


def np_transform_identity():
    return np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])


def np_transform_multiply(t, u):
    p = np_quat_rotate(t[3:7], u[0:3]) + t[0:3]
    q = np_quat_mul(t[3:7], u[3:7])
    return np.concatenate([p, q])


def np_transform_inverse(t):
    q_inv = np.array([-t[3], -t[4], -t[5], t[6]])
    return np.concatenate([-np_quat_rotate(q_inv, t[0:3]), q_inv])


def np_transform_point(t, p):
    return t[0:3] + np_quat_rotate(t[3:7], p)


def transform_inertia(m, I, p, q):
    """Steiner shift + rotation of a 3x3 inertia."""
    R = np_quat_to_matrix(q)
    p = np.asarray(p, dtype=np.float64)
    return R @ I @ R.T + m * (np.dot(p, p) * np.eye(3) - np.outer(p, p))


def spatial_matrix_from_inertia(I, m):
    """6x6 spatial inertia [[I, 0], [0, m*1]] in the [w, v] basis."""
    M = np.zeros((6, 6))
    M[0:3, 0:3] = I
    M[3, 3] = m
    M[4, 4] = m
    M[5, 5] = m
    return M


# ---------------------------------------------------------------------------


class Mesh:
    """Triangle mesh with mass/inertia from signed-tet quadrature
    (model.py:41-112 semantics, vectorized)."""

    def __init__(self, vertices, indices):
        self.vertices = np.array(vertices, dtype=np.float64).reshape(-1, 3)
        self.indices = np.array(indices, dtype=np.int32).reshape(-1)

        tris = self.indices.reshape(-1, 3)
        p = self.vertices[tris[:, 0]]
        q = self.vertices[tris[:, 1]]
        r = self.vertices[tris[:, 2]]
        # signed tetra volumes against the origin
        vols = np.einsum("ij,ij->i", p, np.cross(q, r)) / 6.0
        self.mass = float(np.sum(vols))

        # second-order quadrature of x x^T over each tet (origin as 4th vertex)
        I = np.zeros((3, 3))
        for a, b, c, v in zip(p, q, r, vols):
            # covariance of a tet with vertices (0, a, b, c):
            # C = v/20 * (sum_i sum_j x_i x_j^T + sum_i x_i x_i^T)
            V = np.stack([a, b, c])
            s = V.sum(axis=0)
            C = (np.outer(s, s) + V.T @ V) * (v / 20.0)
            I += np.trace(C) * np.eye(3) - C
        self.I = I


def _np_dist_point_tris(pts: np.ndarray, va, vb, vc) -> np.ndarray:
    """Unsigned distance from points [n, 3] to triangles ([T, 3] each) -> [n, T].

    Candidate-minimum form: min over the three edge segments, replaced by the
    plane distance where the plane projection lands inside the triangle.
    """
    n, T = pts.shape[0], va.shape[0]
    p = pts[:, None, :]  # [n, 1, 3]

    def seg_d2(s0, s1):
        d = s1 - s0  # [T, 3]
        dd = np.maximum(np.einsum("tk,tk->t", d, d), 1e-18)
        t = np.clip(np.einsum("ntk,tk->nt", p - s0, d) / dd, 0.0, 1.0)
        diff = p - (s0 + t[..., None] * d)
        return np.einsum("ntk,ntk->nt", diff, diff)

    d2 = np.minimum(seg_d2(va, vb), np.minimum(seg_d2(vb, vc), seg_d2(vc, va)))

    nrm = np.cross(vb - va, vc - va)  # [T, 3]
    nn = np.maximum(np.einsum("tk,tk->t", nrm, nrm), 1e-18)
    h = np.einsum("ntk,tk->nt", p - va, nrm) / np.sqrt(nn)  # signed plane height
    q = p - h[..., None] * (nrm / np.sqrt(nn)[:, None])     # plane projection
    # barycentric sign tests of the projection
    s0 = np.einsum("ntk,tk->nt", np.cross(vb - va, q - va), nrm)
    s1 = np.einsum("ntk,tk->nt", np.cross(vc - vb, q - vb), nrm)
    s2 = np.einsum("ntk,tk->nt", np.cross(va - vc, q - vc), nrm)
    inside = (s0 >= 0.0) & (s1 >= 0.0) & (s2 >= 0.0)
    d2 = np.where(inside, np.minimum(d2, h * h), d2)
    return np.sqrt(d2)


def _np_winding(pts: np.ndarray, va, vb, vc) -> np.ndarray:
    """Generalized winding number of points [n, 3] w.r.t. a triangle soup
    (van Oosterom-Strackee solid angles summed over triangles) -> [n].
    ~1 inside a watertight mesh, ~0 outside."""
    a = va[None] - pts[:, None, :]
    b = vb[None] - pts[:, None, :]
    c = vc[None] - pts[:, None, :]
    la = np.linalg.norm(a, axis=-1)
    lb = np.linalg.norm(b, axis=-1)
    lc = np.linalg.norm(c, axis=-1)
    num = np.einsum("ntk,ntk->nt", a, np.cross(b, c))
    den = (
        la * lb * lc
        + np.einsum("ntk,ntk->nt", a, b) * lc
        + np.einsum("ntk,ntk->nt", b, c) * la
        + np.einsum("ntk,ntk->nt", c, a) * lb
    )
    omega = 2.0 * np.arctan2(num, den)
    return np.sum(omega, axis=-1) / (4.0 * np.pi)


def bake_mesh_sdf(vertices, indices, resolution: int = 24, pad_frac: float = 0.2):
    """Bake a triangle mesh into a dense voxel SDF grid (host-side, numpy).

    Beyond-reference capability: dflex carries GEO_MESH shapes through its
    model (model.py:497, 956) but its contact kernel only evaluates
    sphere/box/capsule SDFs (sim.py:931-948) — mesh shapes never generate
    soft contacts there. Here every mesh shape is voxelized once at
    ``finalize()`` into a [R, R, R] signed-distance grid that the soft
    contacts sample with trilinear interpolation (particles.py:mesh_sdf) —
    a gather + lerp, batched over shapes x particles.

    Sign comes from the generalized winding number (robust for watertight
    meshes; it assumes outward winding); distance from exact
    point-triangle distance. Returns
    (grid [R, R, R] f32, lower [3] f32, spacing [3] f32) with grid[i, j, k]
    sampled at lower + (i, j, k) * spacing. The grid is padded by
    ``pad_frac`` of the bbox diagonal so boundary values stay positive.
    """
    verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    va, vb, vc = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]

    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    pad = pad_frac * float(np.linalg.norm(hi - lo))
    lower = lo - pad
    spacing = (hi - lo + 2.0 * pad) / (resolution - 1)

    ax = [lower[d] + spacing[d] * np.arange(resolution) for d in range(3)]
    gx, gy, gz = np.meshgrid(ax[0], ax[1], ax[2], indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    # chunk over grid points to bound the [n, T] intermediates
    chunk = max(1, int(2_000_000 // max(len(tris), 1)))
    dist = np.empty(pts.shape[0])
    wind = np.empty(pts.shape[0])
    for s in range(0, pts.shape[0], chunk):
        sl = slice(s, s + chunk)
        dist[sl] = _np_dist_point_tris(pts[sl], va, vb, vc).min(axis=1)
        wind[sl] = _np_winding(pts[sl], va, vb, vc)

    sdf = np.where(wind > 0.5, -dist, dist).reshape(resolution, resolution, resolution)
    return (
        sdf.astype(np.float32),
        lower.astype(np.float32),
        spacing.astype(np.float32),
    )


@dataclass(frozen=True)
class Topology:
    """Static articulation structure."""

    joint_type: Tuple[int, ...]
    joint_parent: Tuple[int, ...]
    joint_q_start: Tuple[int, ...]   # per link, plus closing sentinel
    joint_qd_start: Tuple[int, ...]  # per link, plus closing sentinel
    coord_count: int
    dof_count: int
    contact_body: Tuple[int, ...] = ()
    muscle_start: Tuple[int, ...] = (0,)
    muscle_links: Tuple[int, ...] = ()

    @property
    def link_count(self) -> int:
        return len(self.joint_type)

    @property
    def muscle_count(self) -> int:
        return len(self.muscle_start) - 1

    @property
    def contact_count(self) -> int:
        return len(self.contact_body)

    def dof_link(self) -> Tuple[int, ...]:
        """Owning link of each dof."""
        out = []
        for i, t in enumerate(self.joint_type):
            out.extend([i] * JOINT_DOF_COUNT[t])
        return tuple(out)

    def ancestor_dof_mask(self) -> np.ndarray:
        """mask[l, d] = 1 if dof d's joint is on the chain root..l: the
        static structure of the system Jacobian, J[l, :, d] = S_s[d] *
        mask[l, d]."""
        L, D = self.link_count, self.dof_count
        mask = np.zeros((L, D), dtype=np.float32)
        for l in range(L):
            j = l
            while j != -1:
                s, e = self.joint_qd_start[j], self.joint_qd_start[j + 1]
                mask[l, s:e] = 1.0
                j = self.joint_parent[j]
        return mask


# eq=False: a Model is compared and hashed by identity, so per-Model caches
# (the engine plan, the kernel's constant buffer) can key on the object.
@dataclass(frozen=True, eq=False)
class Model:
    """Immutable single-articulation scene template (float32 numpy arrays +
    static topology). Fields are unbatched."""

    topology: Topology

    # articulation constants
    joint_X_pj: np.ndarray        # [L, 7]
    joint_X_cm: np.ndarray        # [L, 7] child COM frame
    joint_axis: np.ndarray        # [L, 3]
    body_I_m: np.ndarray          # [L, 6, 6]
    joint_armature: np.ndarray    # [D]
    joint_target: np.ndarray      # [C]
    joint_target_ke: np.ndarray   # [L]
    joint_target_kd: np.ndarray   # [L]
    joint_limit_lower: np.ndarray  # [C]
    joint_limit_upper: np.ndarray  # [C]
    joint_limit_ke: np.ndarray    # [L]
    joint_limit_kd: np.ndarray    # [L]
    gravity: np.ndarray           # [3]

    # initial state from the builder
    joint_q_init: np.ndarray      # [C]
    joint_qd_init: np.ndarray     # [D]

    # ground contacts (precomputed, state-independent)
    contact_point: np.ndarray     # [K, 3] body-local
    contact_dist: np.ndarray      # [K]
    contact_mat: np.ndarray       # [K, 4] (ke, kd, kf, mu)

    # muscles
    muscle_points: np.ndarray     # [W, 3]
    muscle_params: np.ndarray     # [M, 5] (f0, lm, lt, lmax, pen)

    # collision shapes (host-side metadata)
    shape_transform: Optional[np.ndarray] = None  # [G, 7]
    shape_body: Optional[np.ndarray] = None       # [G] int
    shape_geo_type: Optional[np.ndarray] = None   # [G] int
    shape_geo_scale: Optional[np.ndarray] = None  # [G, 3]
    shape_materials: Optional[np.ndarray] = None  # [G, 4]

    ground: bool = True

    # particles / deformables (optional family)
    particle_q_init: Optional[np.ndarray] = None   # [P, 3]
    particle_qd_init: Optional[np.ndarray] = None  # [P, 3]
    particle_inv_mass: Optional[np.ndarray] = None  # [P]
    spring_indices: Optional[np.ndarray] = None    # [S, 2] int
    spring_rest_length: Optional[np.ndarray] = None
    spring_stiffness: Optional[np.ndarray] = None
    spring_damping: Optional[np.ndarray] = None
    tri_indices: Optional[np.ndarray] = None       # [T, 3] int
    tri_poses: Optional[np.ndarray] = None         # [T, 2, 2]
    tri_activations: Optional[np.ndarray] = None   # [T]
    edge_indices: Optional[np.ndarray] = None      # [B, 4] int
    edge_rest_angle: Optional[np.ndarray] = None   # [B]
    tet_indices: Optional[np.ndarray] = None       # [Q, 4] int
    tet_poses: Optional[np.ndarray] = None         # [Q, 3, 3]
    tet_activations: Optional[np.ndarray] = None   # [Q]
    tet_materials: Optional[np.ndarray] = None     # [Q, 3]

    # cloth / FEM / contact material scalars (global)
    tri_ke: float = 100.0
    tri_ka: float = 100.0
    tri_kd: float = 10.0
    tri_drag: float = 0.0
    tri_lift: float = 0.0
    edge_ke: float = 100.0
    edge_kd: float = 0.0
    contact_ke: float = 1.0e4
    contact_kd: float = 100.0
    contact_kf: float = 100.0
    contact_mu: float = 0.5

    # cloth self-collision: False off; True all-pairs like the reference;
    # "hashed" the spatial-hash broad-phase
    # (particles.eval_triangles_contact_hashed). The hash is exact when
    # cell_size >= contact radius (0.1) + the largest triangle
    # centroid-to-vertex distance and no bucket holds more than capacity
    # particles (the overflow is dropped)
    enable_tri_collisions: object = False
    tri_collision_cell_size: float = 0.2
    tri_collision_buckets: int = 1024
    tri_collision_capacity: int = 8
    # XPBD constraint relaxation
    relaxation: float = 1.0
    # XPBD spring compliance alpha = 1/(ke dt^2) in the constraint
    # denominator; the reference ships it commented out (default False)
    xpbd_compliance: bool = False

    # baked voxel SDFs of GEO_MESH shapes (bake_mesh_sdf); -1 = no grid
    shape_sdf_id: Optional[np.ndarray] = None     # [G] int
    sdf_grid: Optional[np.ndarray] = None         # [M, R, R, R]
    sdf_lower: Optional[np.ndarray] = None        # [M, 3]
    sdf_spacing: Optional[np.ndarray] = None      # [M, 3]

    @property
    def link_count(self):
        return self.topology.link_count

    @property
    def coord_count(self):
        return self.topology.coord_count

    @property
    def dof_count(self):
        return self.topology.dof_count

    @property
    def particle_count(self):
        return (0 if self.particle_q_init is None
                else self.particle_q_init.shape[0])

    def state(self, num_envs=None, device=None) -> "State":
        """Fresh State at the builder's initial coordinates: numpy arrays of
        one env, or, given ``num_envs``, float32 tensors with a leading env
        axis of that size (what the simulators take) on ``device``: CUDA
        unless the caller names one (``default_device``)."""
        arrays = (self.joint_q_init, self.joint_qd_init,
                  self.particle_q_init, self.particle_qd_init)
        if num_envs is not None:
            device = default_device(device)
            arrays = tuple(
                None if a is None else torch.as_tensor(
                    a, dtype=torch.float32, device=device).expand(
                        (num_envs,) + a.shape).clone()
                for a in arrays)
        return State(*arrays)


@dataclass(frozen=True)
class State:
    """Minimal time-varying simulation state: joint coordinates and
    velocities and particle positions and velocities; numpy arrays of one
    env from ``Model.state()``, tensors with a leading env axis in the
    simulators."""

    joint_q: Optional[np.ndarray] = None      # [C]
    joint_qd: Optional[np.ndarray] = None     # [D]
    particle_q: Optional[np.ndarray] = None   # [P, 3]
    particle_qd: Optional[np.ndarray] = None  # [P, 3]


class ModelBuilder:
    """Host-side scene constructor. Build exactly one articulation, then
    ``finalize()``."""

    def __init__(self):
        # particles
        self.particle_q: List = []
        self.particle_qd: List = []
        self.particle_mass: List = []

        # shapes
        self.shape_transform: List = []
        self.shape_body: List = []
        self.shape_geo_type: List = []
        self.shape_geo_scale: List = []
        self.shape_geo_src: List = []
        self.shape_materials: List = []
        # voxel-SDF bake resolution for GEO_MESH soft contacts (bake_mesh_sdf)
        self.sdf_resolution: int = 24

        # springs
        self.spring_indices: List = []
        self.spring_rest_length: List = []
        self.spring_stiffness: List = []
        self.spring_damping: List = []
        self.spring_control: List = []

        # triangles / edges / tets
        self.tri_indices: List = []
        self.tri_poses: List = []
        self.tri_activations: List = []
        self.edge_indices: List = []
        self.edge_rest_angle: List = []
        self.tet_indices: List = []
        self.tet_poses: List = []
        self.tet_activations: List = []
        self.tet_materials: List = []

        # muscles
        self.muscle_start: List = []
        self.muscle_params: List = []
        self.muscle_activation: List = []
        self.muscle_links: List = []
        self.muscle_points: List = []

        # rigid bodies
        self.joint_parent: List = []
        self.joint_child: List = []
        self.joint_axis: List = []
        self.joint_X_pj: List = []

        self.joint_q_start: List = []
        self.joint_qd_start: List = []
        self.joint_type: List = []
        self.joint_armature: List = []
        self.joint_target_ke: List = []
        self.joint_target_kd: List = []
        self.joint_target: List = []
        self.joint_limit_lower: List = []
        self.joint_limit_upper: List = []
        self.joint_limit_ke: List = []
        self.joint_limit_kd: List = []

        self.joint_q: List = []
        self.joint_qd: List = []

        self.body_mass: List = []
        self.body_inertia: List = []
        self.body_com: List = []

        self.articulation_start: List = []

    # -- articulations ------------------------------------------------------

    def add_articulation(self) -> int:
        self.articulation_start.append(len(self.joint_type))
        return len(self.articulation_start) - 1

    def add_link(
        self,
        parent: int,
        X_pj,
        axis,
        type: int,
        armature: float = 0.01,
        stiffness: float = 0.0,
        damping: float = 0.0,
        limit_lower: float = -1.0e3,
        limit_upper: float = 1.0e3,
        limit_ke: float = 100.0,
        limit_kd: float = 10.0,
        com=np.zeros(3),
        I_m=np.zeros((3, 3)),
        m: float = 0.0,
    ) -> int:
        """Add a rigid link below `parent`."""
        X_pj = np.asarray(X_pj, dtype=np.float64)
        if X_pj.shape != (7,):
            raise ValueError("X_pj must be a 7-vector [p(3), q(4)]")

        self.joint_type.append(int(type))
        self.joint_axis.append(np.asarray(axis, dtype=np.float64))
        self.joint_parent.append(int(parent))
        self.joint_X_pj.append(X_pj)

        self.joint_target_ke.append(stiffness)
        self.joint_target_kd.append(damping)
        self.joint_limit_ke.append(limit_ke)
        self.joint_limit_kd.append(limit_kd)

        self.joint_q_start.append(len(self.joint_q))
        self.joint_qd_start.append(len(self.joint_qd))

        if type in (JOINT_PRISMATIC, JOINT_REVOLUTE):
            self.joint_q.append(0.0)
            self.joint_qd.append(0.0)
            self.joint_target.append(0.0)
            self.joint_armature.append(armature)
            self.joint_limit_lower.append(limit_lower)
            self.joint_limit_upper.append(limit_upper)
        elif type == JOINT_BALL:
            self.joint_q.extend([0.0, 0.0, 0.0, 1.0])
            self.joint_qd.extend([0.0, 0.0, 0.0])
            self.joint_target.extend([0.0] * 4)
            self.joint_armature.extend([armature] * 3)
            self.joint_limit_lower.extend([limit_lower] * 3 + [0.0])
            self.joint_limit_upper.extend([limit_upper] * 3 + [0.0])
        elif type == JOINT_FIXED:
            pass
        elif type == JOINT_FREE:
            self.joint_q.extend([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
            self.joint_qd.extend([0.0] * 6)
            # free-joint armature must stay zero
            self.joint_armature.extend([0.0] * 6)
            self.joint_target.extend([0.0] * 7)
            self.joint_limit_lower.extend([0.0] * 7)
            self.joint_limit_upper.extend([0.0] * 7)
        else:
            raise ValueError(f"unknown joint type {type}")

        self.body_inertia.append(np.zeros((3, 3)))
        self.body_mass.append(0.0)
        self.body_com.append(np.zeros(3))

        return len(self.joint_type) - 1

    # -- muscles ------------------------------------------------------------

    def add_muscle(self, links, positions, f0, lm, lt, lmax, pen) -> int:
        self.muscle_start.append(len(self.muscle_links))
        self.muscle_params.append((f0, lm, lt, lmax, pen))
        self.muscle_activation.append(0.0)
        for l, p in zip(links, positions):
            self.muscle_links.append(int(l))
            self.muscle_points.append(np.asarray(p, dtype=np.float64))
        return len(self.muscle_start) - 1

    # -- shapes -------------------------------------------------------------

    def add_shape_plane(self, plane=(0.0, 1.0, 0.0, 0.0), ke=1.0e5, kd=1000.0, kf=1000.0, mu=0.5):
        self._add_shape(-1, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), GEO_PLANE, plane, None, 0.0, ke, kd, kf, mu)

    def add_shape_sphere(self, body, pos=(0.0, 0.0, 0.0), rot=(0.0, 0.0, 0.0, 1.0), radius=1.0,
                         density=1000.0, ke=1.0e5, kd=1000.0, kf=1000.0, mu=0.5):
        self._add_shape(body, pos, rot, GEO_SPHERE, (radius, 0.0, 0.0, 0.0), None, density, ke, kd, kf, mu)

    def add_shape_box(self, body, pos=(0.0, 0.0, 0.0), rot=(0.0, 0.0, 0.0, 1.0),
                      hx=0.5, hy=0.5, hz=0.5, density=1000.0, ke=1.0e5, kd=1000.0, kf=1000.0, mu=0.5):
        self._add_shape(body, pos, rot, GEO_BOX, (hx, hy, hz, 0.0), None, density, ke, kd, kf, mu)

    def add_shape_capsule(self, body, pos=(0.0, 0.0, 0.0), rot=(0.0, 0.0, 0.0, 1.0),
                          radius=1.0, half_width=0.5, density=1000.0, ke=1.0e5, kd=1000.0, kf=1000.0, mu=0.5):
        self._add_shape(body, pos, rot, GEO_CAPSULE, (radius, half_width, 0.0, 0.0), None, density, ke, kd, kf, mu)

    def add_shape_mesh(self, body, pos=(0.0, 0.0, 0.0), rot=(0.0, 0.0, 0.0, 1.0), mesh=None,
                       scale=(1.0, 1.0, 1.0), density=1000.0, ke=1.0e5, kd=1000.0, kf=1000.0, mu=0.5):
        self._add_shape(body, pos, rot, GEO_MESH, (scale[0], scale[1], scale[2], 0.0), mesh, density, ke, kd, kf, mu)

    def _add_shape(self, body, pos, rot, type, scale, src, density, ke, kd, kf, mu):
        self.shape_body.append(int(body))
        self.shape_transform.append(np_transform(pos, rot))
        self.shape_geo_type.append(int(type))
        self.shape_geo_scale.append((scale[0], scale[1], scale[2]))
        self.shape_geo_src.append(src)
        self.shape_materials.append((ke, kd, kf, mu))
        m, I = self._compute_shape_mass(type, scale, src, density)
        self._update_body_mass(body, m, I, np.asarray(pos, dtype=np.float64), np.asarray(rot, dtype=np.float64))

    # -- particles / deformables --------------------------------------------

    def add_particle(self, pos, vel, mass) -> int:
        self.particle_q.append(np.asarray(pos, dtype=np.float64))
        self.particle_qd.append(np.asarray(vel, dtype=np.float64))
        self.particle_mass.append(float(mass))
        return len(self.particle_q) - 1

    def add_spring(self, i, j, ke, kd, control):
        self.spring_indices.extend([int(i), int(j)])
        p = np.asarray(self.particle_q[i])
        q = np.asarray(self.particle_q[j])
        self.spring_rest_length.append(float(np.linalg.norm(p - q)))
        self.spring_stiffness.append(ke)
        self.spring_damping.append(kd)
        self.spring_control.append(control)

    def add_triangle(self, i, j, k) -> float:
        """FEM triangle; computes rest pose like model.py add_triangle."""
        p, q, r = (np.asarray(self.particle_q[x]) for x in (i, j, k))
        qp = q - p
        rp = r - p
        # local basis: x along qp, z normal
        n = np.cross(qp, rp)
        area = 0.5 * np.linalg.norm(n)
        e1 = qp / np.linalg.norm(qp)
        e3 = n / np.linalg.norm(n)
        e2 = np.cross(e3, e1)
        D = np.array([[np.dot(e1, qp), np.dot(e1, rp)], [np.dot(e2, qp), np.dot(e2, rp)]])
        inv_D = np.linalg.inv(D)
        self.tri_indices.append((int(i), int(j), int(k)))
        self.tri_poses.append(inv_D)
        self.tri_activations.append(0.0)
        return area

    def add_edge(self, i, j, k, l, rest=None):
        """Bending edge between tris (i,k,l) and (j,l,k) (Bridson). rest angle
        computed from the initial configuration when not given."""
        if rest is None:
            x1, x2, x3, x4 = (np.asarray(self.particle_q[x]) for x in (i, j, k, l))
            n1 = np.cross(x3 - x1, x4 - x1)
            n2 = np.cross(x4 - x2, x3 - x2)
            e = x4 - x3
            def _norm(v):
                return v / max(np.linalg.norm(v), 1e-12)
            n1, n2 = _norm(n1), _norm(n2)
            e_hat = _norm(e)
            cos_theta = np.dot(n1, n2)
            sin_theta = np.dot(np.cross(n1, n2), e_hat)
            rest = math.atan2(sin_theta, cos_theta)
        self.edge_indices.append((int(i), int(j), int(k), int(l)))
        self.edge_rest_angle.append(float(rest))

    def add_tetrahedron(self, i, j, k, l, k_mu=1.0e3, k_lambda=1.0e3, k_damp=0.0) -> float:
        p, q, r, s = (np.asarray(self.particle_q[x]) for x in (i, j, k, l))
        D = np.stack([q - p, r - p, s - p], axis=1)
        volume = np.linalg.det(D) / 6.0
        if volume <= 0.0:
            raise ValueError("inverted tetrahedral element")
        self.tet_indices.append((int(i), int(j), int(k), int(l)))
        self.tet_poses.append(np.linalg.inv(D))
        self.tet_activations.append(0.0)
        self.tet_materials.append((k_mu, k_lambda, k_damp))
        return float(volume)

    def add_cloth_grid(self, pos, rot, vel, dim_x, dim_y, cell_x, cell_y, mass,
                       reverse_winding=False, fix_left=False, fix_right=False,
                       fix_top=False, fix_bottom=False):
        """Regular cloth grid: particles + FEM triangles + bending hinges
        derived from mesh adjacency (the reference's add_cloth_grid,
        its triangulation and winding conventions included)."""
        start_vertex = len(self.particle_q)
        start_tri = len(self.tri_indices)

        def grid_index(x, y):
            return start_vertex + y * (dim_x + 1) + x

        for y in range(dim_y + 1):
            for x in range(dim_x + 1):
                local = np.array([x * cell_x, y * cell_y, 0.0])
                world = np_quat_rotate(rot, local) + np.asarray(pos, dtype=np.float64)
                m = mass
                if (x == 0 and fix_left) or (x == dim_x and fix_right) or \
                   (y == 0 and fix_bottom) or (y == dim_y and fix_top):
                    m = 0.0
                self.add_particle(world, vel, m)

                if x > 0 and y > 0:
                    if reverse_winding:
                        self.add_triangle(grid_index(x - 1, y - 1),
                                          grid_index(x, y - 1),
                                          grid_index(x, y))
                        self.add_triangle(grid_index(x - 1, y - 1),
                                          grid_index(x, y),
                                          grid_index(x - 1, y))
                    else:
                        self.add_triangle(grid_index(x - 1, y - 1),
                                          grid_index(x, y - 1),
                                          grid_index(x - 1, y))
                        self.add_triangle(grid_index(x, y - 1),
                                          grid_index(x, y),
                                          grid_index(x - 1, y))

        # bending hinges from triangle adjacency (util.py MeshAdjacency)
        self._add_adjacency_edges(self.tri_indices[start_tri:])

    def _add_adjacency_edges(self, tris):
        """One bending hinge per interior edge: add_edge(o0, o1, v0, v1)."""
        edges = {}
        for f, tri in enumerate(tris):
            for (i0, i1, o) in ((tri[0], tri[1], tri[2]),
                                (tri[1], tri[2], tri[0]),
                                (tri[2], tri[0], tri[1])):
                key = (min(i0, i1), max(i0, i1))
                if key in edges:
                    e = edges[key]
                    if e[3] == -1:
                        edges[key] = (e[0], e[1], e[2], o)
                else:
                    edges[key] = (i0, i1, o, -1)
        for (v0, v1, o0, o1) in edges.values():
            if o1 == -1:
                continue  # open boundary edge
            self.add_edge(o0, o1, v0, v1)

    def add_cloth_mesh(self, pos, rot, scale, vel, vertices, indices, density):
        """Cloth from a 2-manifold triangle mesh (model.py add_cloth_mesh):
        one FEM triangle per face (mass from area*density lumped to
        vertices), one bending hinge per interior edge."""
        start_vertex = len(self.particle_q)
        start_tri = len(self.tri_indices)
        tris = np.asarray(indices, dtype=np.int32).reshape(-1, 3)

        for v in vertices:
            world = np_quat_rotate(rot, np.asarray(v, dtype=np.float64) * scale)
            self.add_particle(world + np.asarray(pos, dtype=np.float64), vel, 0.0)

        for t in tris:
            area = self.add_triangle(*(start_vertex + t))
            # lump the face mass onto its vertices (model.py:1316-1325)
            for vi in t:
                self.particle_mass[start_vertex + int(vi)] += density * area / 3.0

        self._add_adjacency_edges(self.tri_indices[start_tri:])

    def add_soft_grid(self, pos, rot, vel, dim_x, dim_y, dim_z,
                      cell_x, cell_y, cell_z, density,
                      k_mu=1.0e3, k_lambda=1.0e3, k_damp=0.0,
                      fix_left=False, fix_right=False, fix_top=False,
                      fix_bottom=False):
        """Regular hexahedral soft-body grid, 5 tets per cell with parity-
        alternating splits + surface triangles (model.py add_soft_grid
        semantics: each particle carries the full cell mass)."""
        start_vertex = len(self.particle_q)
        mass = cell_x * cell_y * cell_z * density

        for z in range(dim_z + 1):
            for y in range(dim_y + 1):
                for x in range(dim_x + 1):
                    local = np.array([x * cell_x, y * cell_y, z * cell_z])
                    world = np_quat_rotate(rot, local) + np.asarray(pos, dtype=np.float64)
                    m = mass
                    if (fix_left and x == 0) or (fix_right and x == dim_x) or \
                       (fix_top and y == dim_y) or (fix_bottom and y == 0):
                        m = 0.0
                    self.add_particle(world, vel, m)

        faces = {}

        def add_face(i, j, k):
            key = tuple(sorted((i, j, k)))
            if key not in faces:
                faces[key] = (i, j, k)
            else:
                del faces[key]

        def add_tet(i, j, k, l):
            self.add_tetrahedron(i, j, k, l, k_mu, k_lambda, k_damp)
            add_face(i, k, j)
            add_face(j, k, l)
            add_face(i, j, l)
            add_face(i, l, k)

        def grid_index(x, y, z):
            return start_vertex + (dim_x + 1) * (dim_y + 1) * z + (dim_x + 1) * y + x

        for z in range(dim_z):
            for y in range(dim_y):
                for x in range(dim_x):
                    v0 = grid_index(x, y, z)
                    v1 = grid_index(x + 1, y, z)
                    v2 = grid_index(x + 1, y, z + 1)
                    v3 = grid_index(x, y, z + 1)
                    v4 = grid_index(x, y + 1, z)
                    v5 = grid_index(x + 1, y + 1, z)
                    v6 = grid_index(x + 1, y + 1, z + 1)
                    v7 = grid_index(x, y + 1, z + 1)

                    if (x & 1) ^ (y & 1) ^ (z & 1):
                        add_tet(v0, v1, v4, v3)
                        add_tet(v2, v3, v6, v1)
                        add_tet(v5, v4, v1, v6)
                        add_tet(v7, v6, v3, v4)
                        add_tet(v4, v1, v6, v3)
                    else:
                        add_tet(v1, v2, v5, v0)
                        add_tet(v3, v0, v7, v2)
                        add_tet(v4, v7, v0, v5)
                        add_tet(v6, v5, v2, v7)
                        add_tet(v5, v2, v7, v0)

        # surface triangles for rendering/contacts
        for v in faces.values():
            self.add_triangle(v[0], v[1], v[2])

    # -- inertia helpers ----------------------------------------------------

    @staticmethod
    def compute_sphere_inertia(density, r):
        v = 4.0 / 3.0 * math.pi * r ** 3
        m = density * v
        Ia = 2.0 / 5.0 * m * r * r
        return m, np.diag([Ia, Ia, Ia])

    @staticmethod
    def compute_capsule_inertia(density, r, l):
        ms = density * (4.0 / 3.0) * math.pi * r ** 3
        mc = density * math.pi * r * r * l
        m = ms + mc
        Ia = mc * (0.25 * r * r + (1.0 / 12.0) * l * l) + ms * (0.4 * r * r + 0.375 * r * l + 0.25 * l * l)
        Ib = (mc * 0.5 + ms * 0.4) * r * r
        return m, np.diag([Ib, Ia, Ia])

    @staticmethod
    def compute_box_inertia(density, w, h, d):
        v = w * h * d
        m = density * v
        Ia = 1.0 / 12.0 * m * (h * h + d * d)
        Ib = 1.0 / 12.0 * m * (w * w + d * d)
        Ic = 1.0 / 12.0 * m * (w * w + h * h)
        return m, np.diag([Ia, Ib, Ic])

    def _compute_shape_mass(self, type, scale, src, density):
        if density == 0:
            return 0.0, np.zeros((3, 3))
        if type == GEO_SPHERE:
            return self.compute_sphere_inertia(density, scale[0])
        if type == GEO_BOX:
            return self.compute_box_inertia(density, scale[0] * 2.0, scale[1] * 2.0, scale[2] * 2.0)
        if type == GEO_CAPSULE:
            return self.compute_capsule_inertia(density, scale[0], scale[1] * 2.0)
        if type == GEO_MESH:
            s = scale[0]
            return density * src.mass * s ** 3, density * src.I * s ** 5
        return 0.0, np.zeros((3, 3))

    def _update_body_mass(self, i, m, I, p, q):
        """Accumulate a shape's mass into its link COM."""
        if i == -1:
            return
        new_mass = self.body_mass[i] + m
        if new_mass == 0.0:
            return
        new_com = (self.body_com[i] * self.body_mass[i] + p * m) / new_mass
        com_offset = new_com - self.body_com[i]
        shape_offset = new_com - p
        new_inertia = transform_inertia(
            self.body_mass[i], self.body_inertia[i], com_offset, _np_quat_identity()
        ) + transform_inertia(m, I, shape_offset, q)
        self.body_mass[i] = new_mass
        self.body_inertia[i] = new_inertia
        self.body_com[i] = new_com

    # -- contact generation (host-side, once) -------------------------------

    def _collide_ground(self):
        body, point, dist, mat = [], [], [], []

        def add_contact(b, t, p0, d, m):
            body.append(b)
            point.append(np_transform_point(t, np.asarray(p0, dtype=np.float64)))
            dist.append(d)
            mat.append(self.shape_materials[m])

        for i in range(len(self.shape_geo_type)):
            X_bs = self.shape_transform[i]
            geo_type = self.shape_geo_type[i]
            scale = self.shape_geo_scale[i]
            if geo_type == GEO_SPHERE:
                add_contact(self.shape_body[i], X_bs, (0.0, 0.0, 0.0), scale[0], i)
            elif geo_type == GEO_CAPSULE:
                r, hw = scale[0], scale[1]
                add_contact(self.shape_body[i], X_bs, (-hw, 0.0, 0.0), r, i)
                add_contact(self.shape_body[i], X_bs, (hw, 0.0, 0.0), r, i)
            elif geo_type == GEO_BOX:
                e = scale
                for sx in (-1, 1):
                    for sy in (-1, 1):
                        for sz in (-1, 1):
                            add_contact(self.shape_body[i], X_bs, (sx * e[0], sy * e[1], sz * e[2]), 0.0, i)
            elif geo_type == GEO_MESH:
                mesh = self.shape_geo_src[i]
                for v in mesh.vertices:
                    add_contact(self.shape_body[i], X_bs, v * np.asarray(scale), 0.0, i)
        return body, point, dist, mat

    # -- finalize -----------------------------------------------------------

    def finalize(self) -> Model:
        """Freeze the scene into a Model (single articulation)."""
        if len(self.articulation_start) > 1:
            raise ValueError(
                "models hold exactly one articulation; batch robots over the "
                "env axis instead of concatenating builders"
            )

        f32 = np.float32

        # closing sentinels
        q_start = list(self.joint_q_start) + [len(self.joint_q)]
        qd_start = list(self.joint_qd_start) + [len(self.joint_qd)]

        c_body, c_point, c_dist, c_mat = self._collide_ground()
        topo = Topology(
            joint_type=tuple(self.joint_type),
            joint_parent=tuple(self.joint_parent),
            joint_q_start=tuple(q_start),
            joint_qd_start=tuple(qd_start),
            coord_count=len(self.joint_q),
            dof_count=len(self.joint_qd),
            contact_body=tuple(c_body),
            muscle_start=tuple(self.muscle_start + [len(self.muscle_links)]),
            muscle_links=tuple(self.muscle_links),
        )

        L = len(self.joint_type)
        # spatial inertia about each link COM
        body_I_m = np.stack(
            [spatial_matrix_from_inertia(self.body_inertia[i], self.body_mass[i]) for i in range(L)]
        ) if L else np.zeros((0, 6, 6))
        body_X_cm = np.stack(
            [np_transform(self.body_com[i], _np_quat_identity()) for i in range(L)]
        ) if L else np.zeros((0, 7))

        def arr(x, dtype=f32):
            return np.asarray(x, dtype=dtype)

        def opt(x, shape, dtype=f32):
            a = np.asarray(x, dtype=dtype)
            return None if a.size == 0 else a.reshape(shape)

        # bake a voxel SDF per GEO_MESH shape (scale applied to vertices);
        # soft contacts are particle-vs-shape, so only scenes with particles
        # pay the bake
        sdf_id = np.full(len(self.shape_geo_type), -1, dtype=np.int32)
        sdf_grids, sdf_lowers, sdf_spacings = [], [], []
        for i, gt in enumerate(self.shape_geo_type):
            src = self.shape_geo_src[i]
            if gt == GEO_MESH and src is not None and len(self.particle_q):
                sc = np.asarray(self.shape_geo_scale[i], dtype=np.float64)
                g, glo, gsp = bake_mesh_sdf(
                    src.vertices * sc, src.indices,
                    resolution=self.sdf_resolution)
                sdf_id[i] = len(sdf_grids)
                sdf_grids.append(g)
                sdf_lowers.append(glo)
                sdf_spacings.append(gsp)

        return Model(
            topology=topo,
            joint_X_pj=arr(np.stack(self.joint_X_pj) if L else np.zeros((0, 7))),
            joint_X_cm=arr(body_X_cm),
            joint_axis=arr(np.stack(self.joint_axis) if L else np.zeros((0, 3))),
            body_I_m=arr(body_I_m),
            joint_armature=arr(self.joint_armature),
            joint_target=arr(self.joint_target),
            joint_target_ke=arr(self.joint_target_ke),
            joint_target_kd=arr(self.joint_target_kd),
            joint_limit_lower=arr(self.joint_limit_lower),
            joint_limit_upper=arr(self.joint_limit_upper),
            joint_limit_ke=arr(self.joint_limit_ke),
            joint_limit_kd=arr(self.joint_limit_kd),
            gravity=arr([0.0, -9.8, 0.0]),
            joint_q_init=arr(self.joint_q),
            joint_qd_init=arr(self.joint_qd),
            contact_point=arr(np.stack(c_point) if c_point else np.zeros((0, 3))),
            contact_dist=arr(c_dist),
            contact_mat=arr(np.asarray(c_mat, dtype=f32).reshape(-1, 4)),
            muscle_points=arr(np.stack(self.muscle_points) if self.muscle_points else np.zeros((0, 3))),
            muscle_params=arr(np.asarray(self.muscle_params, dtype=f32).reshape(-1, 5)),
            shape_transform=opt(self.shape_transform, (-1, 7)),
            shape_body=opt(self.shape_body, (-1,), np.int32),
            shape_geo_type=opt(self.shape_geo_type, (-1,), np.int32),
            shape_geo_scale=opt(self.shape_geo_scale, (-1, 3)),
            shape_materials=opt(self.shape_materials, (-1, 4)),
            particle_q_init=opt(self.particle_q, (-1, 3)),
            particle_qd_init=opt(self.particle_qd, (-1, 3)),
            particle_inv_mass=opt(
                [1.0 / m if m > 0.0 else 0.0 for m in self.particle_mass],
                (-1,)),
            spring_indices=opt(self.spring_indices, (-1, 2), np.int32),
            spring_rest_length=opt(self.spring_rest_length, (-1,)),
            spring_stiffness=opt(self.spring_stiffness, (-1,)),
            spring_damping=opt(self.spring_damping, (-1,)),
            tri_indices=opt(self.tri_indices, (-1, 3), np.int32),
            tri_poses=opt(self.tri_poses, (-1, 2, 2)),
            tri_activations=opt(self.tri_activations, (-1,)),
            edge_indices=opt(self.edge_indices, (-1, 4), np.int32),
            edge_rest_angle=opt(self.edge_rest_angle, (-1,)),
            tet_indices=opt(self.tet_indices, (-1, 4), np.int32),
            tet_poses=opt(self.tet_poses, (-1, 3, 3)),
            tet_activations=opt(self.tet_activations, (-1,)),
            tet_materials=opt(self.tet_materials, (-1, 3)),
            shape_sdf_id=opt(sdf_id, (-1,), np.int32),
            sdf_grid=np.stack(sdf_grids) if sdf_grids else None,
            sdf_lower=np.stack(sdf_lowers) if sdf_lowers else None,
            sdf_spacing=np.stack(sdf_spacings) if sdf_spacings else None,
        )

"""Scene description: ModelBuilder (host-side) -> Model, a frozen copy of
the articulation part of the port's ``sim/model.py`` for the benchmark's
plain reference (its particles, cloth, FEM and mesh shapes left out).

A Model describes ONE articulated robot with its collision shapes;
environments are a batch axis. Model arrays stay float32 numpy on the
host: the plan (articulation.py) moves what it needs to the device once
per (Model, device, dtype).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


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

    @property
    def link_count(self):
        return self.topology.link_count

    @property
    def coord_count(self):
        return self.topology.coord_count

    @property
    def dof_count(self):
        return self.topology.dof_count






class ModelBuilder:
    """Host-side scene constructor. Build exactly one articulation, then
    ``finalize()``."""

    def __init__(self):
        # shapes
        self.shape_transform: List = []
        self.shape_body: List = []
        self.shape_geo_type: List = []
        self.shape_geo_scale: List = []
        self.shape_geo_src: List = []
        self.shape_materials: List = []

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


    def _add_shape(self, body, pos, rot, type, scale, src, density, ke, kd, kf, mu):
        self.shape_body.append(int(body))
        self.shape_transform.append(np_transform(pos, rot))
        self.shape_geo_type.append(int(type))
        self.shape_geo_scale.append((scale[0], scale[1], scale[2]))
        self.shape_geo_src.append(src)
        self.shape_materials.append((ke, kd, kf, mu))
        m, I = self._compute_shape_mass(type, scale, src, density)
        self._update_body_mass(body, m, I, np.asarray(pos, dtype=np.float64), np.asarray(rot, dtype=np.float64))

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
        )

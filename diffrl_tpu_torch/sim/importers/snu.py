"""SNU biomechanics importer, skeleton + muscle XML (port of
diffrl_tpu/sim/importers/snu.py; host numpy, unchanged semantics).

Parses the MASS/SNU human description used by the SNUHumanoid env: a
skeleton file of ``<Node>`` elements, each carrying a ``<Body>`` (box
geometry + world pose given as a 3x3 ``linear`` matrix and a
``translation``) and a ``<Joint>`` (world pose + type), plus an optional
muscle file of ``<Unit>`` elements whose polyline waypoints anchor to
bones by name.

Two-pass design:

1. :func:`_read_bones` / :func:`_read_muscle_units` turn the XML into
   plain numpy records (`_BoneRec`, `Muscle`) with **world-frame** poses
   and no builder access;
2. :func:`load_snu` walks the records in file order, selects the subset
   named by ``include`` (empty = everything), expresses each joint
   relative to its parent bone's joint frame, each collision box
   relative to its own joint frame, and re-anchors muscle waypoints into
   the joint-local frame of their bone.

Behavioral contract (the JAX package's loader, itself matched to the
original SNU loader for env parity): per-bone gain scaling by
``mass / 15`` (joint-limit gains linearly, joint stiffness by sqrt), box
density from ``mass / volume``, root links get an identity parent
transform, and a muscle unit is dropped entirely if any of its waypoints
lands on an excluded bone.
Enforced by tests/test_torch_envs_urdf_snu.py (field by field against the
JAX package's import of the same files).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple
import xml.etree.ElementTree as ET

import numpy as np

from ..model import (
    JOINT_BALL,
    JOINT_FIXED,
    JOINT_FREE,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    ModelBuilder,
    np_quat_from_matrix,
    np_transform,
    np_transform_inverse,
    np_transform_multiply,
    np_transform_point,
)

_JOINT_KINDS = {
    "Free": JOINT_FREE,
    "Ball": JOINT_BALL,
    "Revolute": JOINT_REVOLUTE,
    "Prismatic": JOINT_PRISMATIC,
    "Fixed": JOINT_FIXED,
}

# the heaviest bone in the SNU model; per-bone gains scale against it
_GAIN_REFERENCE_MASS = 15.0


@dataclass
class SnuGains:
    """Scene-wide gains; per-bone values derive from these via mass scaling."""

    joint_stiffness: float = 5.0
    joint_damping: float = 2.0
    joint_armature: float = 0.05
    limit_ke: float = 1000.0
    limit_kd: float = 10.0
    shape_ke: float = 5000.0
    shape_kd: float = 2000.0
    shape_kf: float = 1000.0
    shape_mu: float = 0.5


@dataclass
class _BoneRec:
    """One <Node>: world-frame poses + box geometry, pre-builder."""

    name: str
    parent_name: str
    joint_kind: int
    joint_axis: np.ndarray
    joint_world: np.ndarray  # 7-vector world pose of the joint frame
    body_world: np.ndarray  # 7-vector world pose of the box center
    half_extents: np.ndarray
    mass: float
    limit_lo: float
    limit_hi: float


@dataclass
class Muscle:
    """One muscle-tendon unit: waypoints stored joint-locally per bone."""

    name: str
    peak_force: float  # f0
    rest_length: float  # lm
    tendon_slack: float  # lt
    max_length: float  # lmax
    pennation: float
    links: List[int] = field(default_factory=list)
    points: List[np.ndarray] = field(default_factory=list)

    @property
    def muscle_strength(self) -> float:  # legacy accessor
        return self.peak_force


@dataclass
class SnuModel:
    """Result of :func:`load_snu`: name->link map + accepted muscles."""

    links: Dict[str, int]
    muscles: List[Muscle]
    coord_begin: int = 0
    dof_begin: int = 0
    muscle_begin: int = 0


# ---------------------------------------------------------------------------
# pass 1: XML -> records
# ---------------------------------------------------------------------------

def _pose7(elem: ET.Element) -> np.ndarray:
    """World pose from a <Transformation linear=... translation=...> node."""
    rot3x3 = np.fromstring(elem.get("linear"), sep=" ").reshape(3, 3)
    shift = np.fromstring(elem.get("translation"), sep=" ")
    return np_transform(shift, np_quat_from_matrix(rot3x3))


def _limit_attr(elem: ET.Element, key: str, fallback: float) -> float:
    raw = elem.get(key)
    return fallback if raw is None else float(np.fromstring(raw, sep=" ")[0])


def _read_bones(path) -> List[_BoneRec]:
    bones = []
    for node in ET.parse(path).getroot():
        if node.tag != "Node":
            continue
        body, joint = node.find("Body"), node.find("Joint")
        kind = _JOINT_KINDS[joint.get("type")]

        lo, hi = -1.0e3, 1.0e3
        if kind == JOINT_REVOLUTE:
            lo = _limit_attr(joint, "lower", lo)
            hi = _limit_attr(joint, "upper", hi)

        axis_raw = joint.get("axis")
        size = np.fromstring(body.get("size"), sep=" ")

        bones.append(
            _BoneRec(
                name=node.get("name"),
                parent_name=node.get("parent"),
                joint_kind=kind,
                joint_axis=(
                    np.zeros(3) if axis_raw is None
                    else np.fromstring(axis_raw, sep=" ")
                ),
                joint_world=_pose7(joint.find("Transformation")),
                body_world=_pose7(body.find("Transformation")),
                half_extents=size * 0.5,
                mass=float(body.get("mass")),
                limit_lo=lo,
                limit_hi=hi,
            )
        )
    return bones


def _read_muscle_units(path) -> List[Tuple[Muscle, List[Tuple[str, np.ndarray]]]]:
    """Each unit paired with its raw (bone-name, world-point) waypoints."""
    units = []
    for unit in ET.parse(path).getroot():
        if unit.tag != "Unit":
            continue
        m = Muscle(
            name=unit.get("name"),
            peak_force=float(unit.get("f0")),
            rest_length=float(unit.get("lm")),
            tendon_slack=float(unit.get("lt")),
            max_length=float(unit.get("lmax")),
            pennation=float(unit.get("pen_angle")),
        )
        anchors = [
            (wp.get("body"), np.fromstring(wp.get("p"), sep=" "))
            for wp in unit.iter("Waypoint")
        ]
        units.append((m, anchors))
    return units


# ---------------------------------------------------------------------------
# pass 2: records -> builder
# ---------------------------------------------------------------------------

def load_snu(
    skeleton_path,
    muscle_path,
    builder: ModelBuilder,
    include: Sequence[str] = (),
    gains: Optional[SnuGains] = None,
) -> SnuModel:
    """Build one articulation (and its muscles) from SNU XML files.

    ``include``: bone names to keep (empty keeps all). Bones outside the
    set still contribute their joint frames (children/waypoints resolve
    against them) but produce no links, and muscles touching them are
    dropped.
    """
    g = gains or SnuGains()
    out = SnuModel(
        links={},
        muscles=[],
        coord_begin=len(builder.joint_q),
        dof_begin=len(builder.joint_qd),
        muscle_begin=len(builder.muscle_activation),
    )
    keep = set(include)
    joint_frames: Dict[str, np.ndarray] = {}

    builder.add_articulation()

    for bone in _read_bones(skeleton_path):
        joint_frames[bone.name] = bone.joint_world
        parent_link = out.links.get(bone.parent_name, -1)

        if keep and bone.name not in keep:
            out.links[bone.name] = -1
            continue

        inv_joint = np_transform_inverse(bone.joint_world)
        if parent_link == -1:
            x_parent_joint = np_transform(np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
        else:
            x_parent_joint = np_transform_multiply(
                np_transform_inverse(joint_frames[bone.parent_name]),
                bone.joint_world,
            )
        box_local = np_transform_multiply(inv_joint, bone.body_world)

        heaviness = bone.mass / _GAIN_REFERENCE_MASS
        link = builder.add_link(
            parent=parent_link,
            X_pj=x_parent_joint,
            axis=bone.joint_axis,
            type=bone.joint_kind,
            limit_lower=bone.limit_lo,
            limit_upper=bone.limit_hi,
            limit_ke=g.limit_ke * heaviness,
            limit_kd=g.limit_kd * heaviness,
            stiffness=g.joint_stiffness * math.sqrt(heaviness),
            damping=g.joint_damping,
            armature=g.joint_armature,
        )
        hx, hy, hz = bone.half_extents
        builder.add_shape_box(
            body=link,
            pos=box_local[0:3],
            rot=box_local[3:7],
            hx=hx,
            hy=hy,
            hz=hz,
            density=bone.mass / float(8.0 * hx * hy * hz),
            ke=g.shape_ke,
            kd=g.shape_kd,
            kf=g.shape_kf,
            mu=g.shape_mu,
        )
        out.links[bone.name] = link

    if muscle_path is not None:
        for muscle, anchors in _read_muscle_units(muscle_path):
            if any(out.links.get(name, -1) == -1 for name, _ in anchors):
                continue  # touches an excluded bone -> drop the whole unit
            for name, world_pt in anchors:
                muscle.links.append(out.links[name])
                muscle.points.append(
                    np_transform_point(
                        np_transform_inverse(joint_frames[name]), world_pt
                    )
                )
            builder.add_muscle(
                muscle.links,
                muscle.points,
                f0=muscle.peak_force,
                lm=muscle.rest_length,
                lt=muscle.tendon_slack,
                lmax=muscle.max_length,
                pen=muscle.pennation,
            )
            out.muscles.append(muscle)

    return out


class Skeleton:
    """Constructor-style wrapper kept for the original env call signature."""

    def __init__(
        self,
        skeleton_file,
        muscle_file,
        builder: ModelBuilder,
        filter=(),
        stiffness=5.0,
        damping=2.0,
        contact_ke=5000.0,
        contact_kd=2000.0,
        contact_kf=1000.0,
        contact_mu=0.5,
        limit_ke=1000.0,
        limit_kd=10.0,
        armature=0.05,
    ):
        loaded = load_snu(
            skeleton_file,
            muscle_file,
            builder,
            include=tuple(filter),
            gains=SnuGains(
                joint_stiffness=stiffness,
                joint_damping=damping,
                joint_armature=armature,
                limit_ke=limit_ke,
                limit_kd=limit_kd,
                shape_ke=contact_ke,
                shape_kd=contact_kd,
                shape_kf=contact_kf,
                shape_mu=contact_mu,
            ),
        )
        self.model = loaded
        self.muscles = loaded.muscles
        self.node_map = loaded.links

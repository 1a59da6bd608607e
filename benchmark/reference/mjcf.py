"""MJCF (MuJoCo XML) importer, a frozen copy of the port's
``sim/importers/mjcf.py`` for the benchmark's plain reference (host numpy) — two-phase, record-driven.

Phase 1 flattens the ``<worldbody>`` tree into a flat list of typed
``_BodyRec`` records via an explicit work stack (no recursion).  Phase 2
replays the records through the :class:`ModelBuilder`, carrying the
"anchor" frame (position of the innermost joint created so far) per
kinematic chain.

Behavioral contract (required for trajectory parity with the reference
loader):

- one engine link per ``<joint>`` element; multi-joint bodies become a
  chain of zero-offset links,
- geoms attach to the innermost link of their body and are expressed
  relative to that body's last joint position,
- only sphere and capsule geoms are supported; MuJoCo's z-aligned /
  fromto capsules are re-expressed as the engine's x-axis capsules,
- joint ranges default to +/-170 degrees when ``limited`` is absent and
  are converted from degrees unless ``angles_in_radians`` is set,
- body orientations are ignored (none of the supported assets use them).

Enforced by tests/test_torch_model.py (field-by-field against the JAX
package's import of the same file).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional
import xml.etree.ElementTree as ET

import numpy as np

from .model import (
    JOINT_BALL,
    JOINT_FIXED,
    JOINT_FREE,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    ModelBuilder,
    np_quat_from_axis_angle,
    np_quat_mul,
    np_transform,
)

_JOINT_KINDS = {
    "hinge": JOINT_REVOLUTE,
    "slide": JOINT_PRISMATIC,
    "ball": JOINT_BALL,
    "free": JOINT_FREE,
    "fixed": JOINT_FIXED,
}

_IDENT_Q = np.array([0.0, 0.0, 0.0, 1.0])
# quaternion taking the engine's +x capsule axis to MuJoCo's +z convention
_Z_TO_X = np_quat_from_axis_angle((0.0, 1.0, 0.0), -math.pi * 0.5)


# ---------------------------------------------------------------------------
# attribute readers
# ---------------------------------------------------------------------------

def _vec(elem: ET.Element, name: str, fallback) -> np.ndarray:
    raw = elem.get(name)
    if raw is None:
        return np.asarray(fallback, dtype=np.float64)
    return np.fromstring(raw, sep=" ")


def _scalar(elem: ET.Element, name: str, fallback: float) -> float:
    raw = elem.get(name)
    return fallback if raw is None else float(raw)


def _flag(elem: ET.Element, name: str, fallback: bool) -> bool:
    raw = elem.get(name)
    return fallback if raw is None else raw == "true"


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else v


def _axis_to_x_quat(direction: np.ndarray) -> np.ndarray:
    """Quaternion rotating so an x-axis capsule lies along `direction`.

    Convention pinned by the parity fixtures: rotate about
    normalize(direction x x-hat) by -acos(direction . x-hat).
    """
    x_hat = np.array([1.0, 0.0, 0.0])
    angle = math.acos(float(np.clip(np.dot(direction, x_hat), -1.0, 1.0)))
    pivot = _unit(np.cross(direction, x_hat))
    return np_quat_from_axis_angle(pivot, -angle)


# ---------------------------------------------------------------------------
# phase 1: XML -> records
# ---------------------------------------------------------------------------

@dataclass
class _JointRec:
    kind: int
    axis: np.ndarray
    pos: np.ndarray
    lo: float
    hi: float
    stiffness: float
    damping: float
    armature: float


@dataclass
class _GeomRec:
    shape: str  # "sphere" | "capsule"
    pos: np.ndarray
    rot: np.ndarray
    radius: float
    half_len: float = 0.0


@dataclass
class _BodyRec:
    parent: int  # index into the record list; -1 for worldbody children
    offset: np.ndarray  # body pos in the parent body's frame
    joints: List[_JointRec] = field(default_factory=list)
    geoms: List[_GeomRec] = field(default_factory=list)


@dataclass
class MjcfOptions:
    """Scene-wide defaults applied while loading (engine units)."""

    density: float = 1000.0
    joint_stiffness: float = 0.0
    joint_damping: float = 1.0
    joint_armature: float = 0.01
    shape_ke: float = 1.0e4
    shape_kd: float = 1.0e4
    shape_kf: float = 1.0e3
    shape_mu: float = 0.5
    joint_limit_ke: float = 100.0
    joint_limit_kd: float = 10.0
    angles_in_radians: bool = False
    stiffness_from_file: bool = False
    armature_from_file: bool = False


def _read_joint(elem: ET.Element, opts: MjcfOptions) -> _JointRec:
    if _flag(elem, "limited", True):
        if opts.angles_in_radians:
            lo, hi = _vec(elem, "range", (math.radians(-170.0), math.radians(170.0)))
        else:
            lo, hi = np.deg2rad(_vec(elem, "range", (-170.0, 170.0)))
    else:
        lo, hi = -1.0e6, 1.0e6
    return _JointRec(
        kind=_JOINT_KINDS[elem.get("type", "hinge")],
        axis=_unit(_vec(elem, "axis", (0.0, 0.0, 0.0))),
        pos=_vec(elem, "pos", (0.0, 0.0, 0.0)),
        lo=float(lo),
        hi=float(hi),
        stiffness=(
            _scalar(elem, "stiffness", opts.joint_stiffness)
            if opts.stiffness_from_file
            else opts.joint_stiffness
        ),
        damping=_scalar(elem, "damping", opts.joint_damping),
        armature=(
            _scalar(elem, "armature", opts.joint_armature)
            if opts.armature_from_file
            else opts.joint_armature
        ),
    )


def _read_geom(elem: ET.Element) -> Optional[_GeomRec]:
    shape = elem.get("type")
    size = _vec(elem, "size", [1.0])

    if shape == "sphere":
        return _GeomRec(
            shape="sphere",
            pos=_vec(elem, "pos", (0.0, 0.0, 0.0)),
            rot=_vec(elem, "quat", _IDENT_Q),
            radius=float(size[0]),
        )

    if shape == "capsule":
        if elem.get("fromto") is not None:
            ends = _vec(elem, "fromto", (0.0, 0.0, 0.0, 1.0, 0.0, 0.0))
            head, tail = ends[:3], ends[3:6]
            return _GeomRec(
                shape="capsule",
                pos=(head + tail) * 0.5,
                rot=_axis_to_x_quat(_unit(tail - head)),
                radius=float(size[0]),
                half_len=float(np.linalg.norm(tail - head) * 0.5),
            )
        # plain capsule: MuJoCo z-axis convention, optional axisangle/quat
        rot = _vec(elem, "quat", _IDENT_Q)
        if elem.get("axisangle") is not None:
            aa = _vec(elem, "axisangle", (0.0, 1.0, 0.0, 0.0))
            rot = np_quat_from_axis_angle(aa[:3], float(aa[3]))
        if elem.get("quat") is not None:
            rot = _vec(elem, "quat", _IDENT_Q)
        return _GeomRec(
            shape="capsule",
            pos=_vec(elem, "pos", (0.0, 0.0, 0.0)),
            rot=np_quat_mul(rot, _Z_TO_X),
            radius=float(size[0]),
            half_len=float(size[1]),
        )

    return None  # unsupported geom kinds are skipped


def _flatten(worldbody: ET.Element, opts: MjcfOptions) -> List[_BodyRec]:
    """Depth-first flatten of the body tree into indexable records."""
    records: List[_BodyRec] = []
    stack = [(child, -1) for child in reversed(worldbody.findall("body"))]
    while stack:
        elem, parent_idx = stack.pop()
        rec = _BodyRec(parent=parent_idx, offset=_vec(elem, "pos", (0.0, 0.0, 0.0)))
        for j in elem.findall("joint"):
            rec.joints.append(_read_joint(j, opts))
        for g in elem.findall("geom"):
            geom = _read_geom(g)
            if geom is not None:
                rec.geoms.append(geom)
        records.append(rec)
        idx = len(records) - 1
        for child in reversed(elem.findall("body")):
            stack.append((child, idx))
    return records


# ---------------------------------------------------------------------------
# phase 2: records -> builder calls
# ---------------------------------------------------------------------------

def _emit(records: List[_BodyRec], builder: ModelBuilder, opts: MjcfOptions) -> None:
    # per-record chain state: (innermost link index, anchor = last joint pos)
    chain: List[tuple] = []

    for rec in records:
        if rec.parent == -1:
            link, anchor = -1, np.zeros(3)
        else:
            link, anchor = chain[rec.parent]

        pending = rec.offset  # body offset, consumed by the first joint
        for joint in rec.joints:
            shift = np.zeros(3) if link == -1 else pending
            link = builder.add_link(
                link,
                X_pj=np_transform(shift + joint.pos - anchor, _IDENT_Q),
                axis=joint.axis,
                type=joint.kind,
                limit_lower=joint.lo,
                limit_upper=joint.hi,
                limit_ke=opts.joint_limit_ke,
                limit_kd=opts.joint_limit_kd,
                stiffness=joint.stiffness,
                damping=joint.damping,
                armature=joint.armature,
            )
            pending, anchor = np.zeros(3), joint.pos

        contact = dict(
            density=opts.density,
            ke=opts.shape_ke,
            kd=opts.shape_kd,
            kf=opts.shape_kf,
            mu=opts.shape_mu,
        )
        for geom in rec.geoms:
            if geom.shape == "sphere":
                builder.add_shape_sphere(
                    link, pos=geom.pos - anchor, rot=geom.rot,
                    radius=geom.radius, **contact,
                )
            else:
                builder.add_shape_capsule(
                    link, pos=geom.pos - anchor, rot=geom.rot,
                    radius=geom.radius, half_width=geom.half_len, **contact,
                )

        chain.append((link, anchor))


def load_mjcf(path, builder: ModelBuilder, options: Optional[MjcfOptions] = None) -> None:
    """Load an MJCF robot description into `builder` as one articulation."""
    opts = options or MjcfOptions()
    worldbody = ET.parse(path).getroot().find("worldbody")
    builder.add_articulation()
    _emit(_flatten(worldbody, opts), builder, opts)


def parse_mjcf(
    filename,
    builder: ModelBuilder,
    density=1000.0,
    stiffness=0.0,
    damping=1.0,
    contact_ke=1e4,
    contact_kd=1e4,
    contact_kf=1e3,
    contact_mu=0.5,
    limit_ke=100.0,
    limit_kd=10.0,
    armature=0.01,
    radians=False,
    load_stiffness=False,
    load_armature=False,
):
    """Keyword-style wrapper over :func:`load_mjcf` (existing env call sites)."""
    load_mjcf(
        filename,
        builder,
        MjcfOptions(
            density=density,
            joint_stiffness=stiffness,
            joint_damping=damping,
            joint_armature=armature,
            shape_ke=contact_ke,
            shape_kd=contact_kd,
            shape_kf=contact_kf,
            shape_mu=contact_mu,
            joint_limit_ke=limit_ke,
            joint_limit_kd=limit_kd,
            angles_in_radians=radians,
            stiffness_from_file=load_stiffness,
            armature_from_file=load_armature,
        ),
    )

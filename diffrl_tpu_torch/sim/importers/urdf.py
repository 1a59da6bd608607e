"""URDF importer (port of diffrl_tpu/sim/importers/urdf.py; host numpy,
unchanged semantics).

Self-contained xml.etree parser: links + revolute/continuous/prismatic/
fixed/floating joints with origins/limits/damping, box/sphere/cylinder
collision shapes (cylinders become x-aligned capsules), triangle-mesh
colliders (OBJ/STL through ``importers.meshio``) as GEO_MESH shapes, and
optional ``<inertial>`` mass-property overrides.

Enforced by tests/test_torch_envs_urdf_snu.py (field by field against the
JAX package's import of the same file).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET

import numpy as np

from ..model import (
    JOINT_FIXED,
    JOINT_FREE,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    Mesh,
    ModelBuilder,
    np_quat_from_axis_angle,
    np_quat_mul,
    np_quat_to_matrix,
    np_rpy2quat,
    np_transform,
    np_transform_identity,
)
from .meshio import load_mesh


def _origin(node):
    """(xyz, rpy-quat) of an <origin> child, identity when absent."""
    o = node.find("origin") if node is not None else None
    if o is None:
        return np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])
    xyz = np.fromstring(o.attrib.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(o.attrib.get("rpy", "0 0 0"), sep=" ")
    return xyz, np_rpy2quat(*rpy)


def _resolve_mesh_path(urdf_dir, raw):
    """Resolve a URDF mesh filename: package:// URIs resolve best-effort by
    stripping the scheme and walking up from the URDF directory."""
    if raw.startswith("package://"):
        tail = raw[len("package://"):]
        probe = urdf_dir
        for _ in range(6):
            cand = os.path.join(probe, tail)
            if os.path.exists(cand):
                return cand
            # also try dropping the leading package-name component
            sub = tail.split("/", 1)
            if len(sub) == 2 and os.path.exists(os.path.join(probe, sub[1])):
                return os.path.join(probe, sub[1])
            probe = os.path.dirname(probe)
        return os.path.join(urdf_dir, tail)
    if os.path.isabs(raw):
        return raw
    return os.path.join(urdf_dir, raw)


def _add_collisions(builder, link, link_node, ke, kd, kf, mu, urdf_dir="."):
    for collision in link_node.findall("collision"):
        pos, rot = _origin(collision)
        geo = collision.find("geometry")
        if geo is None:
            continue
        box = geo.find("box")
        sphere = geo.find("sphere")
        cylinder = geo.find("cylinder")
        mesh = geo.find("mesh")
        if box is not None:
            size = np.fromstring(box.attrib["size"], sep=" ")
            builder.add_shape_box(
                link, pos, rot,
                size[0] * 0.5, size[1] * 0.5, size[2] * 0.5,
                ke=ke, kd=kd, kf=kf, mu=mu,
            )
        if sphere is not None:
            builder.add_shape_sphere(
                link, pos, rot, float(sphere.attrib["radius"]),
                ke=ke, kd=kd, kf=kf, mu=mu,
            )
        if cylinder is not None:
            # URDF cylinders are z-aligned; engine capsules are x-aligned
            r = np_quat_from_axis_angle((0.0, 1.0, 0.0), math.pi * 0.5)
            builder.add_shape_capsule(
                link, pos, np_quat_mul(rot, r),
                float(cylinder.attrib["radius"]),
                float(cylinder.attrib["length"]) * 0.5,
                ke=ke, kd=kd, kf=kf, mu=mu,
            )
        if mesh is not None:
            path = _resolve_mesh_path(urdf_dir, mesh.attrib["filename"])
            scale = np.fromstring(mesh.attrib.get("scale", "1 1 1"), sep=" ")
            verts, faces = load_mesh(path)
            builder.add_shape_mesh(
                link, pos, rot, mesh=Mesh(verts, faces),
                scale=(float(scale[0]), float(scale[1]), float(scale[2])),
                ke=ke, kd=kd, kf=kf, mu=mu,
            )


def _apply_inertial(builder, link, link_node):
    """Override the link's density-derived mass properties with the URDF
    ``<inertial>`` block (mass, COM origin, rotated inertia tensor)."""
    inertial = link_node.find("inertial")
    if inertial is None or link == -1:
        return
    pos, rot = _origin(inertial)
    mass_node = inertial.find("mass")
    mass = float(mass_node.attrib["value"]) if mass_node is not None else 0.0
    I = np.zeros((3, 3))
    tensor = inertial.find("inertia")
    if tensor is not None:
        a = tensor.attrib
        xx, yy, zz = (float(a.get(k, "0")) for k in ("ixx", "iyy", "izz"))
        xy, xz, yz = (float(a.get(k, "0")) for k in ("ixy", "ixz", "iyz"))
        I = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    R = np_quat_to_matrix(rot)
    builder.body_mass[link] = mass
    builder.body_com[link] = np.asarray(pos, dtype=np.float64)
    builder.body_inertia[link] = R @ I @ R.T


def urdf_load(
    builder: ModelBuilder,
    filename,
    xform,
    floating=False,
    armature=0.0,
    shape_ke=1.0e4,
    shape_kd=1.0e4,
    shape_kf=1.0e2,
    shape_mu=0.25,
    limit_ke=100.0,
    limit_kd=1.0,
    parse_inertial=False,
):
    tree = ET.parse(filename)
    robot = tree.getroot()
    urdf_dir = os.path.dirname(os.path.abspath(filename))

    links = robot.findall("link")
    joints = robot.findall("joint")
    link_map = {l.attrib["name"]: l for l in links}
    link_index = {}

    builder.add_articulation()

    xform = np.asarray(xform, dtype=np.float64)

    # the root is the link that is never any joint's child (URDF does not
    # require it to be listed first, nor joints to be topologically sorted)
    child_names = {j.find("child").attrib["link"] for j in joints}
    root_names = [l.attrib["name"] for l in links if l.attrib["name"] not in child_names]
    if len(root_names) != 1:
        raise ValueError(f"URDF must have exactly one root link, found {root_names}")
    root_name = root_names[0]

    if floating:
        root = builder.add_link(-1, np_transform_identity(), (0, 0, 0), JOINT_FREE)
        start = builder.joint_q_start[root]
        for k in range(7):
            builder.joint_q[start + k] = float(xform[k])
    else:
        root = builder.add_link(-1, xform, (0, 0, 0), JOINT_FIXED)

    _add_collisions(builder, root, link_map[root_name], shape_ke, shape_kd, shape_kf, shape_mu, urdf_dir)
    if parse_inertial:
        _apply_inertial(builder, root, link_map[root_name])
    link_index[root_name] = root

    # process joints parent-first regardless of document order
    pending = list(joints)
    ordered = []
    known = {root_name}
    while pending:
        progressed = False
        remaining = []
        for j in pending:
            if j.find("parent").attrib["link"] in known:
                ordered.append(j)
                known.add(j.find("child").attrib["link"])
                progressed = True
            else:
                remaining.append(j)
        pending = remaining
        if not progressed and pending:
            bad = [j.attrib.get("name", "?") for j in pending]
            raise ValueError(f"URDF joints form no tree from root: {bad}")

    for joint in ordered:
        jtype = None
        axis = (0.0, 0.0, 0.0)
        t = joint.attrib["type"]
        if t in ("revolute", "continuous"):
            jtype = JOINT_REVOLUTE
        elif t == "prismatic":
            jtype = JOINT_PRISMATIC
        elif t == "fixed":
            jtype = JOINT_FIXED
        elif t == "floating":
            jtype = JOINT_FREE
        else:
            raise ValueError(
                f"unsupported URDF joint type '{t}' "
                f"(joint '{joint.attrib.get('name', '?')}')"
            )
        if jtype in (JOINT_REVOLUTE, JOINT_PRISMATIC):
            ax = joint.find("axis")
            if ax is not None:
                axis = np.fromstring(ax.attrib.get("xyz", "1 0 0"), sep=" ")

        parent_name = joint.find("parent").attrib["link"]
        child_name = joint.find("child").attrib["link"]
        parent = link_index[parent_name]

        pos, rot = _origin(joint)

        lower, upper, damping = -1.0e3, 1.0e3, 0.0
        limit = joint.find("limit")
        if limit is not None:
            if "lower" in limit.attrib:
                lower = float(limit.attrib["lower"])
            if "upper" in limit.attrib:
                upper = float(limit.attrib["upper"])
        dynamics = joint.find("dynamics")
        if dynamics is not None and "damping" in dynamics.attrib:
            damping = float(dynamics.attrib["damping"])

        link = builder.add_link(
            parent=parent,
            X_pj=np_transform(pos, rot),
            axis=axis,
            type=jtype,
            limit_lower=lower,
            limit_upper=upper,
            limit_ke=limit_ke,
            limit_kd=limit_kd,
            damping=damping,
        )
        _add_collisions(builder, link, link_map[child_name], shape_ke, shape_kd, shape_kf, shape_mu, urdf_dir)
        if parse_inertial:
            _apply_inertial(builder, link, link_map[child_name])
        link_index[child_name] = link

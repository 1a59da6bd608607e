"""Procedural articulation builders (port of
diffrl_tpu/sim/importers/procedural.py): the reference's ``build_tree``, a
serial chain of capsule links on z-axis revolute joints (the upstream
"tree" recursion builds a chain), optionally with a free-joint root."""

from __future__ import annotations

from ..model import JOINT_FREE, JOINT_REVOLUTE, np_quat_from_axis_angle, \
    np_transform


def build_tree(
    builder,
    angle,
    max_depth,
    width=0.05,
    length=0.25,
    density=1000.0,
    joint_stiffness=0.0,
    joint_damping=0.0,
    shape_ke=1.0e4,
    shape_kd=1.0e3,
    shape_kf=1.0e2,
    shape_mu=0.5,
    floating=False,
):
    """Append a capsule chain of ``max_depth`` links to ``builder``; returns
    the last link."""
    parent = -1
    for depth in range(max_depth):
        X_pj = np_transform(
            (length * 2.0, 0.0, 0.0),
            np_quat_from_axis_angle((0.0, 0.0, 1.0), angle),
        )
        jtype = JOINT_REVOLUTE
        if depth == 0 and floating:
            X_pj = np_transform((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))
            jtype = JOINT_FREE

        link = builder.add_link(
            parent,
            X_pj,
            (0.0, 0.0, 1.0),
            jtype,
            stiffness=joint_stiffness,
            damping=joint_damping,
        )
        builder.add_shape_capsule(
            link,
            pos=(length, 0.0, 0.0),
            radius=width,
            half_width=length,
            density=density,
            ke=shape_ke,
            kd=shape_kd,
            kf=shape_kf,
            mu=shape_mu,
        )
        parent = link
    return parent

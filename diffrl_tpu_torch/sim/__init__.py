"""Articulated-body engine (port of diffrl_tpu/sim, the articulation subset
on the forward rollout path)."""

from .model import (
    GEO_BOX,
    GEO_CAPSULE,
    GEO_MESH,
    GEO_NONE,
    GEO_PLANE,
    GEO_SDF,
    GEO_SPHERE,
    JOINT_BALL,
    JOINT_FIXED,
    JOINT_FREE,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    Model,
    ModelBuilder,
    State,
    Topology,
)
from .articulation_lb import (
    refresh_substep_lb,
    simulate_batched_lb,
    substep_lb,
)

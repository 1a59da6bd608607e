"""Tensor math shared by the env layer (port of diffrl_tpu/ops, the subset the
ported envs use; the engine carries its own env-minor math)."""

from .quat import (
    quat_conjugate,
    quat_from_angle_axis,
    quat_mul,
    quat_rotate,
    safe_normalize,
)

__all__ = [
    "quat_conjugate",
    "quat_from_angle_axis",
    "quat_mul",
    "quat_rotate",
    "safe_normalize",
]

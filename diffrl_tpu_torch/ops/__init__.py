"""Tensor math (port of diffrl_tpu/ops): quaternions, transforms, spatial
algebra and small dense linear algebra, batched over leading dimensions."""

from .quat import (
    quat,
    quat_conjugate,
    quat_from_angle_axis,
    quat_from_axis_angle,
    quat_identity,
    quat_inverse,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
    quat_to_matrix,
)
from .transform import (
    transform,
    transform_get_rotation,
    transform_get_translation,
    transform_identity,
    transform_inverse,
    transform_multiply,
    transform_point,
    transform_vector,
)
from .spatial import (
    safe_normalize,
    skew,
    spatial_adjoint,
    spatial_bottom,
    spatial_cross,
    spatial_cross_dual,
    spatial_dot,
    spatial_top,
    spatial_inertia_matvec,
    spatial_transform_inertia,
    spatial_transform_twist,
    spatial_transform_wrench,
    spatial_vector,
)
from .linalg import (
    chol_inverse,
    chol_regularized,
    cho_solve_lower,
    cholesky_unrolled,
    solve_frozen_chol,
    solve_frozen_inv,
)

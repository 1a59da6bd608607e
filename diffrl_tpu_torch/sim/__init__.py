"""The simulator (port of diffrl_tpu/sim): the scene model and builder, the
articulated engine in env-minor layout with its replay reverse pass, the
per-env articulation API and the coupled articulation + particle engine
with its remat backward, particles, rigid bodies and XPBD."""

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
    Mesh,
    Model,
    ModelBuilder,
    State,
    Topology,
    bake_mesh_sdf,
)
from .articulation import (
    DynamicsAux,
    articulation_substep,
    coupled_substep,
    eval_fk,
    eval_ground_contacts,
    eval_id,
    eval_mass_matrix,
    eval_muscles,
    eval_spatial_inertias,
    eval_tau,
    simulate,
    simulate_xpbd,
)
from .articulation_lb import (
    refresh_substep_lb,
    simulate_batched_lb,
    substep_lb,
    substep_vjp_lb,
)
from .integrators import SemiImplicitIntegrator, XPBDIntegrator
from . import particles

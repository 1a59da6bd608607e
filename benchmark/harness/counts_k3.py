"""Floating-point operations and bytes of one launch of K3
(``mass_matrix_vjp_kernel``, the mass matrix's adjoint): a frozen copy of
the port's ``mass_matrix_vjp_{bytes,flops}`` (``sim/substep_kernels.py``),
applied to the reference's model as ``counts.py`` applies K1's and K2's.
The yardstick of ``k3_roofline``."""

from __future__ import annotations

from ..reference.articulation import _plan_for
from ..reference.model import (JOINT_BALL, JOINT_FIXED, JOINT_FREE,
                               JOINT_PRISMATIC, JOINT_REVOLUTE)
from .counts import (_ADJ_CROSS, _ADJ_QROT, _ADJ_QROT_Q, _ADJ_TINV,
                     _ADJ_TMUL, _ADJ_TMUL_T, _ADJ_TMUL_U, _CROSS, _QROT,
                     _TINV, _TMUL, _TWIST, _const_words)

# motion-subspace columns of each joint type in a model with a ball joint
_SUBSPACE_COLS = {JOINT_PRISMATIC: 1, JOINT_REVOLUTE: 1, JOINT_BALL: 3,
                  JOINT_FIXED: 0, JOINT_FREE: 0}

# one gram matvec T^T Im T x, and the cotangent of ti in <g, T^T Im T x>
_GRAM = _TINV + _TWIST + 18 + (2 * _QROT + _CROSS + 3)
_ADJ_GRAM = (_TWIST + 18 + _CROSS + 3 + 2 * (_ADJ_QROT + 4) + 3
             + _ADJ_CROSS + 18 + _ADJ_CROSS + 2 * _ADJ_QROT_Q)


def mass_matrix_vjp_bytes(model, E: int) -> int:
    """q, the cotangent of H, the dq it adds to and the constant buffer
    read once, dq written once."""
    C, D = model.coord_count, model.dof_count
    return 4 * (E * (3 * C + D * D) + _const_words(model))


def mass_matrix_vjp_flops(model, E: int) -> int:
    """Per (link, dof of an ancestor or of the link) pair the composite
    column's gram matvec, its transpose on the column's cotangent and the
    link frame's adjoint; per ordered pair of dofs on one line of ancestry
    the entries' cotangents; per link fk, its frames and columns and their
    adjoints. Adjoints taken of constants are not counted."""
    topo = model.topology
    plan = _plan_for(model, "cpu")
    link_pairs = int(plan.subtree[plan.dof_row].sum())
    dof_pairs = int(plan.anc_pair.sum())
    n = link_pairs * (2 * (_GRAM + 6) + _ADJ_GRAM) + dof_pairs * 26
    for link in range(topo.link_count):
        t = topo.joint_type[link]
        root = topo.joint_parent[link] < 0
        cols = _SUBSPACE_COLS[t]
        col = _QROT + (0 if t == JOINT_PRISMATIC else _CROSS)
        n += 4 * _TMUL + {JOINT_REVOLUTE: 6, JOINT_PRISMATIC: 3}.get(t, 0)
        n += cols * col
        n += _TINV + _ADJ_TINV + _ADJ_TMUL_T
        if not root:
            n += 7 + _TMUL + _ADJ_TMUL
            if cols:
                n += _TMUL + _ADJ_TMUL_T + cols * (
                    col - _QROT + _ADJ_QROT_Q
                    + (0 if t == JOINT_PRISMATIC else _QROT))
        if t != JOINT_FIXED:
            n += _ADJ_TMUL_U + {JOINT_REVOLUTE: 10, JOINT_PRISMATIC: 6,
                                JOINT_BALL: 4}.get(t, 7)
    return n * E

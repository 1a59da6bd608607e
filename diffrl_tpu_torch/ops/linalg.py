"""Dense linear algebra for joint-space dynamics (port of
diffrl_tpu/ops/linalg.py), batched over leading dimensions ([..., D, D]).

The reference does not differentiate through the factorization: the
Cholesky backward is a nop and the solve's backward applies the
implicit-function rule with the factor frozen,

    lambda = (L L^T)^{-1} adj_x
    adj_b += lambda
    adj_A -= lambda x^T

``solve_frozen_chol`` and ``solve_frozen_inv`` are autograd Functions with
exactly that backward; autograd through a true Cholesky would give other
gradients.
"""

from __future__ import annotations

import torch


def _matvec(A, b):
    return torch.einsum("...ij,...j->...i", A, b)


def chol_regularized(H, reg):
    """Cholesky of (H + diag(reg)); reg is the per-dof armature vector."""
    return torch.linalg.cholesky(H + torch.diag_embed(reg))


def cholesky_unrolled(A):
    """Cholesky-Banachiewicz of small SPD matrices, unrolled over the
    (static) dimension, with the diagonal clamped at 1e-12 before its root.
    A [..., D, D] -> lower-triangular L."""
    D = A.shape[-1]
    rows = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                rows[i][j] = s / rows[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack(
        [torch.stack([rows[i][j] if j <= i else zero for j in range(D)],
                     dim=-1) for i in range(D)], dim=-2)


def chol_inverse(A):
    """Explicit inverse of small SPD matrices through the unrolled
    Cholesky: L^-1 by row-vectorized forward substitution, then
    A^-1 = L^-T L^-1."""
    D = A.shape[-1]
    L = cholesky_unrolled(A)
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    rows = []
    for i in range(D):
        e = eye[i].expand(A.shape[:-2] + (D,))
        if i:
            prev = torch.stack(rows, dim=-2)                     # [..., i, D]
            e = e - torch.einsum("...k,...kd->...d", L[..., i, :i], prev)
        rows.append(e / L[..., i, i][..., None])
    Linv = torch.stack(rows, dim=-2)
    return torch.einsum("...ki,...kj->...ij", Linv, Linv)


def cho_solve_lower(L, b):
    """Solve (L L^T) x = b given lower-triangular L (batched)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0]


class _SolveFrozenInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, Hinv, b):
        x = _matvec(Hinv, b)
        ctx.save_for_backward(Hinv, x)
        return x

    @staticmethod
    def backward(ctx, g):
        Hinv, x = ctx.saved_tensors
        lam = _matvec(Hinv, g)
        return -lam[..., :, None] * x[..., None, :], None, lam


def solve_frozen_inv(H, Hinv, b):
    """x = Hinv @ b with the frozen-factor gradient: adj_b = Hinv g,
    adj_H = -(Hinv g) x^T, and Hinv gets none."""
    return _SolveFrozenInv.apply(H, Hinv, b)


class _SolveFrozenChol(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, L, b):
        x = cho_solve_lower(L, b)
        ctx.save_for_backward(L, x)
        return x

    @staticmethod
    def backward(ctx, g):
        L, x = ctx.saved_tensors
        lam = cho_solve_lower(L, g)
        return -lam[..., :, None] * x[..., None, :], None, lam


def solve_frozen_chol(H, L, b):
    """x = (L L^T)^{-1} b with the frozen-L gradient: H takes
    adj_H = -lambda x^T in the backward only, L gets no gradient (L may be
    stale under mass-matrix caching)."""
    return _SolveFrozenChol.apply(H, L, b)

"""The port's ops (diffrl_tpu_torch.ops) against the JAX package's.

Every case of tests/test_ops.py is mirrored on the port (the same identity
checked on the same seeded inputs), and every public function is held
against its JAX counterpart on the same numpy inputs: values at rtol/atol
1e-5 (float32, the same formulas in another evaluation order; the matmul
forms 1e-4), gradients of a random weighted sum likewise. The frozen
solves' custom VJPs are held against jax.vjp: adj_b = (LL^T)^-1 g,
adj_H = -adj_b x^T, and no gradient into the factor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffrl_tpu import ops as jops

from diffrl_tpu_torch import ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng():
    return np.random.RandomState(0)


def _unit(rng, *shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _t(x):
    return torch.tensor(np.asarray(x))


def _grad_pair(jfn, tfn, inputs, rng):
    """Values and gradients of <w, f(inputs)> through both packages."""
    jout = jfn(*map(jnp.asarray, inputs))
    w = rng.randn(*np.shape(jout)).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                  argnums=tuple(range(len(inputs))))(
                      *map(jnp.asarray, inputs))
    leaves = [_t(x).requires_grad_() for x in inputs]
    tout = tfn(*leaves)
    tg = torch.autograd.grad(torch.sum(tout * _t(w)), leaves)
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jg], [g.numpy() for g in tg])


def _match(jfn, tfn, inputs, rng, rtol=1e-5, atol=1e-5):
    jo, to, jg, tg = _grad_pair(jfn, tfn, inputs, rng)
    np.testing.assert_allclose(to, jo, rtol=rtol, atol=atol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _np_quat_rotate(q, v):
    x, y, z, w = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return R @ v


def test_quat_cases_of_test_ops():
    rng = _rng()
    for _ in range(10):
        q, v = _unit(rng), rng.randn(3).astype(np.float32)
        np.testing.assert_allclose(ops.quat_rotate(_t(q), _t(v)),
                                   _np_quat_rotate(q, v), **TOL)
    q, v = _t(_unit(rng)), _t(rng.randn(3).astype(np.float32))
    np.testing.assert_allclose(ops.quat_rotate_inv(q, ops.quat_rotate(q, v)),
                               v, **TOL)
    qa, qb = _t(_unit(rng)), _t(_unit(rng))
    np.testing.assert_allclose(
        ops.quat_rotate(ops.quat_mul(qa, qb), v),
        ops.quat_rotate(qa, ops.quat_rotate(qb, v)), **TOL)
    qz = ops.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]),
                                  torch.tensor(np.pi / 2))
    np.testing.assert_allclose(ops.quat_rotate(qz, torch.tensor(
        [1.0, 0.0, 0.0])), [0.0, 1.0, 0.0], atol=1e-6)
    qs, vs = _t(_unit(rng, 5)), _t(rng.randn(5, 3).astype(np.float32))
    out = ops.quat_rotate(qs, vs)
    for i in range(5):
        np.testing.assert_allclose(out[i], ops.quat_rotate(qs[i], vs[i]),
                                   rtol=1e-5, atol=1e-6)


def test_normalize_guards_give_finite_and_zero_gradients():
    z4 = torch.zeros(4, requires_grad=True)
    (g,) = torch.autograd.grad(ops.quat_normalize(z4).sum(), z4)
    assert torch.isfinite(g).all()
    np.testing.assert_array_equal(ops.quat_normalize(torch.zeros(4)),
                                  [0, 0, 0, 1])
    np.testing.assert_allclose(ops.safe_normalize(torch.tensor(
        [3.0, 0.0, 4.0])), [0.6, 0.0, 0.8], atol=1e-6)
    z3 = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(ops.safe_normalize(z3).sum(), z3)
    assert torch.all(g == 0.0)


def test_transform_and_spatial_cases_of_test_ops():
    rng = _rng()
    t = ops.transform(torch.tensor([1.0, 2.0, 3.0]), _t(_unit(rng)))
    u = ops.transform(torch.tensor([-1.0, 0.5, 0.0]), _t(_unit(rng)))
    p = _t(rng.randn(3).astype(np.float32))
    np.testing.assert_allclose(
        ops.transform_point(ops.transform_multiply(t, u), p),
        ops.transform_point(t, ops.transform_point(u, p)), **TOL)
    t = ops.transform(torch.tensor([1.0, -2.0, 0.5]), _t(_unit(rng)))
    np.testing.assert_allclose(
        ops.transform_multiply(t, ops.transform_inverse(t)),
        ops.transform_identity(), atol=1e-6)

    t = ops.transform(torch.tensor([0.3, -1.2, 2.0]), _t(_unit(rng)))
    tw, wr = (_t(rng.randn(6).astype(np.float32)) for _ in range(2))
    np.testing.assert_allclose(
        ops.spatial_dot(tw, wr),
        ops.spatial_dot(ops.spatial_transform_twist(t, tw),
                        ops.spatial_transform_wrench(t, wr)),
        rtol=1e-4, atol=1e-4)
    t = ops.transform(torch.tensor([0.1, 0.7, -0.4]), _t(_unit(rng)))
    A = rng.randn(6, 6).astype(np.float32)
    I_m = _t(A @ A.T + 6 * np.eye(6, dtype=np.float32))
    v_m = _t(rng.randn(6).astype(np.float32))
    v_s = ops.spatial_transform_twist(t, v_m)
    I_s = ops.spatial_transform_inertia(t, I_m)
    np.testing.assert_allclose(v_s @ I_s @ v_s, v_m @ I_m @ v_m, rtol=1e-3)
    a, b, f = (_t(rng.randn(6).astype(np.float32)) for _ in range(3))
    np.testing.assert_allclose(
        ops.spatial_dot(ops.spatial_cross(a, b), f),
        -ops.spatial_dot(b, ops.spatial_cross_dual(a, f)),
        rtol=1e-4, atol=1e-4)


def test_quat_functions_match_jax():
    rng = _rng()
    q = (rng.randn(6, 4) * 0.7).astype(np.float32)
    v = rng.randn(6, 3).astype(np.float32)
    for name, args in [
            ("quat_mul", (q, _unit(rng, 6))), ("quat_rotate", (q, v)),
            ("quat_rotate_inv", (q, v)), ("quat_normalize", (q,)),
            ("quat_to_matrix", (q,)), ("quat_conjugate", (q,)),
            ("quat_from_axis_angle", (v, rng.randn(6).astype(np.float32)))]:
        _match(getattr(jops, name), getattr(ops, name), args, rng)


def test_transform_and_spatial_functions_match_jax():
    rng = _rng()
    t = np.concatenate([rng.randn(5, 3), _unit(rng, 5)], -1).astype(
        np.float32)
    u = np.concatenate([rng.randn(5, 3), _unit(rng, 5)], -1).astype(
        np.float32)
    x6 = rng.randn(5, 6).astype(np.float32)
    y6 = rng.randn(5, 6).astype(np.float32)
    p = rng.randn(5, 3).astype(np.float32)
    A = rng.randn(5, 6, 6).astype(np.float32)
    I_m = np.zeros((5, 6, 6), np.float32)
    I_m[:, :3, :3] = A[:, :3, :3] @ A[:, :3, :3].transpose(0, 2, 1) + np.eye(3)
    I_m[:, 3, 3] = I_m[:, 4, 4] = I_m[:, 5, 5] = 2.0
    for name, args in [
            ("transform_multiply", (t, u)), ("transform_inverse", (t,)),
            ("transform_point", (t, p)), ("transform_vector", (t, p)),
            ("spatial_cross", (x6, y6)), ("spatial_cross_dual", (x6, y6)),
            ("spatial_transform_twist", (t, x6)),
            ("spatial_transform_wrench", (t, x6)), ("skew", (p,)),
            ("spatial_adjoint", (A[:, :3, :3], A[:, 3:, :3])),
            ("safe_normalize", (p,))]:
        _match(getattr(jops, name), getattr(ops, name), args, rng)
    _match(jops.spatial_transform_inertia, ops.spatial_transform_inertia,
           (t, I_m), rng, rtol=1e-4, atol=1e-4)
    _match(jops.spatial_inertia_matvec, ops.spatial_inertia_matvec,
           (t, I_m, x6), rng, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        ops.spatial_inertia_matvec(_t(t), _t(I_m), _t(x6)),
        torch.einsum("...ij,...j->...i",
                     ops.spatial_transform_inertia(_t(t), _t(I_m)), _t(x6)),
        rtol=1e-4, atol=1e-4)


def _spd(rng, *batch, n):
    A = rng.randn(*batch, n, n).astype(np.float32)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n, dtype=np.float32)


def test_linalg_cases_of_test_ops():
    rng = _rng()
    H = _spd(rng, n=7)
    reg = np.full(7, 0.05, np.float32)
    b = rng.randn(7).astype(np.float32)
    L = ops.chol_regularized(_t(H), _t(reg))
    x = ops.solve_frozen_chol(_t(H), L, _t(b))
    np.testing.assert_allclose(x, np.linalg.solve(H + 0.05 * np.eye(7), b),
                               rtol=1e-4, atol=1e-4)

    n = 5
    H = _spd(rng, n=n)
    b = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    L = ops.chol_regularized(_t(H), torch.full((n,), 0.1))
    Ht, bt = _t(H).requires_grad_(), _t(b).requires_grad_()
    x = ops.solve_frozen_chol(Ht, L, bt)
    adj_H, adj_b = torch.autograd.grad(x, (Ht, bt), _t(g))
    lam = np.linalg.solve(H + 0.1 * np.eye(n), g)
    np.testing.assert_allclose(adj_b, lam, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(adj_H, -np.outer(lam, x.detach().numpy()),
                               rtol=1e-4, atol=1e-4)

    Hs = _spd(rng, 4, n=6)
    bs = rng.randn(4, 6).astype(np.float32)
    xs = ops.solve_frozen_chol(_t(Hs), ops.chol_regularized(
        _t(Hs), torch.zeros(4, 6)), _t(bs))
    for i in range(4):
        np.testing.assert_allclose(xs[i], np.linalg.solve(Hs[i], bs[i]),
                                   rtol=1e-4, atol=1e-4)


def test_linalg_and_frozen_vjps_match_jax():
    rng = _rng()
    A = _spd(rng, 3, n=6)
    b = rng.randn(3, 6).astype(np.float32)
    g = rng.randn(3, 6).astype(np.float32)
    reg = np.full((3, 6), 0.05, np.float32)
    for name, args in [("cholesky_unrolled", (A,)), ("chol_inverse", (A,)),
                       ("chol_regularized", (A, reg))]:
        np.testing.assert_allclose(getattr(ops, name)(*map(_t, args)),
                                   getattr(jops, name)(*map(jnp.asarray,
                                                            args)),
                                   rtol=1e-4, atol=1e-5)
    L = np.asarray(jops.chol_regularized(jnp.asarray(A), jnp.asarray(reg)))
    np.testing.assert_allclose(ops.cho_solve_lower(_t(L), _t(b)),
                               jops.cho_solve_lower(jnp.asarray(L),
                                                    jnp.asarray(b)),
                               rtol=1e-4, atol=1e-5)
    Hinv = np.asarray(jops.chol_inverse(jnp.asarray(A)))
    for jfn, tfn, F in [(jops.solve_frozen_inv, ops.solve_frozen_inv, Hinv),
                        (jops.solve_frozen_chol, ops.solve_frozen_chol, L)]:
        jx, vjp = jax.vjp(lambda H, F_, b_: jfn(H, F_, b_), jnp.asarray(A),
                          jnp.asarray(F), jnp.asarray(b))
        jH, jF, jb = vjp(jnp.asarray(g))
        leaves = [_t(a).requires_grad_() for a in (A, F, b)]
        tx = tfn(*leaves)
        tH, tF, tb = torch.autograd.grad(tx, leaves, _t(g),
                                         allow_unused=True)
        np.testing.assert_allclose(tx.detach(), jx, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tH, jH, rtol=1e-4, atol=1e-5)
        assert tF is None and not np.any(np.asarray(jF))

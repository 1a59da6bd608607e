"""The port's particle engine (diffrl_tpu_torch.sim.particles and
sim.rigid) against the JAX package's, force family by force family.

One small scene (a 4 x 3 cloth with bending and lift/drag, a 2 x 1 x 1
soft grid, springs, and sphere, box, capsule and baked-mesh shapes, two of
them on links of a revolute chain) is built by both packages' builders;
the same seeded numpy positions and velocities of E = 3 envs go through
jax.vmap of each JAX function and through the port's batched function.
Values and the VJP of a random cotangent (w.r.t. positions and
velocities) must agree to 2e-5 of the largest entry: float32 with the
sums taken in another order (the port sums per particle through fixed
tables).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffrl_tpu.sim.model as JM
import diffrl_tpu.sim.particles as JP
import diffrl_tpu.sim.rigid as JR

import diffrl_tpu_torch.sim.model as TM
import diffrl_tpu_torch.sim.particles as TP
import diffrl_tpu_torch.sim.rigid as TR

E = 3
REL = 2e-5
QI = (0.0, 0.0, 0.0, 1.0)
TET_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
TET_F = np.array([0, 2, 1, 0, 1, 3, 0, 3, 2, 1, 2, 3])


def scene(M, **replace):
    b = M.ModelBuilder()
    b.add_articulation()
    l0 = b.add_link(-1, np.array([0.0, 0.4, 0.0, *QI]), axis=(0, 0, 1),
                    type=M.JOINT_REVOLUTE)
    b.add_shape_sphere(l0, pos=(0.2, 0.0, 0.0), radius=0.1)
    l1 = b.add_link(l0, np.array([0.3, 0.0, 0.0, *QI]), axis=(0, 0, 1),
                    type=M.JOINT_REVOLUTE)
    b.add_shape_box(l1, pos=(0.1, 0.0, 0.0), hx=0.1, hy=0.03, hz=0.1)
    b.add_shape_capsule(-1, pos=(0.3, 0.3, 0.0), radius=0.05,
                        half_width=0.1, density=0.0)
    b.add_shape_mesh(-1, pos=(0.1, 0.1, 0.0), mesh=M.Mesh(TET_V * 0.3, TET_F),
                     density=0.0)
    b.add_cloth_grid(pos=(0.0, 0.3, 0.0), rot=QI, vel=(0.0, 0.0, 0.0),
                     dim_x=4, dim_y=3, cell_x=0.1, cell_y=0.1, mass=0.1)
    b.add_soft_grid(pos=(0.1, 0.05, 0.0), rot=QI, vel=(0.0, 0.0, 0.0),
                    dim_x=2, dim_y=1, dim_z=1, cell_x=0.1, cell_y=0.1,
                    cell_z=0.1, density=100.0, k_damp=5.0)
    b.add_spring(0, 1, ke=50.0, kd=1.0, control=0.0)
    b.add_spring(1, 5, ke=20.0, kd=1.0, control=0.0)
    return dataclasses.replace(b.finalize(), tri_drag=2.0, tri_lift=3.0,
                               edge_kd=0.5, **replace)


@pytest.fixture(scope="module")
def models():
    jm, tm = scene(JM), scene(TM)
    rng = np.random.default_rng(0)
    P = tm.particle_count
    x = (tm.particle_q_init[None] + rng.normal(0, 0.03, (E, P, 3))).astype(
        np.float32)
    v = rng.normal(0, 0.5, (E, P, 3)).astype(np.float32)
    return jm, tm, x, v, rng


def body_state(rng, L):
    q = rng.normal(size=(E, L, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    X = np.concatenate([rng.normal(0, 0.05, (E, L, 3)) + [0.1, 0.35, 0.0],
                        q], -1).astype(np.float32)
    return X, rng.normal(0, 0.5, (E, L, 6)).astype(np.float32)


def assert_rel(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: max err {err:.3e}, scale {scale:.3e}"


def hold(jfn, tfn, args, rng, grad_of=(0, 1)):
    """jax.vmap(jfn) and tfn on the same args: values (one output or a
    tuple), and the VJP of a random cotangent w.r.t. the args at
    ``grad_of``."""
    jout, vjp = jax.vjp(jax.jit(jax.vmap(jfn)), *map(jnp.asarray, args))
    single = not isinstance(jout, tuple)
    jouts = (jout,) if single else jout
    gs = tuple(rng.normal(size=o.shape).astype(np.float32) for o in jouts)
    jg = vjp(jnp.asarray(gs[0]) if single else tuple(map(jnp.asarray, gs)))
    leaves = [torch.tensor(a).requires_grad_(i in grad_of)
              for i, a in enumerate(args)]
    touts = tfn(*leaves)
    touts = (touts,) if single else touts
    tg = torch.autograd.grad(touts, [leaves[i] for i in grad_of],
                             tuple(map(torch.tensor, gs)), allow_unused=True)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert np.abs(np.asarray(j)).max() > 0.0
        assert_rel(t.detach(), j, f"value {k}")
    for i, t in zip(grad_of, tg):
        assert_rel(np.zeros_like(args[i]) if t is None else t, jg[i],
                   f"VJP of input {i}")


FAMILIES = {
    "springs": "eval_springs", "triangles": "eval_triangles",
    "bending": "eval_bending", "tetrahedra": "eval_tetrahedra",
    "ground": "eval_ground_contacts",
    "all_pairs_self_contact": "eval_triangles_contact",
    "particle_forces": "particle_forces",
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_force_family_matches_jax(models, family):
    jm, tm, x, v, rng = models
    name = FAMILIES[family]
    hold(lambda a, b: getattr(JP, name)(jm, a, b),
         lambda a, b: getattr(TP, name)(tm, a, b), (x, v), rng)


def test_soft_contacts_on_every_shape_match_jax(models):
    """Sphere and box on links (random body transforms and twists),
    capsule and baked mesh static; particle forces and body wrenches, and
    their VJPs w.r.t. positions, velocities, transforms and twists."""
    jm, tm, x, v, rng = models
    X, V = body_state(rng, tm.link_count)

    def soft(P, m):
        def fn(a, b, c, d):
            pf, bf = P.eval_soft_contacts(m, a, b, c, d)
            return pf, bf, P.eval_soft_contacts(m, a, b)[0]
        return fn

    hold(soft(JP, jm), soft(TP, tm), (x, v, X, V), rng,
         grad_of=(0, 1, 2, 3))


def test_triangle_rigid_contacts_match_jax(models):
    jm, tm, x, v, rng = models
    B, K = 2, 5
    X, V = body_state(rng, B)
    cb = np.array([0, 1, 1, 0, 1])
    cp = rng.normal(0, 0.05, (K, 3)).astype(np.float32)
    cd = np.full(K, 0.02, np.float32)
    cm = np.tile(np.array([1e4, 100.0, 100.0, 0.5], np.float32), (K, 1))
    args = (x, v, X[..., :3], X[..., 3:], V[..., 3:], V[..., :3])

    def jfn(*a):
        return JP.eval_triangles_rigid_contacts(
            jm, *a, jnp.asarray(cb), jnp.asarray(cp), jnp.asarray(cd),
            jnp.asarray(cm))

    hold(jfn, lambda *a: TP.eval_triangles_rigid_contacts(
        tm, *a, cb, cp, cd, cm), args, rng, grad_of=(0, 1, 2, 3, 4, 5))


def test_lift_gradient_is_finite_on_a_flat_cloth():
    """The lift term's arccos at a flat, still triangle (n_hat . vdir = 0
    with vmid = 0, and the angle's argument at the clamp for a velocity
    along the normal): its gradient stays finite on both packages."""
    for M, P in ((JM, JP), (TM, TP)):
        b = M.ModelBuilder()
        b.add_particle((0.0, 1.0, 0.0), (0.0, 0.0, 0.0), 1.0)
        b.add_particle((1.0, 1.0, 0.0), (0.0, 0.0, 0.0), 1.0)
        b.add_particle((0.0, 1.0, 1.0), (0.0, 0.0, 0.0), 1.0)
        b.add_triangle(0, 1, 2)
        m = dataclasses.replace(b.finalize(), ground=False, tri_drag=1.0,
                                tri_lift=1.0)
        x0 = np.asarray(m.particle_q_init, np.float32)[None]
        for vel in (np.zeros((1, 3, 3), np.float32),
                    np.tile(np.float32([0.0, 2.0, 0.0]), (1, 3, 1))):
            if M is JM:
                g = jax.grad(lambda a, b: jnp.sum(jax.vmap(
                    lambda p, q: P.eval_triangles(m, p, q))(a, b) ** 2),
                    argnums=(0, 1))(jnp.asarray(x0), jnp.asarray(vel))
                g = [np.asarray(t) for t in g]
            else:
                leaves = [torch.tensor(a).requires_grad_() for a in (x0, vel)]
                g = torch.autograd.grad(
                    torch.sum(P.eval_triangles(m, *leaves) ** 2), leaves)
                g = [t.numpy() for t in g]
            assert all(np.all(np.isfinite(t)) for t in g)


def test_xpbd_solvers_match_jax(models):
    jm, tm, x, v, rng = models
    c = TP._consts(tm, torch.tensor(x))
    w = c.inv_mass.numpy()
    dt = 1.0 / 240.0
    for name, extra in (("solve_springs", ()), ("solve_ground_contacts", ()),
                        ("solve_tetrahedra", (0.8,))):
        hold(lambda a, b: getattr(JP, name)(jm, a, b, jnp.asarray(w), dt,
                                            *extra),
             lambda a, b: getattr(TP, name)(tm, a, b, c.inv_mass, dt,
                                            *extra), (x, v), rng)
    hold(lambda a, b: JP.xpbd_substep(jm, a, b, dt, 0.8),
         lambda a, b: TP.xpbd_substep(tm, a, b, dt, 0.8), (x, v), rng)


def test_integrators_and_rigid_bodies_match_jax(models):
    jm, tm, x, v, rng = models
    f = rng.normal(size=x.shape).astype(np.float32)
    c = TP._consts(tm, torch.tensor(x))
    hold(lambda a, b, ff: JP.integrate_particles(
             a, b, ff, jnp.asarray(c.inv_mass.numpy()), jm.gravity, 0.01),
         lambda a, b, ff: TP.integrate_particles(
             a, b, ff, c.inv_mass, c.gravity, 0.01),
         (x, v, f), rng, grad_of=(0, 1, 2))
    B = 3
    X, V = body_state(rng, B)
    args = (X[0, :, :3], X[0, :, 3:], V[0, :, 3:], V[0, :, :3])
    cb = np.array([0, 0, 1, 2, 2])
    cp = rng.normal(0, 0.1, (5, 3)).astype(np.float32)
    cd = np.full(5, 0.3, np.float32)
    cm = np.tile(np.array([1e4, 100.0, 100.0, 0.5], np.float32), (5, 1))
    for k in (0, 1):
        jo, vjp = jax.vjp(lambda *a: JR.eval_rigid_contacts(
            *a, jnp.asarray(cb), jnp.asarray(cp), jnp.asarray(cd),
            jnp.asarray(cm))[k], *map(jnp.asarray, args))
        g = rng.normal(size=jo.shape).astype(np.float32)
        leaves = [torch.tensor(a).requires_grad_() for a in args]
        to = TR.eval_rigid_contacts(*leaves, cb, cp, cd, cm)[k]
        tg = torch.autograd.grad(to, leaves, torch.tensor(g))
        assert np.abs(np.asarray(jo)).max() > 0.0
        assert_rel(to.detach(), jo, "rigid contact")
        for a, b in zip(tg, vjp(jnp.asarray(g))):
            assert_rel(a, b, "rigid contact VJP")
    inv_I = np.tile(np.eye(3, dtype=np.float32) * 2.0, (B, 1, 1))
    ins = args + (rng.normal(size=(B, 3)).astype(np.float32),
                  rng.normal(size=(B, 3)).astype(np.float32),
                  np.float32([1.0, 0.0, 2.0]), inv_I,
                  np.float32([0.0, -9.8, 0.0]))
    for a, b in zip(TR.integrate_rigids(*map(torch.tensor, ins), 0.01),
                    JR.integrate_rigids(*map(jnp.asarray, ins), 0.01)):
        assert_rel(a, b, "integrate_rigids")

"""The port's hashed cloth self-collision against the JAX package's and
against all-pairs.

The crumpled cloths of tests/test_particles.py (a fixed-top cloth grid,
positions drawn uniformly in a 0.3 box so many particle-triangle pairs lie
inside the 0.1 contact radius) go through both packages at E = 2:

- the hash table itself (which particle lands in which bucket and slot,
  and which are dropped past the capacity) equals the table JAX builds
  (particles.py:281-288, rebuilt here in jnp), in the exact case and in
  the overflow case of test_particles.py:432 (cell 0.5, 32 buckets,
  capacity 2), where the silent drop is matched, not repaired;
- forces and their VJPs equal JAX's (run op by op, as the port runs) to
  1e-4 of the largest entry: the VJP sums 1e5-stiff penalty terms that
  cancel, so both float32 VJPs lie 8 % of the largest entry from the
  float64 one (a pair at a select's boundary) and 2.9e-5 from each other;
- with no overflow (capacity P) the hashed forces equal the port's
  all-pairs forces at test_particles.py:407's tolerance (rtol 1e-3,
  atol 1e-2 on 1e5-stiff penalty forces);
- the spatial hash wraps its int32 products as XLA does, at cell
  coordinates whose products overflow 32 bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import diffrl_tpu.sim.model as JM
import diffrl_tpu.sim.particles as JP

import diffrl_tpu_torch.sim.model as TM
import diffrl_tpu_torch.sim.particles as TP

E = 2
REL = 1e-4


def crumpled(M, dim, seed=0, **replace):
    b = M.ModelBuilder()
    b.add_cloth_grid(pos=(0.0, 2.0, 0.0), rot=np.array([0.0, 0.0, 0.0, 1.0]),
                     vel=(0.0, 0.0, 0.0), dim_x=dim, dim_y=dim, cell_x=0.1,
                     cell_y=0.1, mass=0.1, fix_top=True)
    m = dataclasses.replace(b.finalize(), ground=False, tri_ke=100.0,
                            tri_ka=100.0, tri_kd=5.0, edge_ke=1.0,
                            edge_kd=0.1, **replace)
    rng = np.random.default_rng(seed)
    P = m.particle_count
    x = rng.uniform(0.0, 0.3, size=(E, P, 3)).astype(np.float32)
    v = rng.normal(0.0, 0.1, size=(E, P, 3)).astype(np.float32)
    return m, x, v


def jax_table(model, x):
    """The JAX package's table build (particles.py:281-288)."""
    P = x.shape[0]
    B = model.tri_collision_buckets
    C = model.tri_collision_capacity
    cells = jnp.floor(x * (1.0 / model.tri_collision_cell_size)).astype(
        jnp.int32)
    hp = JP._hash_cells(cells, B)
    order = jnp.argsort(hp)
    hs = hp[order]
    slot = jnp.arange(P) - jnp.searchsorted(hs, hs, side="left")
    table = jnp.full((B, C), P, dtype=jnp.int32)
    return table.at[hs, slot].set(order.astype(jnp.int32), mode="drop")


def assert_rel(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0.0 and err <= REL * scale, \
        f"{what}: max err {err:.3e}, scale {scale:.3e}"


def hold_hashed(jm, tm, x, v):
    """Table, forces and VJPs of the hashed path against JAX's; returns
    the number of particles the table dropped."""
    jt = np.asarray(jax.vmap(lambda a: jax_table(jm, a))(jnp.asarray(x)))
    tt = TP.hash_table(tm, torch.tensor(x))[0].numpy()
    np.testing.assert_array_equal(tt, jt)
    # particle_forces with enable_tri_collisions="hashed": the hashed
    # forces (most of the total here) and their dispatch
    for fn_j, fn_t in ((JP.particle_forces, TP.particle_forces),):
        # JAX op by op: under jit XLA rewrites the crumpled cloth's sums
        # so that a pair at a select's boundary takes the other side (its
        # VJP then moves by 20% of its largest entry, jit against eager)
        jout, vjp = jax.vjp(jax.vmap(lambda a, b: fn_j(jm, a, b)),
                            jnp.asarray(x), jnp.asarray(v))
        g = np.random.default_rng(1).normal(size=jout.shape).astype(
            np.float32)
        jg = vjp(jnp.asarray(g))
        leaves = [torch.tensor(a).requires_grad_() for a in (x, v)]
        tout = fn_t(tm, *leaves)
        tg = torch.autograd.grad(tout, leaves, torch.tensor(g))
        assert torch.isfinite(tout).all()
        assert_rel(tout.detach(), jout, fn_t.__name__)
        assert_rel(tg[0], jg[0], f"{fn_t.__name__} VJP")
        assert_rel(tg[1], jg[1], f"{fn_t.__name__} VJP (velocities)")
    return int(np.sum(tt < x.shape[1], axis=(1, 2)).sum())


def test_hashed_matches_jax_and_all_pairs_without_overflow():
    kw = dict(enable_tri_collisions="hashed", tri_collision_cell_size=1.0,
              tri_collision_buckets=64)
    tm, x, v = crumpled(TM, 4)
    P = tm.particle_count
    tm = dataclasses.replace(tm, tri_collision_capacity=P, **kw)
    jm = dataclasses.replace(crumpled(JM, 4)[0], tri_collision_capacity=P,
                             **kw)
    assert hold_hashed(jm, tm, x, v) == E * P       # nothing dropped
    xt, vt = torch.tensor(x), torch.tensor(v)
    f_all = TP.eval_triangles_contact(tm, xt, vt)
    f_hash = TP.eval_triangles_contact_hashed(tm, xt, vt)
    assert float(f_all.abs().max()) > 0.0
    np.testing.assert_allclose(f_hash, f_all, rtol=1e-3, atol=1e-2)


def test_hashed_overflow_matches_jax():
    """test_particles.py:432's overflow case: buckets of capacity 2 drop
    particles silently; the port drops the same ones."""
    kw = dict(enable_tri_collisions="hashed", tri_collision_cell_size=0.5,
              tri_collision_buckets=32, tri_collision_capacity=2)
    tm, x, v = crumpled(TM, 3)
    tm = dataclasses.replace(tm, **kw)
    jm = dataclasses.replace(crumpled(JM, 3)[0], **kw)
    kept = hold_hashed(jm, tm, x, v)
    assert kept < E * tm.particle_count             # the table overflowed


def test_hash_wraps_int32_products_like_xla():
    rng = np.random.default_rng(2)
    cells = np.concatenate([
        rng.integers(-40, 40, size=(64, 3)),
        rng.integers(-2 ** 20, 2 ** 20, size=(64, 3)),
        np.array([[2 ** 31 - 1, -2 ** 31, 29], [-30, 26, 2 ** 30]])],
    ).astype(np.int32)
    for B in (1, 7, 64, 1024, 4096):
        np.testing.assert_array_equal(
            TP._hash_cells(torch.tensor(cells), B).numpy(),
            np.asarray(JP._hash_cells(jnp.asarray(cells), B)))

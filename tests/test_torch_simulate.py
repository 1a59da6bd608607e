"""The port's simulate (remat backward through torch.utils.checkpoint) and
simulate_xpbd against the JAX package's, and the env's two reverse passes
against each other.

Small scenes, a few steps, E = 2 envs from seeded initial velocities (and
joint angles): a 4 x 4 cloth with bending, hashed self-collision, a static
sphere and the ground; tests/test_coupled.py's coupled scene (mm 4,
remat_granularity 3); and a soft grid with a spring on the ground under
XPBD. The final states and the gradient of a loss (mean final particle
height, plus the joint angles for the coupled scene) w.r.t. the initial
state and controls agree with JAX's (jit of vmap of its simulate; the
coupled scene at 2 substeps and mass_matrix_freq 2, a refresh and a
cached substep: longer blocks double JAX's compile) to 2e-5 of the
largest entry (1e-4 for the coupled gradient, whose sums cancel terms of
1e4-stiff contacts: JAX's float32 VJP of two coupled substeps lies 4.4e-5
of its largest entry from the port's float64 one, the port's 9e-6). On
the port, remat=False and remat_granularity 3 give the same bits as
remat=True, and an env step's gradient with sim_backward="lb" (E = 4,
Ant) is as close to the float64 one of "remat" as "remat"'s own float32
gradient is (testing.check_against_f64, rtol 0): the two take the same
plain stages on the CPU but for the refresh substep's VJP, which "lb" takes
as the adjoint kernel's and the mass matrix's plain versions, summing the
same terms in another order.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffrl_tpu.sim.articulation as JA
import diffrl_tpu.sim.model as JM

import diffrl_tpu_torch.sim.articulation as TA
import diffrl_tpu_torch.sim.model as TM
from diffrl_tpu_torch import envs
from diffrl_tpu_torch.envs.base import EnvState
from diffrl_tpu_torch.testing import check_against_f64

from test_coupled import build_coupled_scene

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

E = 2
QI = (0.0, 0.0, 0.0, 1.0)


def cloth(M):
    b = M.ModelBuilder()
    b.add_cloth_grid(pos=(-0.4, 0.5, 0.4), rot=(-0.70710678, 0.0, 0.0,
                                                 0.70710678),
                     vel=(0.0, 0.0, 0.0), dim_x=4, dim_y=4, cell_x=0.2,
                     cell_y=0.2, mass=0.5)
    b.add_shape_sphere(-1, pos=(0.0, 0.1, 0.0), radius=0.35, density=0.0)
    return dataclasses.replace(
        b.finalize(), tri_ke=1e3, tri_ka=1e3, edge_ke=10.0,
        enable_tri_collisions="hashed", tri_collision_cell_size=0.3,
        tri_collision_buckets=256, tri_collision_capacity=8)


def soft(M):
    b = M.ModelBuilder()
    b.add_soft_grid(pos=(0.0, 0.05, 0.0), rot=QI, vel=(0.0, 0.0, 0.0),
                    dim_x=2, dim_y=1, dim_z=1, cell_x=0.1, cell_y=0.1,
                    cell_z=0.1, density=100.0, k_mu=1e3, k_lambda=1e3,
                    k_damp=5.0)
    b.add_spring(0, 4, ke=1e3, kd=1.0, control=0.0)
    return dataclasses.replace(b.finalize(), relaxation=0.8)


def assert_rel(got, want, what, rel=2e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0.0 and err <= rel * scale, \
        f"{what}: max err {err:.3e}, scale {scale:.3e}"


def jax_run(model, state, leaves, steps, step_fn, loss_fn):
    """(final state, d loss / d leaves) of ``steps`` steps of step_fn over
    the envs, JAX under jit (one scan over the steps); ``leaves`` names
    State fields."""
    def run(*xs):
        s = dataclasses.replace(state, **dict(zip(leaves, xs)))
        s, _ = jax.lax.scan(
            lambda c, _: (jax.vmap(lambda s1: step_fn(model, s1))(c), None),
            s, None, length=steps)
        return loss_fn(s), s

    xs = [getattr(state, k) for k in leaves]
    (_, s), g = jax.jit(jax.value_and_grad(run, argnums=tuple(range(len(
        xs))), has_aux=True))(*xs)
    return s, g


def torch_run(model, state, leaves, steps, step_fn, loss_fn):
    xs = [getattr(state, k).clone().requires_grad_() for k in leaves]
    s = dataclasses.replace(state, **dict(zip(leaves, xs)))
    for _ in range(steps):
        s = step_fn(model, s)
    return s, torch.autograd.grad(loss_fn(s), xs)


def seeded_state(jm, tm, seed, perturb):
    rng = np.random.default_rng(seed)
    st = tm.state(E, "cpu")
    fields = {}
    for k in ("joint_q", "joint_qd", "particle_q", "particle_qd"):
        a = getattr(st, k).numpy().copy()
        if k in perturb:
            a += rng.normal(0, perturb[k], a.shape).astype(np.float32)
        fields[k] = a
    return (JM.State(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TM.State(**{k: torch.tensor(v) for k, v in fields.items()}))


def height(s):
    return s.particle_q[..., 1].mean()


def test_cloth_simulate_matches_jax():
    jm, tm = cloth(JM), cloth(TM)
    js, ts = seeded_state(jm, tm, 0, {"particle_qd": 0.5})
    kw = dict(dt=1.0 / 60.0, substeps=8)
    leaves = ("particle_q", "particle_qd")
    jsf, jg = jax_run(jm, js, leaves, 3,
                      lambda m, s: JA.simulate(m, s, **kw), height)
    tsf, tg = torch_run(tm, ts, leaves, 3,
                        lambda m, s: TA.simulate(m, s, **kw), height)
    assert float(tsf.particle_q.detach()[..., 1].min()) < 0.5  # it fell
    for k in ("particle_q", "particle_qd"):
        assert_rel(getattr(tsf, k), getattr(jsf, k), k)
    for a, b, k in zip(tg, jg, leaves):
        assert_rel(a, b, f"d height / d {k}")
    tsn, tgn = torch_run(tm, ts, leaves, 3, lambda m, s: TA.simulate(
        m, s, remat=False, **kw), height)
    assert torch.equal(tsn.particle_q, tsf.particle_q)
    assert all(torch.equal(a, b) for a, b in zip(tgn, tg))


def test_coupled_simulate_matches_jax():
    jm, tm = build_coupled_scene(), chip_smoke.coupled_scene()
    js, ts = seeded_state(jm, tm, 1, {"joint_q": 0.05, "particle_qd": 0.3})
    rng = np.random.default_rng(2)
    act = rng.normal(0, 1.0, (E, 2)).astype(np.float32)
    kw = dict(dt=1.0 / 60.0, substeps=2, mass_matrix_freq=2)
    leaves = ("joint_q", "particle_qd")

    def loss(s):
        return height(s) + s.joint_q.sum()

    jsf, jg = jax_run(jm, js, leaves, 6, lambda m, s: JA.simulate(
        m, s, joint_act=jnp.asarray(act[0]), **kw), loss)
    ta = torch.tensor(act[0]).expand(E, 2)
    tsf, tg = torch_run(tm, ts, leaves, 6, lambda m, s: TA.simulate(
        m, s, joint_act=ta, **kw), loss)
    for k in ("joint_q", "joint_qd", "particle_q", "particle_qd"):
        assert_rel(getattr(tsf, k), getattr(jsf, k), k)
    for a, b, k in zip(tg, jg, leaves):
        assert_rel(a, b, f"d loss / d {k}", rel=1e-4)


def test_remat_options_give_the_same_bits():
    """On the coupled scene with mass_matrix_freq 4: remat_granularity 3
    (the three cached substeps in one recomputed region) and remat=False
    give the values and gradients of remat_granularity 1."""
    tm = chip_smoke.coupled_scene()
    ts = seeded_state(build_coupled_scene(), tm, 1,
                      {"joint_q": 0.05, "particle_qd": 0.3})[1]
    runs = [torch_run(tm, ts, ("joint_q", "particle_qd"), 2,
                      lambda m, s: TA.simulate(m, s, substeps=4,
                                               mass_matrix_freq=4, **kw),
                      lambda s: height(s) + s.joint_q.sum())
            for kw in ({}, dict(remat_granularity=3), dict(remat=False))]
    for s, g in runs[1:]:
        assert torch.equal(s.particle_q, runs[0][0].particle_q)
        assert all(torch.equal(a, b) for a, b in zip(g, runs[0][1]))


def test_simulate_xpbd_matches_jax():
    jm, tm = soft(JM), soft(TM)
    js, ts = seeded_state(jm, tm, 3, {"particle_qd": 0.5})
    kw = dict(dt=1.0 / 60.0, substeps=4)
    leaves = ("particle_q", "particle_qd")
    jsf, jg = jax_run(jm, js, leaves, 3,
                      lambda m, s: JA.simulate_xpbd(m, s, **kw), height)
    tsf, tg = torch_run(tm, ts, leaves, 3,
                        lambda m, s: TA.simulate_xpbd(m, s, **kw), height)
    for k in ("particle_q", "particle_qd"):
        assert_rel(getattr(tsf, k), getattr(jsf, k), k)
    for a, b, k in zip(tg, jg, leaves):
        assert_rel(a, b, f"d height / d {k}")


@pytest.mark.parametrize("name,mm", [("Ant", 16)])
def test_env_step_gradient_remat_equals_lb(name, mm):
    grads = []
    for backward, dtype in (("lb", torch.float32), ("remat", torch.float32),
                            ("remat", torch.float64)):
        env = envs.make(name, num_envs=4, seed=0, stochastic_init=True,
                        MM_caching_frequency=mm, device="cpu",
                        sim_backward=backward)
        assert env.sim_backward == backward
        s = env.reset()
        with torch.no_grad():
            for _ in range(2):
                s, *_ = env.step(s, torch.zeros((4, env.num_acts)))
        gen = torch.Generator().manual_seed(0)
        acts = (torch.rand((4, env.num_acts), generator=gen) * 2 - 1
                ).to(dtype).requires_grad_()
        q = s.joint_q.to(dtype).requires_grad_()
        qd = s.joint_qd.to(dtype).requires_grad_()
        _, obs, rew, _, info = env.step(
            EnvState(q, qd, s.actions.to(dtype), s.progress), acts)
        w = torch.randn(obs.shape, generator=gen).to(dtype)
        grads.append(torch.autograd.grad(
            (info["obs_before_reset"] * w).sum() + rew.sum(),
            (acts, q, qd)))
    for lab, a, b, x in zip(("actions", "joint_q", "joint_qd"), *grads):
        assert float(a.abs().max()) > 0.0
        check_against_f64(f"{name} lb d{lab}", a.T, b.T, x.T, 0.0, 0.0)


def test_backward_choice():
    env = envs.make("Ant", num_envs=2, device="cpu")
    assert env.sim_backward == "lb"          # the JAX package's "auto" rule
    for backward in ("manual", "lb_ad", "pallas"):
        assert envs.make("Ant", num_envs=2, device="cpu",
                         sim_backward=backward).sim_backward == backward
    with pytest.raises(ValueError, match="sim_backward"):
        envs.make("Ant", num_envs=2, device="cpu", sim_backward="scan")
    m = chip_smoke.coupled_scene()
    st = m.state(1, "cpu")
    # without particles "manual" is the hand-written reverse pass: the
    # same forward as remat
    joints = dataclasses.replace(st, particle_q=None, particle_qd=None)
    a = TA.simulate(m, joints, backward="manual", substeps=2,
                    mass_matrix_freq=2)
    b = TA.simulate(m, joints, substeps=2, mass_matrix_freq=2)
    assert torch.equal(a.joint_q, b.joint_q)
    assert torch.equal(a.joint_qd, b.joint_qd)
    # with particles it takes the remat path, as in the JAX package
    s1 = TA.simulate(m, st, backward="manual", substeps=2)
    s2 = TA.simulate(m, st, substeps=2)
    assert torch.equal(s1.particle_q, s2.particle_q)

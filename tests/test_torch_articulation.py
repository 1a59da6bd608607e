"""The port's per-env articulation API and coupled substep
(diffrl_tpu_torch.sim.articulation, built on the link-batched stages)
against the JAX package's under jax.vmap.

The model has a revolute root, a ball and a prismatic joint (the free
joint's stages are held by the env tests), box, capsule and sphere shapes
near the ground and a muscle over three links; E = 3 envs start from
seeded joint states that press the links into the ground, so contacts are
active. Values and
the VJP of a random cotangent agree to 2e-5 of each output's largest entry
(float32; the port's mass matrix is the composite-rigid-body form of the
stages, the JAX package's the factored form: the same sums in another
order). The coupled substep gives the bits of a simulate step (which
tests/test_torch_simulate.py holds against JAX's) on
tests/test_coupled.py's scene.
"""

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


sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

E = 3
REL = 2e-5
QI = (0.0, 0.0, 0.0, 1.0)
H_STEP = 1.0 / 240.0


def robot(M):
    b = M.ModelBuilder()
    b.add_articulation()
    base = b.add_link(-1, np.array([0.0, 0.12, 0.0, *QI]), axis=(0, 0, 1),
                      type=M.JOINT_REVOLUTE, stiffness=5.0, damping=0.5,
                      limit_lower=-0.5, limit_upper=0.5)
    b.add_shape_box(base, pos=(0.15, 0.0, 0.0), hx=0.15, hy=0.05, hz=0.1,
                    density=500.0)
    arm = b.add_link(base, np.array([0.3, 0.0, 0.0, *QI]), axis=(0, 0, 0),
                     type=M.JOINT_BALL, stiffness=1.0, damping=0.2)
    b.add_shape_capsule(arm, pos=(0.15, 0.0, 0.0), radius=0.04,
                        half_width=0.15, density=500.0)
    tip = b.add_link(arm, np.array([0.3, 0.0, 0.0, *QI]), axis=(1, 0, 0),
                     type=M.JOINT_PRISMATIC, limit_lower=-0.1,
                     limit_upper=0.1)
    b.add_shape_sphere(tip, radius=0.05, density=500.0)
    b.add_muscle([base, arm, tip], [(0.05, 0.05, 0.0), (0.1, 0.05, 0.0),
                                    (0.0, 0.03, 0.0)],
                 f0=50.0, lm=0.5, lt=0.1, lmax=0.7, pen=0.0)
    return b.finalize()


@pytest.fixture(scope="module")
def setup():
    jm, tm = robot(JM), robot(TM)
    rng = np.random.default_rng(0)
    q = np.zeros((E, tm.coord_count), np.float32)
    q[:, 0] = rng.normal(-0.3, 0.2, E)
    r = rng.normal(0, 0.3, (E, 4)) + [0.0, 0.0, 0.0, 1.0]
    q[:, 1:5] = r / np.linalg.norm(r, axis=1, keepdims=True)
    q[:, 5] = rng.normal(0, 0.1, E)
    qd = rng.normal(0, 0.5, (E, tm.dof_count)).astype(np.float32)
    ja = rng.normal(0, 2.0, (E, tm.dof_count)).astype(np.float32)
    ma = rng.uniform(5.0, 20.0, (E, 1)).astype(np.float32)
    return jm, tm, q, qd, ja, ma, rng


def assert_rel(got, want, what, rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * max(scale, 1e-6), \
        f"{what}: max err {err:.3e}, scale {scale:.3e}"


def hold(jfn, tfn, args, rng, what, jit=True, rel=REL):
    """Values and the VJP of a random cotangent on every output (JAX under
    jit, or op by op where that is quicker than compiling the VJP).
    Returns the cotangents."""
    fn = jax.vmap(jfn)
    jouts, vjp = jax.vjp(jax.jit(fn) if jit else fn,
                         *map(jnp.asarray, args))
    gs = tuple(rng.normal(size=o.shape).astype(np.float32) for o in jouts)
    jg = vjp(tuple(map(jnp.asarray, gs)))
    leaves = [torch.tensor(a).requires_grad_() for a in args]
    touts = tfn(*leaves)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert_rel(t, j, f"{what} output {i}", rel)
    live = [(t, torch.tensor(g)) for t, g in zip(touts, gs)
            if t.requires_grad]
    tg = torch.autograd.grad([t for t, _ in live], leaves,
                             [g for _, g in live], allow_unused=True)
    for i, (t, j) in enumerate(zip(tg, jg)):
        assert_rel(torch.zeros(args[i].shape) if t is None else t, j,
                   f"{what} VJP of input {i}", rel)
    return gs


def test_articulation_api_matches_jax(setup):
    """The stages (fk, id, ground contacts, muscles, tau, spatial
    inertias, the materialised mass matrix), a refresh substep (the mass
    matrix rebuilt, with its DynamicsAux) and a cached substep at JAX's
    (H, Hinv), H taking the frozen-factor gradient, external wrenches
    added: one JAX function, one VJP."""
    jm, tm, q, qd, ja, ma, rng = setup
    HL = jax.vmap(lambda a, b: JA.articulation_substep(
        jm, a, b, jnp.zeros(jm.dof_count), None, H_STEP)[2])(
            jnp.asarray(q), jnp.asarray(qd))
    H, Hinv = (np.asarray(x) for x in HL)
    f_ext = rng.normal(0, 5.0, (E, tm.link_count, 6)).astype(np.float32)

    def api(A, m, q_, qd_, ja_, ma_, H_, Hi_, f_, stop):
        Xsc, Xsm = A.eval_fk(m, q_)
        S, vs, bf = A.eval_id(m, q_, qd_, Xsc, Xsm)
        fc = A.eval_ground_contacts(m, Xsc, vs)
        fm = A.eval_muscles(m, Xsc, ma_)
        tau = A.eval_tau(m, q_, qd_, ja_, S, bf + fc + fm)
        Is = A.eval_spatial_inertias(m, Xsm)
        Hm = A.eval_mass_matrix(m, S, Is)
        q1, qd1, (H1, Hi1), aux = A.articulation_substep(
            m, q_, qd_, ja_, ma_, H_STEP, return_aux=True)
        q2, qd2, _ = A.articulation_substep(
            m, q_, qd_, ja_, ma_, H_STEP, mass_cache=(H_, stop(Hi_)),
            body_f_ext=f_)
        return (Xsc, Xsm, S, vs, bf, fc, fm, tau, Is, Hm, q1, qd1, H1,
                stop(Hi1), *aux, q2, qd2)

    gs = hold(lambda *a: api(JA, jm, *a, jax.lax.stop_gradient),
              lambda *a: api(TA, tm, *a, torch.Tensor.detach),
              (q, qd, ja, ma, H, Hinv, f_ext), rng, "api", jit=False)
    assert np.abs(gs[0]).max() > 0.0
    Xsc, Xsm = TA.eval_fk(tm, torch.tensor(q))
    vs = TA.eval_id(tm, torch.tensor(q), torch.tensor(qd), Xsc, Xsm)[1]
    assert float(TA.eval_ground_contacts(tm, Xsc, vs).abs().max()) > 0.0


def test_coupled_substep_is_simulate_step():
    """coupled_substep (refresh, then 3 cached substeps at its (H, Hinv))
    gives the bits of one simulate step with mass_matrix_freq 4 on
    tests/test_coupled.py's scene, values and gradients;
    tests/test_torch_simulate.py holds simulate against JAX's."""
    tm = chip_smoke.coupled_scene()
    rng = np.random.default_rng(3)
    st = tm.state(E, "cpu")
    px = st.particle_q - torch.tensor([0.0, 0.3, 0.0]) + torch.tensor(
        rng.normal(0, 0.02, st.particle_q.shape).astype(np.float32))
    ja = torch.tensor(rng.normal(0, 1.0, (E, 2)).astype(np.float32))
    outs = []
    for via_simulate in (False, True):
        leaves = [t.clone().requires_grad_()
                  for t in (st.joint_q, px, st.particle_qd, ja)]
        s = TM.State(leaves[0], st.joint_qd, leaves[1], leaves[2])
        if via_simulate:
            s = TA.simulate(tm, s, joint_act=leaves[3], dt=4 * H_STEP,
                            substeps=4, mass_matrix_freq=4)
        else:
            HL = None
            for _ in range(4):
                s, HL1 = TA.coupled_substep(tm, s, leaves[3], None, H_STEP,
                                            mass_cache=HL)
                HL = HL if HL is not None else HL1
        loss = s.particle_q[..., 1].sum() + s.joint_q.sum() + \
            s.joint_qd.sum()
        outs.append([s.joint_q, s.particle_q] + list(
            torch.autograd.grad(loss, leaves)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)

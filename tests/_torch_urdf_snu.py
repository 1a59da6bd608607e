"""Envs and inputs shared by the CPU tests of the port's CartPole and SNU
Humanoid against the JAX package.

``TinySNU`` is the 3-bone SNU variant of tests/test_envs.py (the pelvis on
a free joint, the right femur on a ball joint, the tibia on a hinge; 55 of
the 152 muscles, 66 segments between links, 24 ground contacts, 8
substeps), defined here for both packages: the same ball-joint and muscle
code at a size whose JAX references compile in seconds. Its reward reads
the up and heading projections where the model's sizes put them (entries
20 and 21 of 22): the JAX env reads them at 51 and 52, their places in the
full lower body, which on the 22-entry observation JAX clamps to the last
entry, and the port (which computes the places from the model) would not.
The JAX variant here overrides its reward accordingly; on the full model
the two agree (tests/test_torch_envs_urdf_snu.py).

Inputs are made from a numpy seed: each env's start pose with its joint
coordinates perturbed by up to 0.1 (ball joints' quaternions renormalized)
and, for TinySNU, the pelvis lowered so that some ground contacts are
active; joint velocities up to 0.5; actions uniform in [-1, 1], which give
CartPole's cart force and TinySNU's muscle activations in (0, 1) times
their strength.
"""

import jax.numpy as jnp
import numpy as np
import torch

import diffrl_tpu.envs as jenvs
from diffrl_tpu.envs.snu_humanoid import SNUHumanoidEnv as JSNU

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.envs.snu_humanoid import SNUHumanoidEnv as TSNU

_TINY = {"Pelvis", "FemurR", "TibiaR"}


class JTinySNU(JSNU):
    body_filter = _TINY
    sim_substeps = 8
    termination_height = 0.3

    def reward(self, obs, actions):
        up = 11 + (self.model.coord_count - 7) + (self.model.dof_count - 6)
        return (obs[5] + 0.1 * obs[up] + obs[up + 1]
                + jnp.sum(jnp.abs(actions)) * self.action_penalty)


class TTinySNU(TSNU):
    body_filter = _TINY
    sim_substeps = 8
    termination_height = 0.3


# the mass-matrix period of each env in these tests: CartPole's config
# (4 of its 4 substeps); TinySNU two periods of 4 in its 8 substeps, so
# that a cached substep's cotangent crosses a refresh
MM = {"CartPoleSwingUp": 4, "TinySNU": 4}
# how far TinySNU's pelvis is lowered: its lowest contact point sits 0.107
# above the ground at the start pose
DROP = (-0.16, -0.11)


def envs(name, E=4, **kw):
    """(JAX env, port env on the CPU) with the same arguments."""
    kw = dict(num_envs=E, MM_caching_frequency=MM[name], **kw)
    if name == "TinySNU":
        return JTinySNU(**kw), TTinySNU(device="cpu", **kw)
    return jenvs.make(name, **kw), tenvs.make(name, device="cpu", **kw)


def inputs(env, E, seed):
    """Env-leading float32 numpy (q [E, C], qd [E, D], actions [E, A]) and
    the env-minor controls (joint_act [D, E], muscle activations [M, E] or
    None) of those actions."""
    m = env.model
    rs = np.random.RandomState(seed)
    q = np.tile(np.asarray(m.joint_q_init, np.float64), (E, 1))
    q += rs.uniform(-0.1, 0.1, q.shape)
    for link, t in enumerate(m.topology.joint_type):
        s = m.topology.joint_q_start[link]
        if t == 4:                                  # free: position + quat
            s += 3
        if t in (2, 4):
            q[:, s:s + 4] /= np.linalg.norm(q[:, s:s + 4], axis=1,
                                            keepdims=True)
    if m.ground:
        q[:, 1] += rs.uniform(*DROP, E)
    qd = rs.uniform(-0.5, 0.5, (E, m.dof_count))
    acts = rs.uniform(-1.0, 1.0, (E, env.num_acts)).astype(np.float32)
    ja, ma = env.action_to_controls(torch.as_tensor(acts))
    if ja is None:
        ja = torch.zeros((E, m.dof_count))
    return (q.astype(np.float32), qd.astype(np.float32), acts,
            np.ascontiguousarray(ja.numpy().T),
            None if ma is None else np.ascontiguousarray(ma.numpy().T))


def _minor(*xs):
    return [None if x is None else np.ascontiguousarray(x.T) for x in xs]


def _leaves(*xs):
    return [torch.as_tensor(np.array(x)).requires_grad_() for x in xs]


def check_refresh(name, E=4, seed=0):
    """refresh_substep_lb's values (q', qd', H) and its VJP with
    cotangents on (q', qd', H), muscle activations included, against
    jax.vjp of the JAX one (tests/test_articulation_lb.py's tolerances:
    q rtol 2e-5 atol 1e-6, qd rtol 2e-5 atol 2e-5, H rtol 2e-5 atol 1e-4,
    VJP rtol 2e-3 atol 1e-3)."""
    import jax

    from diffrl_tpu.sim import articulation_lb as jlb

    from diffrl_tpu_torch.sim import articulation_lb as tlb

    je, te = envs(name, E)
    jm, tm = je.model, te.model
    h = te.dt / te.sim_substeps
    q, qd, _, ja, ma = inputs(te, E, seed)
    q, qd = _minor(q, qd)
    rs = np.random.RandomState(seed + 1)
    D = tm.dof_count
    cot = (rs.normal(size=q.shape).astype(np.float32),
           rs.normal(size=qd.shape).astype(np.float32),
           0.01 * rs.normal(size=(D, D, E)).astype(np.float32))
    args = [x for x in (q, qd, ja, ma) if x is not None]

    def jrefresh(args, cot):
        def f(*a):
            q1, qd1, H, _ = jlb.refresh_substep_lb(
                jm, a[0], a[1], a[2], a[3] if len(a) > 3 else None, h)
            return q1, qd1, H
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cot)

    (jq, jqd, jH), want = jax.jit(jrefresh)(args, cot)
    leaves = _leaves(*args)
    tq, tqd, tH, _ = tlb.refresh_substep_lb(
        tm, *leaves[:3], leaves[3] if ma is not None else None, h)
    for lab, a, b, rtol, atol in (("q", tq, jq, 2e-5, 1e-6),
                                  ("qd", tqd, jqd, 2e-5, 2e-5),
                                  ("H", tH, jH, 2e-5, 1e-4)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{name} refresh {lab}")
    got = torch.autograd.grad((tq, tqd, tH), leaves,
                              [torch.as_tensor(c) for c in cot])
    for lab, a, b in zip(("dq", "dqd", "dja", "dma"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=1e-3,
                                   err_msg=f"{name} refresh vjp {lab}")


def check_cached(name, E=4, seed=2):
    """substep_lb's values and its VJP (cotangents on q', qd'; the
    frozen-factor H cotangent; the muscle activations' cotangent) against
    jax.vjp of the JAX one, both on the port's refresh factorization (q
    rtol 2e-5 atol 2e-6, qd rtol 2e-5 atol 2e-5; VJP rtol 5e-4 atol 1e-5
    by diffrl_tpu_torch/testing.py's check_vjp and check_against_f64); and
    the kernel wrappers on CPU tensors, which run these plain versions
    without launching."""
    import jax

    from diffrl_tpu.sim import articulation_lb as jlb

    from diffrl_tpu_torch.sim import articulation_lb as tlb
    from diffrl_tpu_torch.sim import substep_kernels as sk
    from diffrl_tpu_torch.testing import check_against_f64, check_vjp

    je, te = envs(name, E)
    jm, tm = je.model, te.model
    h = te.dt / te.sim_substeps
    q, qd, _, ja, ma = inputs(te, E, seed)
    q, qd = _minor(q, qd)
    tma = None if ma is None else torch.as_tensor(ma)
    with torch.no_grad():
        q1, qd1, H, Hinv = tlb.refresh_substep_lb(
            tm, *map(torch.as_tensor, (q, qd, ja)), tma, h)
    if tm.ground:
        assert sk.active_contacts(tm, q1) > 0
    args = [x.numpy() for x in (q1, qd1)] + [ja, H.numpy()] + (
        [ma] if ma is not None else [])
    Hinv = Hinv.numpy()
    rs = np.random.RandomState(seed + 1)
    cot = (rs.normal(size=q.shape).astype(np.float32),
           rs.normal(size=qd.shape).astype(np.float32))

    def jcached(args, Hinv, cot):
        out, vjp = jax.vjp(lambda a, b, c, d, *m: jlb.substep_lb(
            jm, a, b, c, m[0] if m else None, h, d, Hinv), *args)
        return out, vjp(cot)

    (jq, jqd), want = jax.jit(jcached)(args, Hinv, cot)
    leaves = _leaves(*args)
    lm = leaves[4] if ma is not None else None
    tq, tqd = tlb.substep_lb(tm, *leaves[:3], lm, h, leaves[3],
                             torch.as_tensor(Hinv))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=2e-5, atol=2e-6, err_msg=f"{name} q")
    np.testing.assert_allclose(tqd.detach().numpy(), np.asarray(jqd),
                               rtol=2e-5, atol=2e-5, err_msg=f"{name} qd")
    got = torch.autograd.grad((tq, tqd), leaves,
                              [torch.as_tensor(c) for c in cot])
    d64 = [torch.as_tensor(x).double() for x in args]
    exact = tlb.substep_vjp_lb(
        tm, *d64[:3], d64[4] if ma is not None else None, h, d64[3],
        *(torch.as_tensor(x).double() for x in (Hinv, *cot)))
    x_ = [exact[0], exact[1], exact[2], exact[4], exact[3]]
    for lab, a, b, x in zip(("dq", "dqd", "dja", "dH", "dma"), got, want,
                            x_):
        b = torch.as_tensor(np.array(b))
        check_vjp(f"{name} vjp {lab}", a, b, 5e-4, 1e-5)
        check_against_f64(f"{name} vjp {lab}", a, b, x, 5e-4, 1e-5)
    # the wrappers on CPU tensors: the plain versions, no launch
    n = (sk.substep_forward.launches, sk.substep_vjp.launches)
    plain = [torch.as_tensor(x) for x in (*args[:4], Hinv, *cot)]
    fq, fqd = sk.substep_forward(tm, *plain[:3], tma, h, *plain[3:5])
    vj = sk.substep_vjp(tm, *plain[:3], tma, h, *plain[3:])
    assert (sk.substep_forward.launches, sk.substep_vjp.launches) == n
    assert torch.equal(fq, tq.detach()) and torch.equal(fqd, tqd.detach())
    assert (vj[3] is None) == (ma is None)
    for a, b in zip([vj[0], vj[1], vj[2], vj[4], vj[3]], got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def check_env_step(name, seed=3, backward="lb"):
    """env.step from injected identical states and actions at E = 4, both
    sides on the reverse pass ``backward`` (the lb engine unless another is
    named) with the env's substeps and mass-matrix period of MM: the values (obs, reward, done, next state; rtol 1e-5, atol
    5e-5) and the gradient of sum(reward) + <w, obs> w.r.t. (actions,
    joint_q, joint_qd) (rtol 1e-3, atol 1e-4 in units of each env's
    largest entry, testing.check_vjp). TinySNU's actions reach the
    simulator only as muscle activations. Env 3 hits the time limit; on
    TinySNU env 0 lies below the termination height. Both reset inside the
    step."""
    import jax

    from diffrl_tpu.envs.base import EnvState as JState

    from diffrl_tpu_torch.envs.base import EnvState as TState
    from diffrl_tpu_torch.testing import check_vjp

    E = 4
    kw = dict(num_envs=E, seed=0, stochastic_init=False, episode_length=50,
              MM_caching_frequency=MM[name], sim_backward=backward)
    if name == "TinySNU":
        je, te = JTinySNU(**kw), TTinySNU(device="cpu", **kw)
    else:
        je = jenvs.make(name, **kw)
        te = tenvs.make(name, device="cpu", **kw)
    assert je.sim_backward == te.sim_backward == backward
    q, qd, act, _, _ = inputs(te, E, seed)
    act = 0.9 * act
    early = name == "TinySNU"
    if early:           # the pelvis lying below the termination height
        q[0, 1] = te.termination_height - 0.15
    last = np.zeros((E, te.num_acts), np.float32)
    progress = np.array([3, 5, 7, 49], np.int32)
    w = np.random.RandomState(4).normal(size=(E, te.num_obs)).astype(
        np.float32)

    def jloss(a, b, c):
        s = JState(joint_q=b, joint_qd=c, actions=jnp.asarray(last),
                   progress=jnp.asarray(progress),
                   key=jax.random.PRNGKey(0))
        s2, obs, rew, done, info = je.step(s, a)
        return (jnp.sum(rew) + jnp.sum(obs * w),
                (obs, rew, done, s2.joint_q, s2.joint_qd, info["invalid"]))

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(act, q, qd)
    leaves = _leaves(act, q, qd)
    s = TState(leaves[1], leaves[2], torch.as_tensor(last),
               torch.as_tensor(progress))
    s2, obs, rew, done, info = te.step(s, leaves[0])
    np.testing.assert_array_equal(done.numpy(), np.asarray(jout[2]))
    assert done.tolist() == [early, False, False, True]
    np.testing.assert_array_equal(info["invalid"].numpy(),
                                  np.asarray(jout[5]))
    for lab, a, b in (("obs", obs, jout[0]), ("reward", rew, jout[1]),
                      ("joint_q", s2.joint_q, jout[3]),
                      ("joint_qd", s2.joint_qd, jout[4])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=5e-5,
                                   err_msg=f"{name} env step {lab}")
    tg = torch.autograd.grad(rew.sum() + torch.sum(obs * torch.as_tensor(w)),
                             leaves)
    for lab, a, b in zip(("actions", "joint_q", "joint_qd"), tg, jg):
        assert np.isfinite(a.numpy()).all()
        assert float(a.abs().max()) > 0.0, lab
        check_vjp(f"{name} env step grad {lab}", a.T,
                  torch.as_tensor(np.array(b)).T, 1e-3, 1e-4)


def host_inputs(env, E, seed):
    """Env-minor torch inputs of one cached substep at E envs: (q1, qd1,
    joint_act, muscle activations or None, H, Hinv, gq, gqd), after the
    refresh substep of ``inputs``' state."""
    from diffrl_tpu_torch.sim import articulation_lb as tlb

    q, qd, _, ja, ma = inputs(env, E, seed)
    q, qd = _minor(q, qd)
    ja = torch.as_tensor(ja)
    ma = None if ma is None else torch.as_tensor(ma)
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = tlb.refresh_substep_lb(
            env.model, torch.as_tensor(q), torch.as_tensor(qd), ja, ma, h)
    rs = np.random.RandomState(seed + 1)
    gq = torch.as_tensor(rs.normal(size=q1.shape), dtype=torch.float32)
    gqd = torch.as_tensor(rs.normal(size=qd1.shape), dtype=torch.float32)
    return q1, qd1, ja, ma, H, Hinv, gq, gqd


def check_host_kernels(env, k1, k2, ins, E, rest=False, floor=None):
    """The g++ builds of K1 and K2 (tests/_torch_host_kernels.py) on the
    first E envs of ``ins`` against their plain versions and the plain
    versions in float64 by diffrl_tpu_torch/testing.py's check_kernel (K1:
    q rtol 2e-5 atol 2e-6, qd rtol 2e-5 atol 2e-5; K2 with dma: rtol 2e-4
    atol 1e-5); with ``rest`` at zero joint velocities."""
    from diffrl_tpu_torch.sim import articulation_lb as tlb
    from diffrl_tpu_torch.testing import F64_FLOOR, check_kernel

    floor = F64_FLOOR if floor is None else floor
    m, h = env.model, env.dt / env.sim_substeps
    q1, qd1, ja, ma, H, Hinv, gq, gqd = (
        None if x is None else x[..., :E].contiguous() for x in ins)
    if rest:
        qd1 = torch.zeros_like(qd1)

    def f64(*xs):
        return [None if x is None else x.double() for x in xs]

    def npy(*xs):
        return [np.ascontiguousarray(x.numpy()) for x in xs]

    name = type(env).__name__
    hma = None if ma is None else ma.numpy()
    if not rest:
        want = tlb.substep_lb(m, q1, qd1, ja, ma, h, H, Hinv)
        exact = tlb.substep_lb(m, *f64(q1, qd1, ja, ma), h, *f64(H, Hinv))
        got = k1(*npy(q1, qd1, ja, Hinv), dt=h, ma=hma)
        for lab, g, w, x, atol in zip(("q", "qd"), got, want, exact,
                                      (2e-6, 2e-5)):
            check_kernel(f"{name} {lab}", torch.as_tensor(g), w, x, 2e-5,
                         atol, floor)
    want = tlb.substep_vjp_lb(m, q1, qd1, ja, ma, h, H, Hinv, gq, gqd)
    exact = tlb.substep_vjp_lb(m, *f64(q1, qd1, ja, ma), h,
                               *f64(H, Hinv, gq, gqd))
    got = k2(*npy(q1, qd1, ja, Hinv, gq, gqd), dt=h, ma=hma)
    order = [0, 1, 2, 4] + ([3] if ma is not None else [])
    assert len(got) == len(order)
    for g, i in zip(got, order):
        lab = ("dq", "dqd", "djoint_act", "dma", "dH")[i]
        assert np.isfinite(g).all()
        check_kernel(f"{name} {lab}", torch.as_tensor(g), want[i], exact[i],
                     2e-4, 1e-5, floor)

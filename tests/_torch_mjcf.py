"""Inputs and JAX comparisons shared by the CPU tests of the port's MJCF
envs (Humanoid, Hopper, Cheetah) against the JAX package.

Inputs are made from a numpy seed: each env's start pose with its joint
angles perturbed by up to 0.1 and its base lowered so that some ground
contacts are active, joint velocities up to 0.5, and the joint torques of
uniform actions in [-1, 1]. Tolerances are tests/test_articulation_lb.py's
(the lb engine against the unrolled one): refresh q rtol 2e-5 atol 1e-6,
qd rtol 2e-5 atol 2e-5, H rtol 2e-5 atol 1e-4, refresh VJP rtol 2e-3 atol
1e-3; cached substep q rtol 2e-5 atol 2e-6, qd rtol 2e-5 atol 2e-5, its VJP
rtol 5e-4 atol 1e-5 by the rules of diffrl_tpu_torch/testing.py: atol in
units of each env's largest entry (check_vjp), and no further from the
port's plain version run in float64 than twice JAX's own error there plus
rtol and 8 times JAX's largest error in the env (check_against_f64). On
Humanoid a dH = -lam qdd^T entry inherits qdd's float32 error, which is
relative to the largest terms of Hinv tau: there JAX itself sits up to
1.4e-3 from float64, outside an elementwise atol of 1e-5.
"""

import jax
import numpy as np
import torch

import diffrl_tpu.envs as jenvs
from diffrl_tpu.sim import articulation_lb as jlb

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.testing import check_against_f64, check_vjp

# substeps per env step, each env's mass-matrix period in its config
SUBSTEPS = {"Humanoid": 48, "Hopper": 16, "Cheetah": 16}
# how far the base is lowered: the start poses' lowest contact points sit
# 0.065 (Humanoid), 0.04 (Hopper) and 0.18 (Cheetah) above the ground
DROP = {"Humanoid": (-0.12, -0.06), "Hopper": (-0.10, -0.04),
        "Cheetah": (-0.25, -0.18)}


def envs(name, E=4, **kw):
    """(JAX env, port env on the CPU) with the same arguments."""
    kw = dict(num_envs=E, MM_caching_frequency=SUBSTEPS[name], **kw)
    return jenvs.make(name, **kw), tenvs.make(name, device="cpu", **kw)


def contact_inputs(name, env, E, seed, drop=None):
    """Env-leading float32 numpy (q [E, C], qd [E, D], actions [E, A]) and
    the env-minor joint torques ja [D, E] of those actions."""
    m = env.model
    rs = np.random.RandomState(seed)
    q = np.tile(np.asarray(m.joint_q_init, np.float64), (E, 1))
    free = 7 if m.topology.joint_type[0] == 4 else 0
    q[:, free:] += rs.uniform(-0.1, 0.1, (E, m.coord_count - free))
    q[:, 1] += rs.uniform(*(drop or DROP[name]), E)
    qd = rs.uniform(-0.5, 0.5, (E, m.dof_count))
    acts = rs.uniform(-1.0, 1.0, (E, env.num_acts)).astype(np.float32)
    ja = env.action_to_controls(torch.as_tensor(acts))[0].numpy()
    return (q.astype(np.float32), qd.astype(np.float32), acts,
            np.ascontiguousarray(ja.T))


def _minor(*xs):
    return [np.ascontiguousarray(x.T) for x in xs]


def _leaves(*xs):
    return [torch.as_tensor(np.array(x)).requires_grad_() for x in xs]


def _assert_active(tm, q):
    n = sk.active_contacts(tm, torch.as_tensor(q))
    assert n > 0, "no ground contact is active"


def check_refresh(name, E=4, seed=0):
    """refresh_substep_lb's values (q', qd', H) and its VJP with
    cotangents on (q', qd', H) against jax.vjp of the JAX one."""
    je, te = envs(name, E)
    jm, tm = je.model, te.model
    h = te.dt / te.sim_substeps
    q, qd, _, ja = contact_inputs(name, te, E, seed)
    q, qd = _minor(q, qd)
    _assert_active(tm, q)
    rs = np.random.RandomState(seed + 1)
    D = tm.dof_count
    cot = (rs.normal(size=q.shape).astype(np.float32),
           rs.normal(size=qd.shape).astype(np.float32),
           0.01 * rs.normal(size=(D, D, E)).astype(np.float32))

    def jrefresh(q, qd, ja, cot):
        def f(a, b, c):
            q1, qd1, H, _ = jlb.refresh_substep_lb(jm, a, b, c, None, h)
            return q1, qd1, H
        out, vjp = jax.vjp(f, q, qd, ja)
        return out, vjp(cot)

    (jq, jqd, jH), want = jax.jit(jrefresh)(q, qd, ja, cot)
    leaves = _leaves(q, qd, ja)
    tq, tqd, tH, _ = tlb.refresh_substep_lb(tm, *leaves, None, h)
    for lab, a, b, rtol, atol in (("q", tq, jq, 2e-5, 1e-6),
                                  ("qd", tqd, jqd, 2e-5, 2e-5),
                                  ("H", tH, jH, 2e-5, 1e-4)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{name} refresh {lab}")
    got = torch.autograd.grad((tq, tqd, tH), leaves,
                              [torch.as_tensor(c) for c in cot])
    for lab, a, b in zip(("dq", "dqd", "dja"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=1e-3,
                                   err_msg=f"{name} refresh vjp {lab}")


def check_cached(name, E=4, seed=2):
    """substep_lb's values and its VJP (cotangents on q', qd'; the
    frozen-factor H cotangent) against jax.vjp of the JAX one, both on the
    port's refresh factorization; and the kernel wrappers on CPU tensors,
    which run these plain versions without launching."""
    je, te = envs(name, E)
    jm, tm = je.model, te.model
    h = te.dt / te.sim_substeps
    q, qd, _, ja = contact_inputs(name, te, E, seed)
    q, qd = _minor(q, qd)
    with torch.no_grad():
        q1, qd1, H, Hinv = tlb.refresh_substep_lb(
            tm, *map(torch.as_tensor, (q, qd, ja)), None, h)
    args = [x.numpy() for x in (q1, qd1)] + [ja, H.numpy()]
    Hinv = Hinv.numpy()
    _assert_active(tm, args[0])
    rs = np.random.RandomState(seed + 1)
    cot = (rs.normal(size=q.shape).astype(np.float32),
           rs.normal(size=qd.shape).astype(np.float32))

    def jcached(q, qd, ja, H, Hinv, cot):
        out, vjp = jax.vjp(lambda a, b, c, d: jlb.substep_lb(
            jm, a, b, c, None, h, d, Hinv), q, qd, ja, H)
        return out, vjp(cot)

    (jq, jqd), want = jax.jit(jcached)(*args, Hinv, cot)
    leaves = _leaves(*args)
    tq, tqd = tlb.substep_lb(tm, *leaves[:3], None, h, leaves[3],
                             torch.as_tensor(Hinv))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=2e-5, atol=2e-6, err_msg=f"{name} q")
    np.testing.assert_allclose(tqd.detach().numpy(), np.asarray(jqd),
                               rtol=2e-5, atol=2e-5, err_msg=f"{name} qd")
    got = torch.autograd.grad((tq, tqd), leaves,
                              [torch.as_tensor(c) for c in cot])
    exact = tlb.substep_vjp_lb(
        tm, *(torch.as_tensor(x).double() for x in args[:3]), None, h,
        *(torch.as_tensor(x).double() for x in (args[3], Hinv, *cot)))
    for lab, a, b, x in zip(("dq", "dqd", "dja", "dH"), got, want,
                            exact[:3] + exact[4:]):
        b = torch.as_tensor(np.array(b))
        check_vjp(f"{name} vjp {lab}", a, b, 5e-4, 1e-5)
        check_against_f64(f"{name} vjp {lab}", a, b, x, 5e-4, 1e-5)
    # the wrappers on CPU tensors: the plain versions, no launch
    n = (sk.substep_forward.launches, sk.substep_vjp.launches)
    plain = [torch.as_tensor(x) for x in (*args, Hinv, *cot)]
    fq, fqd = sk.substep_forward(tm, *plain[:3], None, h, *plain[3:5])
    vj = sk.substep_vjp(tm, *plain[:3], None, h, *plain[3:])
    assert (sk.substep_forward.launches, sk.substep_vjp.launches) == n
    assert torch.equal(fq, tq.detach()) and torch.equal(fqd, tqd.detach())
    for a, b in zip(vj[:3] + vj[4:], got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def check_env_step(name, early_done=True):
    """env.step from injected identical states and actions at E = 4, both
    sides with the env's own substeps in one mass-matrix period: the
    values (obs, reward, done, next state; rtol 1e-5, atol 5e-5) and the
    gradient of sum(reward) + <w, obs> w.r.t. (actions, joint_q, joint_qd)
    (rtol 1e-3, atol 1e-4 in units of each env's largest entry). Env 3 hits
    the time limit; with ``early_done`` env 0 (a free base) lies on the
    ground below the termination height. Both reset inside the step."""
    from diffrl_tpu.envs.base import EnvState as JState

    from diffrl_tpu_torch.envs.base import EnvState as TState

    E = 4
    kw = dict(num_envs=E, seed=0, stochastic_init=False, episode_length=50,
              MM_caching_frequency=SUBSTEPS[name])
    je = jenvs.make(name, sim_backward="lb", **kw)
    te = tenvs.make(name, device="cpu", **kw)
    q, qd, act, _ = contact_inputs(name, te, E, seed=3)
    act = 0.9 * act
    if early_done:      # a free base lying down below the termination
        q[0, 1] = te.termination_height - 0.25     # height, nothing in the
        q[0, 3:7] = (0.0, 0.0, 0.0, 1.0)           # ground
    last = np.zeros((E, te.num_acts), np.float32)
    progress = np.array([3, 5, 7, 49], np.int32)
    w = np.random.RandomState(4).normal(size=(E, te.num_obs)).astype(
        np.float32)

    def jloss(a, b, c):
        s = JState(joint_q=b, joint_qd=c, actions=jax.numpy.asarray(last),
                   progress=jax.numpy.asarray(progress),
                   key=jax.random.PRNGKey(0))
        s2, obs, rew, done, info = je.step(s, a)
        return (jax.numpy.sum(rew) + jax.numpy.sum(obs * w),
                (obs, rew, done, s2.joint_q, s2.joint_qd, info["invalid"]))

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(act, q, qd)
    leaves = _leaves(act, q, qd)
    s = TState(leaves[1], leaves[2], torch.as_tensor(last),
               torch.as_tensor(progress))
    s2, obs, rew, done, info = te.step(s, leaves[0])
    want_done = [early_done, False, False, True]
    np.testing.assert_array_equal(done.numpy(), np.asarray(jout[2]))
    assert done.tolist() == want_done
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
    # atol in units of each env's largest entry (testing.check_vjp, as
    # chip_smoke.py holds an env step's gradient): a Humanoid joint_q
    # gradient of 0.1 beside one of 138 in the same env carries float32
    # noise of the larger one's size
    for lab, a, b in zip(("actions", "joint_q", "joint_qd"), tg, jg):
        assert np.isfinite(a.numpy()).all()
        check_vjp(f"{name} env step grad {lab}", a.T,
                  torch.as_tensor(np.array(b)).T, 1e-3, 1e-4)

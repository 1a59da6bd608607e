"""The gradient of the port's env.step (diffrl_tpu_torch.envs.base with the
replay reverse pass) against the JAX env on its lb engine, on Ant on the
CPU: d/d(actions, joint_q, joint_qd) of sum(reward) + <w, obs> through one
step in which two envs reset, rtol 1e-3 atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import diffrl_tpu.envs as jenvs
from diffrl_tpu.envs.base import EnvState as JState

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.envs.base import EnvState as TState

from test_torch_grad import _t


def test_env_step_gradient_matches_jax():
    """d/d(actions, joint_q, joint_qd) of sum(reward) + <w, obs> through one
    env step in which env 0 terminates and env 3 hits the time limit (both
    reset), JAX on its lb engine. Both sides cut the step to 4 substeps
    (one refresh and 3 cached substeps) to keep JAX's compile time small."""
    E = 4
    kw = dict(num_envs=E, seed=0, MM_caching_frequency=4,
              stochastic_init=False, episode_length=50)
    je = jenvs.make("Ant", sim_backward="lb", **kw)
    te = tenvs.make("Ant", device="cpu", **kw)
    je.sim_substeps = te.sim_substeps = 4
    rs = np.random.RandomState(3)
    q = np.tile(np.asarray(te.model.joint_q_init), (E, 1))
    q = (q + rs.uniform(-0.05, 0.05, q.shape)).astype(np.float32)
    q[0, 1] = 0.2                         # below the termination height
    qd = rs.uniform(-0.3, 0.3, (E, te.model.dof_count)).astype(np.float32)
    act = rs.uniform(-0.9, 0.9, (E, 8)).astype(np.float32)
    last = np.zeros((E, 8), np.float32)
    progress = np.array([3, 5, 7, 49], np.int32)
    w = rs.normal(size=(E, te.num_obs)).astype(np.float32)

    def jloss(a, b, c):
        s = JState(joint_q=b, joint_qd=c, actions=jnp.asarray(last),
                   progress=jnp.asarray(progress), key=jax.random.PRNGKey(0))
        _, obs, rew, done, _ = je.step(s, a)
        return jnp.sum(rew) + jnp.sum(obs * w), done

    (_, jdone), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(act, q, qd)
    leaves = [x.requires_grad_() for x in _t(act, q, qd)]
    s = TState(leaves[1], leaves[2], torch.as_tensor(last),
               torch.as_tensor(progress))
    _, obs, rew, done, _ = te.step(s, leaves[0])
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.tolist() == [True, False, False, True]
    tg = torch.autograd.grad(rew.sum() + torch.sum(obs * torch.as_tensor(w)),
                             leaves)
    for lab, a, b in zip(("actions", "joint_q", "joint_qd"), tg, jg):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4, err_msg=f"env step grad {lab}")

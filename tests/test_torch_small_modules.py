"""The port's small modules against the JAX package's, on the CPU:
utils.dataset.CriticDataset, envs.wrappers.StatefulEnv and config's
check_finite, gradcheck and enable_fp_verification.

- CriticDataset: the same buffers ([4, 5, 3] observations, [4, 5] targets)
  give the same batches, lengths (drop_last or not) and, shuffled, the
  same rows in pairs (the two packages draw other permutations).
- StatefulEnv on CartPole (4 envs, deterministic starts, 4 substeps, mm
  4): its reset and three steps equal the env's own reset and steps bit
  for bit, and the JAX wrapper's values at rtol 1e-5, atol 5e-5 (the
  tolerance of the env step in tests/test_torch_cartpole.py);
  clear_grad and initialize_trajectory cut the graph, a checkpoint is a
  copy; the gymnasium spaces as the JAX wrapper's where gymnasium imports.
- check_finite raises FloatingPointError with JAX's message; gradcheck
  passes a right gradient and raises AssertionError on a wrong one, as
  JAX's does on the same function and the same wrong gradient;
  enable_fp_verification makes env.step raise on a non-finite state and
  switches autograd's anomaly detection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffrl_tpu.config as jconfig
import diffrl_tpu.envs as jenvs
from diffrl_tpu.envs.wrappers import StatefulEnv as JStatefulEnv
from diffrl_tpu.utils.dataset import CriticDataset as JCriticDataset

import diffrl_tpu_torch.config as tconfig
import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.envs import StatefulEnv
from diffrl_tpu_torch.envs.base import EnvState
from diffrl_tpu_torch.utils import CriticDataset

torch.set_num_threads(1)  # the suite's pytest workers share a few cores

KW = dict(num_envs=4, seed=0, stochastic_init=False, episode_length=50,
          MM_caching_frequency=4)


@pytest.mark.parametrize("drop_last", [False, True])
def test_critic_dataset_matches_jax(drop_last):
    rs = np.random.RandomState(0)
    obs = rs.normal(size=(4, 5, 3)).astype(np.float32)
    tv = rs.normal(size=(4, 5)).astype(np.float32)
    jd = JCriticDataset(6, obs, tv, drop_last=drop_last)
    td = CriticDataset(6, torch.as_tensor(obs), torch.as_tensor(tv),
                       drop_last=drop_last)
    assert len(td) == len(jd) == (3 if drop_last else 4)
    for i in range(len(jd)):
        for k in ("obs", "target_values"):
            np.testing.assert_array_equal(td[i][k].numpy(), jd[i][k])
    sd = CriticDataset(6, torch.as_tensor(obs), torch.as_tensor(tv),
                       shuffle=True, drop_last=drop_last,
                       generator=torch.Generator().manual_seed(1))
    assert not torch.equal(sd.obs, td.obs)
    rows = {tuple(o) + (t,) for o, t in zip(jd.obs.tolist(),
                                            jd.target_values.tolist())}
    assert rows == {tuple(o) + (t,) for o, t in zip(
        sd.obs.tolist(), sd.target_values.tolist())}


def test_stateful_env_matches_env_and_jax():
    env = tenvs.make("CartPoleSwingUp", device="cpu", **KW)
    direct = tenvs.make("CartPoleSwingUp", device="cpu", **KW)
    w = StatefulEnv(env)
    jw = JStatefulEnv(jenvs.make("CartPoleSwingUp", sim_backward="lb", **KW))
    assert (w.num_envs, w.num_obs, w.num_actions, w.episode_length) == (
        jw.num_envs, jw.num_obs, jw.num_actions, jw.episode_length)
    assert hasattr(w, "observation_space") == hasattr(
        jw, "observation_space")
    if hasattr(jw, "observation_space"):
        assert w.observation_space.shape == jw.observation_space.shape
        assert w.action_space.shape == jw.action_space.shape
    obs, jobs = w.reset(), jw.reset()
    state = direct.reset()
    assert torch.equal(obs, direct.batch_observations(state))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-5,
                               atol=5e-5)
    acts = np.random.RandomState(1).uniform(-1, 1, (3, 4, 1)).astype(
        np.float32)
    for a in acts:
        out = w.step(torch.as_tensor(a))
        jout = jw.step(jnp.asarray(a))
        state, *want = direct.step(state, torch.as_tensor(a))
        for got, d, j in zip(out[:3], want[:3], jout[:3]):
            assert torch.equal(got, d)
            np.testing.assert_allclose(got.numpy().astype(np.float32),
                                       np.asarray(j, np.float32),
                                       rtol=1e-5, atol=5e-5)
    assert torch.equal(w.state.joint_q, state.joint_q)


def test_stateful_env_cuts_the_graph():
    w = StatefulEnv(tenvs.make("CartPoleSwingUp", device="cpu", **KW))
    w.reset()
    a = torch.full((4, 1), 0.5, requires_grad=True)
    w.step(a)
    assert w.state.joint_q.grad_fn is not None
    ckpt = w.get_checkpoint()
    w.clear_grad()
    assert w.state.joint_q.grad_fn is None
    obs, _, _, _ = w.step(a)
    assert obs.grad_fn is not None
    assert w.initialize_trajectory().grad_fn is None
    assert ckpt.joint_q.data_ptr() != w.state.joint_q.data_ptr()
    w.load_checkpoint(ckpt)
    assert w.state is ckpt
    with pytest.raises(RuntimeError, match="reset"):
        StatefulEnv(tenvs.make("CartPoleSwingUp", device="cpu", **KW)).step(a)


def test_check_finite_matches_jax():
    ok, bad = np.ones(3, np.float32), np.array([1.0, np.nan], np.float32)
    jconfig.check_finite(ok, None, name="x")
    tconfig.check_finite(torch.as_tensor(ok), None, name="x")
    with pytest.raises(FloatingPointError) as jerr:
        jconfig.check_finite(ok, jnp.asarray(bad), name="x")
    with pytest.raises(FloatingPointError) as terr:
        tconfig.check_finite(torch.as_tensor(ok), torch.as_tensor(bad),
                             name="x")
    assert str(terr.value) == str(jerr.value) == "non-finite value in x[1]"
    with pytest.raises(FloatingPointError):
        tconfig.check_finite(torch.tensor([np.inf]), name="y")


@jax.custom_vjp
def _jsquare(x):
    return x * x


_jsquare.defvjp(lambda x: (x * x, x), lambda x, g: (3.0 * x * g,))


class _TSquare(torch.autograd.Function):
    """x^2 with the wrong gradient 3x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return 3.0 * x * g


def test_gradcheck_matches_jax():
    x = np.array([0.3, -1.2, 2.0], np.float32)
    w = np.array([1.0, 2.0, -0.5], np.float32)
    assert jconfig.gradcheck(lambda v: jnp.sum(jnp.sin(v) * w), (x,))
    assert tconfig.gradcheck(
        lambda v: torch.sum(torch.sin(v) * torch.as_tensor(w, dtype=v.dtype)),
        (torch.as_tensor(x),))
    with pytest.raises(AssertionError):
        jconfig.gradcheck(lambda v: jnp.sum(_jsquare(v) * w), (x,))
    with pytest.raises(AssertionError):
        tconfig.gradcheck(lambda v: torch.sum(
            _TSquare.apply(v) * torch.as_tensor(w, dtype=v.dtype)),
            (torch.as_tensor(x),))
    # a scalar function of the second argument
    assert tconfig.gradcheck(lambda a, v: (a * v ** 3).sum(),
                             (2.0, torch.as_tensor(x)), argnums=1)


def test_fp_verification_raises_on_a_blown_up_env():
    env = tenvs.make("CartPoleSwingUp", device="cpu", **KW)
    s = env.reset()
    bad = EnvState(s.joint_q.clone(), s.joint_qd.clone(), s.actions,
                   s.progress)
    bad.joint_qd[1, 0] = float("nan")
    zero = torch.zeros((4, 1))
    env.step(bad, zero)                       # off: no check
    try:
        tconfig.enable_fp_verification(True)
        assert tconfig.verify_fp and torch.is_anomaly_enabled()
        env.step(s, zero)
        with pytest.raises(FloatingPointError, match="CartPole"):
            env.step(bad, zero)
    finally:
        tconfig.enable_fp_verification(False)
    assert not tconfig.verify_fp and not torch.is_anomaly_enabled()

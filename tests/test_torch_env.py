"""The port's env, actor and rollout (diffrl_tpu_torch.envs, models,
utils.convert, algorithms.eval_utils) against the JAX package, on the CPU.

JAX PRNG streams cannot be reproduced in torch, so every comparison starts
from identical injected states (made with numpy) or from the deterministic
start state (stochastic_init=False), and the policy is deterministic.
Tolerances: one env step runs 16 substeps of reassociated float32 math,
compared at rtol 1e-5 / atol 5e-5 (measured differences are ~6e-6 on
velocities of magnitude ~3); flags exactly; network outputs at rtol/atol
1e-5; the slice as a whole (3 policy steps) at rtol/atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffrl_tpu.envs as jenvs
from diffrl_tpu.algorithms.eval_utils import batched_eval as jbatched_eval
from diffrl_tpu.envs.base import EnvState as JState
from diffrl_tpu.models.mlp import ActorDeterministicMLP as JActorDet
from diffrl_tpu.models.mlp import ActorStochasticMLP as JActor
from diffrl_tpu.utils.running_mean_std import RunningMeanStd as JRMS

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.algorithms import batched_eval, policy_act_fn
from diffrl_tpu_torch.envs.base import EnvState as TState
from diffrl_tpu_torch.utils.convert import (actor_from_jax,
                                            running_mean_std_from_jax)

E = 8
CFG = {"actor_mlp": {"units": [128, 64, 32], "activation": "elu"}}
STEP_TOL = dict(rtol=1e-5, atol=5e-5)


def _env_pair(episode_length=1000):
    kw = dict(num_envs=E, seed=0, MM_caching_frequency=16,
              stochastic_init=False, episode_length=episode_length)
    return (jenvs.make("Ant", sim_backward="lb", **kw),
            tenvs.make("Ant", device="cpu", **kw))


@pytest.fixture(scope="module")
def ant_pair():
    je, te = _env_pair()
    return je, te, jax.jit(je.step)


@pytest.fixture(scope="module")
def policy():
    """JAX actor params + obs_rms and their converted port modules."""
    jactor = JActor(37, 8, CFG)
    params = jax.device_get(jactor.init(jax.random.PRNGKey(3)))
    rs = np.random.RandomState(4)
    batch = rs.normal(0.5, 2.0, (64, 37)).astype(np.float32)
    rms = jax.device_get(JRMS.create((37,)).update(jnp.asarray(batch)))
    tactor = actor_from_jax(params, 37, 8, CFG, device="cpu")
    trms = running_mean_std_from_jax(rms, device="cpu")
    return jactor, params, rms, tactor, trms


def _states(model, seed):
    rs = np.random.RandomState(seed)
    q = np.tile(np.asarray(model.joint_q_init), (E, 1))
    q = (q + rs.uniform(-0.05, 0.05, q.shape)).astype(np.float32)
    q[0, 1] = 0.2            # below termination_height: exercises the reset
    qd = rs.uniform(-0.3, 0.3, (E, model.dof_count)).astype(np.float32)
    actions = rs.uniform(-1.0, 1.0, (E, 8)).astype(np.float32)
    progress = np.array([0, 5, 998, 3, 0, 1, 2, 999], np.int32)  # 7: limit
    return q, qd, actions, progress


def _close(a, b, **tol):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def test_env_step_matches_jax_with_reset(ant_pair):
    je, te, jstep = ant_pair
    q, qd, last, progress = _states(te.model, seed=0)
    act = np.random.RandomState(1).uniform(-1.2, 1.2, (E, 8)).astype(
        np.float32)                                  # clipped to [-1, 1]
    js = JState(joint_q=jnp.asarray(q), joint_qd=jnp.asarray(qd),
                actions=jnp.asarray(last), progress=jnp.asarray(progress),
                key=jax.random.PRNGKey(0))
    ts = TState(*map(torch.as_tensor, (q, qd, last, progress)))
    jn, jobs, jrew, jdone, jinfo = jstep(js, jnp.asarray(act))
    tn, tobs, trew, tdone, tinfo = te.step(ts, torch.as_tensor(act))

    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert bool(tdone[0]) and bool(tdone[7]) and not bool(tdone[1:7].any())
    for k in ("episode_end", "invalid", "truncation"):
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tn.progress.numpy(), np.asarray(jn.progress))
    _close(tn.joint_q, jn.joint_q, **STEP_TOL)
    _close(tn.joint_qd, jn.joint_qd, **STEP_TOL)
    _close(tn.actions, jn.actions, **STEP_TOL)
    _close(tobs, jobs, **STEP_TOL)
    _close(tinfo["obs_before_reset"], jinfo["obs_before_reset"], **STEP_TOL)
    _close(trew, jrew, **STEP_TOL)
    # the reset envs are back at the start state, with the reset obs
    _close(tn.joint_q[0], te.model.joint_q_init, rtol=0, atol=0)
    _close(tobs[0], te.batch_observations(tn)[0], rtol=0, atol=0)


def test_env_reset_and_initial_observations(ant_pair):
    je, te, _ = ant_pair
    js = je.reset(jax.random.PRNGKey(0))
    ts = te.reset()
    _close(ts.joint_q, js.joint_q, rtol=0, atol=0)
    _close(ts.joint_qd, js.joint_qd, rtol=0, atol=0)
    _close(te.batch_observations(ts), je.batch_observations(js), rtol=1e-6,
           atol=1e-6)
    det, obs = te.initialize_trajectory(ts)
    assert not det.joint_q.requires_grad and obs.shape == (E, 37)


def test_stochastic_init_uses_env_generator():
    a = tenvs.make("Ant", num_envs=4, seed=7, stochastic_init=True,
                   device="cpu")
    b = tenvs.make("Ant", num_envs=4, seed=7, stochastic_init=True,
                   device="cpu")
    sa, sb = a.reset(), b.reset()
    assert torch.equal(sa.joint_q, sb.joint_q)
    assert not torch.equal(sa.joint_q[0], sa.joint_q[1])
    quat_norm = torch.linalg.vector_norm(sa.joint_q[:, 3:7], dim=-1)
    torch.testing.assert_close(quat_norm, torch.ones(4), rtol=0, atol=1e-6)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenvs.make("Ant", num_envs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        actor_from_jax({"mlp": [], "logstd": np.zeros(8)}, 37, 8, CFG)
    with pytest.raises(KeyError):       # a name no package registers
        tenvs.make("NoSuchEnv", device="cpu")


def test_actor_and_obs_rms_through_converter(policy):
    jactor, params, rms, tactor, trms = policy
    obs = np.random.RandomState(5).normal(0.0, 3.0, (E, 37)).astype(
        np.float32)
    jn = rms.normalize(jnp.asarray(obs))
    tn = trms.normalize(torch.as_tensor(obs))
    _close(tn, jn, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        _close(tactor(tn, deterministic=True),
               jactor(params, jn, deterministic=True), rtol=1e-5, atol=1e-5)
        _close(tactor.logstd, params["logstd"], rtol=0, atol=0)
    jdet = JActorDet(37, 8, CFG)
    dparams = jax.device_get(jdet.init(jax.random.PRNGKey(6)))
    tdet = actor_from_jax(dparams, 37, 8, CFG, stochastic=False,
                          device="cpu")
    with torch.no_grad():
        _close(tdet(tn), jdet(dparams, jn), rtol=1e-5, atol=1e-5)


def test_policy_rollout_matches_jax(ant_pair, policy):
    """The slice as a whole: 3 steps of tanh(actor(obs_rms.normalize(obs)))
    from the same injected states, on the same converted weights."""
    je, te, jstep = ant_pair
    jactor, params, rms, tactor, trms = policy
    q, qd, last, progress = _states(te.model, seed=2)
    js = JState(joint_q=jnp.asarray(q), joint_qd=jnp.asarray(qd),
                actions=jnp.asarray(last), progress=jnp.asarray(progress),
                key=jax.random.PRNGKey(0))
    ts = TState(*map(torch.as_tensor, (q, qd, last, progress)))
    jact = jax.jit(lambda o: jnp.tanh(
        jactor(params, rms.normalize(o), deterministic=True)))
    tact = policy_act_fn(tactor, trms, deterministic=True)
    jobs, tobs = je.batch_observations(js), te.batch_observations(ts)
    tol = dict(rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        for _ in range(3):
            ja, ta = jact(jobs), tact(tobs, None)
            _close(ta, ja, **tol)
            js, jobs, jrew, jdone, _ = jstep(js, ja)
            ts, tobs, trew, tdone, _ = te.step(ts, ta)
            np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
            _close(tobs, jobs, **tol)
            _close(trew, jrew, **tol)
            _close(ts.joint_q, js.joint_q, **tol)
            _close(ts.joint_qd, js.joint_qd, **tol)


def test_batched_eval_matches_jax(policy):
    """The slice's entry point: batched_eval over 3-step episodes."""
    jactor, params, rms, tactor, trms = policy
    je, te = _env_pair(episode_length=3)

    def jact(obs, key):
        return jnp.tanh(jactor(params, rms.normalize(obs), deterministic=True))

    want = jbatched_eval(je, jact, jax.random.PRNGKey(0), num_games=E,
                         gamma=0.99)
    got = batched_eval(te, policy_act_fn(tactor, trms, deterministic=True),
                       num_games=E, gamma=0.99)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[2] == 3.0

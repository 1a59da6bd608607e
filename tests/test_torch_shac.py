"""The port's SHAC trainer (diffrl_tpu_torch.algorithms.shac, with
utils.convert, utils.running_mean_std and the training path of the
simulator) against the JAX package's SHAC, on the CPU.

One JAX trainer per module: Ant from examples/cfg/shac/ant.yaml at E = 4,
steps_num 2, critic_iterations 2, num_batch 2, sim_backward "lb", with
sim_substeps cut to 4 (mm 4) on both sides to keep JAX's compile time
small. Its weights, statistics and env state go into port trainers through
utils.convert. Tolerances:
- the window loss and the actor gradients through the simulator: rtol 1e-3,
  atol 1e-4 (two env steps of reassociated float32 physics, as the window
  gradient in tests/test_torch_grad_window.py; that test is in
  tests/test_torch_shac_window.py, with these trainers);
- TD(lambda) targets: rtol/atol 1e-5 (the same recursion on the same
  inputs);
- the critic update on JAX's permutations: rtol/atol 1e-5;
- Adam with the schedule and the clip on injected identical gradients:
  rtol/atol 1e-6 (Adam's first steps move each parameter by about
  lr * sign(g), so gradients that differ only in rounding are not compared
  through it).
The actor is run deterministically on both sides: JAX's PRNG streams cannot
be reproduced in torch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from diffrl_tpu.algorithms.shac import SHAC as JSHAC

from diffrl_tpu_torch.algorithms import SHAC
from diffrl_tpu_torch.envs.base import EnvState as TState
from diffrl_tpu_torch.utils.convert import (load_adam_state, load_params,
                                            param_pairs)

HERE = os.path.dirname(__file__)
E, STEPS = 4, 2


def _cfg(logdir, **diff_env):
    with open(os.path.join(HERE, "..", "examples", "cfg", "shac",
                           "ant.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(logdir), "seed": 0}
    cfg["params"]["config"].update(num_actors=E, steps_num=STEPS,
                                   critic_iterations=2, num_batch=2,
                                   max_epochs=3, save_interval=0)
    cfg["params"]["diff_env"].update(
        {"sim_backward": "lb", "MM_caching_frequency": 4, **diff_env})
    return cfg


def _port(cfg, jt=None):
    """A port trainer on the CPU with 4 substeps per env step; with ``jt``,
    holding the JAX trainer's weights, statistics and env state."""
    tt = SHAC(cfg, device="cpu")
    tt.env.sim_substeps = 4
    if jt is not None:
        get = jax.device_get
        load_params(tt.actor, get(jt.actor_params))
        load_params(tt.critic, get(jt.critic_params))
        load_params(tt.target_critic, get(jt.target_critic_params))
        s = get(jt.env_state)
        tt.env_state = TState(*(torch.as_tensor(np.array(x)) for x in (
            s.joint_q, s.joint_qd, s.actions, s.progress)))
        rms = get(jt.obs_rms)
        for k in ("mean", "var", "count"):
            getattr(tt.obs_rms, k).copy_(torch.as_tensor(
                np.array(getattr(rms, k))))
    return tt


@pytest.fixture(scope="module")
def jtrainer(tmp_path_factory):
    jt = JSHAC(_cfg(tmp_path_factory.mktemp("jshac")))
    jt.env.sim_substeps = 4
    return jt


def _close(a, b, **tol):
    np.testing.assert_allclose(torch.as_tensor(a).detach().numpy(),
                               np.asarray(b), **tol)


def test_td_lambda_targets_match_jax(jtrainer, tmp_path):
    jt = jtrainer
    tt = _port(_cfg(tmp_path))
    rs = np.random.RandomState(0)
    H = 6
    rew = rs.normal(size=(H, E)).astype(np.float32)
    nv = rs.normal(size=(H, E)).astype(np.float32)
    done = (rs.uniform(size=(H, E)) < 0.3).astype(np.float32)
    done[-1] = 1.0
    want = jt._compute_target_values(rew, done, nv)
    got = tt.target_values(*map(torch.as_tensor, (rew, done, nv)))
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_critic_update_matches_jax_on_its_permutations(jtrainer, tmp_path):
    """2 iterations x 2 minibatches on 7 rows (batch size 4: the last batch
    carries one zero-weight pad row), with JAX's shuffles."""
    jt = jtrainer
    tt = _port(_cfg(tmp_path), jt)
    rs = np.random.RandomState(1)
    n = 7
    obs = rs.normal(size=(n, tt.num_obs)).astype(np.float32)
    target = rs.normal(size=(n,)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, n)))
             for k in jax.random.split(key, tt.critic_iterations)]
    jparams, _, jloss = jt._critic_update(
        jt.critic_params, jt.critic_opt_state, obs, target, key)
    tloss = tt.critic_update(torch.as_tensor(obs), torch.as_tensor(target),
                             perms=perms)
    _close(tloss, jloss, rtol=1e-5, atol=1e-5)
    for name, p, want in param_pairs(tt.critic, jax.device_get(jparams)):
        _close(p, want, rtol=1e-5, atol=1e-5, err_msg=name)
    assert tt.critic_updates == 4


def test_adam_schedule_and_clip_match_optax(jtrainer, tmp_path):
    """Three actor updates from injected identical gradients: a NaN entry
    (zeroed), a norm far above grad_norm (clipped) and one below it, at the
    linearly decaying learning rate, from a non-fresh Adam state."""
    jt = jtrainer
    tt = _port(_cfg(tmp_path), jt)
    params = jax.device_get(jt.actor_params)
    rs = np.random.RandomState(2)
    shaped = jax.tree.map(lambda x: np.asarray(x), params)
    mu = jax.tree.map(lambda x: rs.normal(0, 1e-2, x.shape).astype(
        np.float32), shaped)
    nu = jax.tree.map(lambda x: rs.uniform(1e-6, 1e-4, x.shape).astype(
        np.float32), shaped)
    count = 1
    state = jt.actor_opt.init(params)
    state = (state[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu,
                               nu=nu),
             state[1]._replace(count=jnp.asarray(count, jnp.int32)))
    load_adam_state(tt.actor_opt, tt.actor, mu, nu, count)
    tt.actor_updates = count
    for step, scale in enumerate((30.0, 0.01, 5.0)):
        grads = jax.tree.map(lambda x: (rs.normal(size=x.shape) * scale
                                        ).astype(np.float32), shaped)
        if step == 0:
            grads["mlp"][0]["w"][0, 0] = np.nan
        # the JAX trainer's actor_update after its value_and_grad
        g = jax.tree.map(lambda x: jnp.nan_to_num(x, 0.0, 0.0, 0.0), grads)
        gnorm = optax.global_norm(g)
        g = jax.tree.map(
            lambda x: x * jnp.minimum(1.0, jt.grad_norm / (gnorm + 1e-12)), g)
        updates, state = jt.actor_opt.update(g, state, params)
        params = optax.apply_updates(params, updates)

        for _, p, x in param_pairs(tt.actor, grads):
            p.grad = torch.as_tensor(np.array(x))
        before, after = tt.apply_actor_grads()
        _close(before, gnorm, rtol=1e-6, atol=1e-6)
        assert float(after) <= tt.grad_norm * (1 + 1e-6)
        for name, p, want in param_pairs(tt.actor, jax.device_get(params)):
            _close(p, want, rtol=1e-6, atol=1e-6, err_msg=f"{step} {name}")
    assert tt.actor_updates == count + 3


def test_train_epochs_and_checkpoint_round_trip(tmp_path):
    """train() end to end (one epoch, 2-step episodes so the window holds
    resets and the meters fill), then save and load into a fresh trainer."""
    cfg = _cfg(tmp_path / "a", episode_length=2)
    cfg["params"]["config"]["max_epochs"] = 1
    tt = _port(cfg)
    before = [p.detach().clone() for p in tt.actor.parameters()]
    critic_before = [p.detach().clone() for p in tt.critic.parameters()]
    tt.train()
    assert np.isfinite(tt.actor_loss) and np.isfinite(tt.value_loss)
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tt.actor.parameters()) if a.numel() > 1)
    assert all(not torch.equal(a, b) for a, b in
               zip(critic_before, tt.critic.parameters()))
    assert tt.iter_count == 1 and tt.step_count == E * STEPS
    assert len(tt.episode_length_his) == E and \
        set(tt.episode_length_his) == {2.0}
    for f in ("final_policy.pt", "best_policy.pt", "episode_loss_his.npy",
              "scalars.npz"):
        assert (tmp_path / "a" / f).exists(), f
    mean_loss, mean_disc, mean_len = tt.evaluate_policy(num_games=E)
    assert np.isfinite(mean_loss) and np.isfinite(mean_disc)
    assert mean_len == 2.0

    other = _port(_cfg(tmp_path / "b", episode_length=2))
    other.load(str(tmp_path / "a" / "final_policy.pt"))
    for mod in ("actor", "critic", "target_critic", "obs_rms"):
        a, b = getattr(tt, mod).state_dict(), getattr(other, mod).state_dict()
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), mod
    for opt in ("actor_opt", "critic_opt"):
        a = getattr(tt, opt).state_dict()["state"]
        b = getattr(other, opt).state_dict()["state"]
        assert all(torch.equal(a[i][k], b[i][k]) for i in a for k in a[i])
    assert (other.actor_updates, other.critic_updates, other.iter_count) == \
        (tt.actor_updates, tt.critic_updates, tt.iter_count)


def test_shac_options_raise(tmp_path):
    cfg = _cfg(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SHAC(cfg)
    cfg["params"]["config"]["multi_gpu"] = True
    mesh = SHAC(cfg, device="cpu").mesh      # no process group: one rank
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    cfg = _cfg(tmp_path, sim_backward="remat")
    assert SHAC(cfg, device="cpu").env.sim_backward == "remat"
    cfg = _cfg(tmp_path, sim_backward="scan")
    with pytest.raises(ValueError, match="sim_backward"):
        SHAC(cfg, device="cpu")

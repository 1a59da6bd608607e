"""The port's BPTT (diffrl_tpu_torch.algorithms.bptt, with optim and the
training path of the simulator) against the JAX package's BPTT, on the CPU.

One JAX trainer from examples/cfg/bptt/cartpole_swing_up.yaml at E = 4,
steps_num 8, obs_rms on, sim_backward "lb" (the conftest pins "remat"); its
weights, statistics and env state go into a port trainer, and both run the
window from JAX's draws of the stochastic actor's noise (rebuilt from its
key stream on the host). From identical Adam states (at count 3, the
second moments from a seed, the first at 0: Adam's first step is about lr
sign(g), which rounding of a gradient near 0 could flip) both take the
step; JAX's gradient, clipped, is its first moment after the step over 1 -
b1 (one compile of its actor update). Tolerances:
- the window loss rtol 1e-4; the actor gradients and their norm rtol 1e-3,
  atol 1e-4 in units of each tensor's largest entry (8 env steps of
  reassociated float32 physics, as the SHAC window in
  tests/test_torch_shac_window.py); the parameters after the Adam step
  and Adam's moments rtol 1e-4, atol 1e-6; the live observation statistics
  rtol 1e-5, the episode trackers and the env state rtol 1e-4, atol 1e-5.
This is also the CartPole window gradient against JAX.
The clip is min(1, grad_norm / (norm + 1e-12)), not clip_grad_norm_'s
epsilon 1e-6; the optimizers are the reference's names.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffrl_tpu.algorithms.bptt import BPTT as JBPTT

from diffrl_tpu_torch.algorithms import BPTT
from diffrl_tpu_torch.algorithms.bptt import make_optimizer
from diffrl_tpu_torch.algorithms.shac import clip_and_step
from diffrl_tpu_torch.optim import LBFGS
from diffrl_tpu_torch.optim import lbfgs as lbfgs_consts
from diffrl_tpu_torch.envs.base import EnvState as TState
from diffrl_tpu_torch.utils.convert import (load_adam_state, load_params,
                                            param_pairs)

HERE = os.path.dirname(__file__)
E, STEPS = 4, 8


def _cfg(logdir, **config):
    with open(os.path.join(HERE, "..", "examples", "cfg", "bptt",
                           "cartpole_swing_up.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(logdir), "seed": 0}
    cfg["params"]["config"].update(dict(num_actors=E, steps_num=STEPS,
                                        max_epochs=3, obs_rms=True,
                                        save_interval=0), **config)
    cfg["params"]["diff_env"]["sim_backward"] = "lb"
    return cfg


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, **tol):
    np.testing.assert_allclose(torch.as_tensor(a).detach().numpy(),
                               np.asarray(b), **tol)


def test_window_and_adam_step_match_jax(tmp_path):
    jt = JBPTT(_cfg(tmp_path / "jax"))
    params = jt.actor_params
    rs = np.random.RandomState(0)
    nu = jax.tree.map(lambda x: jnp.asarray(rs.uniform(1e-4, 1e-3, x.shape),
                                            jnp.float32), params)
    mu = jax.tree.map(jnp.zeros_like, params)
    st = jt.actor_opt_state
    st = (st[0]._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu),
          st[1]._replace(count=jnp.asarray(3, jnp.int32)))
    key = jax.random.PRNGKey(3)
    jparams, jst, jloss, aux, jgnorm = jax.device_get(jt._actor_update(
        params, st, jt.env_state, jt.obs_rms, jt.episode_trackers, key))
    # Adam's first moment from 0 is (1 - b1) times the clipped gradient
    b1 = _cfg(tmp_path)["params"]["config"]["betas"][0]
    jgrads = jax.tree.map(lambda m: np.asarray(m) / (1.0 - b1), jst[0].mu)
    noise, k = [], key
    for _ in range(STEPS):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (E, 1))))

    tt = BPTT(_cfg(tmp_path / "port"), device="cpu")
    get = jax.device_get
    load_params(tt.actor, get(params))
    load_adam_state(tt.actor_opt, tt.actor, get(mu), get(nu), 3)
    tt.actor_updates = 3
    s = get(jt.env_state)
    tt.env_state = TState(*(_t(x) for x in (s.joint_q, s.joint_qd, s.actions,
                                            s.progress)))
    loss, outs = tt.rollout(noise=_t(np.stack(noise)))
    _close(loss, jloss, rtol=1e-4)
    loss.backward()
    clip = min(1.0, tt.grad_norm / (float(jgnorm) + 1e-12))
    for name, p, want in param_pairs(tt.actor, jgrads):
        scale = max(1.0, float(np.abs(want).max()))
        _close(p.grad * clip, want, rtol=1e-3, atol=1e-4 * scale,
               err_msg=name)
    gnorm = tt.apply_actor_grads()
    _close(gnorm, jgnorm, rtol=1e-3)
    assert float(jgnorm) > tt.grad_norm      # the clip is active
    for name, p, want in param_pairs(tt.actor, jparams):
        _close(p, want, rtol=1e-4, atol=1e-6, err_msg=name)
    for (name, p, m), (_, _, v) in zip(param_pairs(tt.actor, jst[0].mu),
                                       param_pairs(tt.actor, jst[0].nu)):
        state = tt.actor_opt.state[p]
        _close(state["exp_avg"], m, rtol=1e-4, atol=1e-6, err_msg=name)
        _close(state["exp_avg_sq"], v, rtol=1e-4, atol=1e-6, err_msg=name)
    for k in ("mean", "var", "count"):
        _close(getattr(tt.obs_rms, k), getattr(aux["obs_rms"], k),
               rtol=1e-5, atol=1e-6)
    for k, v in aux["trackers"].items():
        _close(tt.episode_trackers[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    _close(tt.env_state.joint_q, aux["env_state"].joint_q, rtol=1e-4,
           atol=1e-5)
    _close(outs["done"], aux["outs"]["done"], rtol=0, atol=0)


def test_clip_formula_is_the_reference_s():
    """min(1, grad_norm / (norm + 1e-12)) after nan_to_num: at a norm of
    2e-6 against grad_norm 1e-6 it halves the gradient, where
    clip_grad_norm_'s 1e-6 would scale it by a third."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([p], lr=1.0)
    p.grad = torch.tensor([2e-6, float("nan")])
    before, after = clip_and_step(opt, [p], 1.0, 1e-6)
    _close(before, 2e-6, rtol=1e-6)
    _close(after, 1e-6 * 2e-6 / (2e-6 + 1e-12), rtol=1e-6)
    _close(p, [-1e-6 * 2e-6 / (2e-6 + 1e-12), 0.0], rtol=1e-6)
    q = torch.nn.Parameter(torch.zeros(1))
    q.grad = torch.tensor([2e-6])
    torch.nn.utils.clip_grad_norm_([q], 1e-6)
    _close(q.grad, [2e-6 / 3], rtol=1e-3)


def test_optimizers_by_name():
    p = torch.nn.Parameter(torch.ones(3))
    assert isinstance(make_optimizer("adam", [p], 0.1, (0.7, 0.95)),
                      torch.optim.Adam)
    assert make_optimizer("bptt", [p], 0.1, (0.7, 0.95)).defaults[
        "betas"] == (0.7, 0.95)
    for name in ("gd", "sgd"):
        opt = make_optimizer(name, [p], 0.5, (0.7, 0.95))
        p.grad = torch.tensor([1.0, -2.0, 0.0])
        opt.step()
    _close(p, [0.0, 3.0, 1.0], rtol=0, atol=0)
    lbfgs = make_optimizer("lbfgs", [p], 0.1, (0.7, 0.95))
    assert isinstance(lbfgs, LBFGS)
    assert (lbfgs_consts.MEMORY_SIZE, lbfgs_consts.MAX_LINESEARCH_STEPS) == (
        10, 8)
    assert lbfgs.diff_params.shape == (10, 3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("rmsprop", [p], 0.1, (0.7, 0.95))


def test_port_epoch_on_cartpole_and_checkpoint(tmp_path):
    """train() for one epoch of 4 steps with 2-step episodes (the meters
    fill), the checkpoint loaded into a fresh trainer, and an evaluation."""
    cfg = _cfg(tmp_path / "a", steps_num=4, max_epochs=1)
    cfg["params"]["diff_env"]["episode_length"] = 2
    tt = BPTT(cfg, device="cpu")
    before = [p.detach().clone() for p in tt.actor.parameters()]
    tt.train()
    assert np.isfinite(tt.actor_loss)
    assert not all(torch.equal(a, b) for a, b in zip(
        before, tt.actor.parameters()))
    assert tt.iter_count == 1 and set(tt.episode_length_his) == {2.0}
    other = BPTT(_cfg(tmp_path / "b"), device="cpu")
    other.load(str(tmp_path / "a" / "final_policy.pt"))
    for a, b in zip(tt.actor.parameters(), other.actor.parameters()):
        assert torch.equal(a, b)
    mean_loss, _, mean_len = tt.evaluate_policy(num_games=E)
    assert np.isfinite(mean_loss) and mean_len == 2.0

"""The port's PPO (diffrl_tpu_torch.algorithms.ppo, with models.mlp's
ActorCriticPPO, its fused Adam and utils.convert) against the JAX
package's PPO, on the CPU.

Both trainers run on the linear-quadratic toy env of tests/_torch_toy_env.py
(8 envs, 6 steps per epoch, 2 minibatches of 24, 2 mini-epochs, an entropy
bonus), so that JAX compiles no physics. JAX trains one epoch from its own
initialization; its parameters, Adam state, learning rate, statistics and
env state then go into the port, and both train a second epoch on JAX's
draws (its action noise and permutations, rebuilt from its key stream on
the host). Tolerances: the epoch's statistics, parameters, Adam moments and
running statistics at rtol 1e-4, atol 1e-5 (48 float32 rollout steps, 4
Adam steps, sums reassociated); the learning rate and Adam's count exactly.
GAE and the loss terms are JAX's own closures, held at rtol 1e-5, atol
1e-6. The network's conversion: mu, sigma, value, log_prob and entropy at
rtol/atol 1e-6.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffrl_tpu.algorithms.ppo import PPO as JPPO
from diffrl_tpu.models import ActorCriticPPO as JActorCriticPPO

from diffrl_tpu_torch.algorithms import PPO
from diffrl_tpu_torch.algorithms.ppo import adapt_lr, gae, normalize_advantages
from diffrl_tpu_torch.models import ActorCriticPPO
from diffrl_tpu_torch.utils.convert import (load_adam_state, load_params,
                                            param_pairs)

sys.path.insert(0, os.path.dirname(__file__))
from _torch_toy_env import ToyEnv  # noqa: E402

HERE = os.path.dirname(__file__)
E, H = 8, 6
NET = {"mlp": {"units": [16, 8], "activation": "elu"},
       "space": {"continuous": {"sigma_init": {"val": 0.0}}}}


def _cfg(logdir, name="ant.yaml", **config):
    with open(os.path.join(HERE, "..", "examples", "cfg", "ppo", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(logdir), "seed": 0}
    cfg["params"]["config"].update(config)
    return cfg


def _toy_cfg(logdir):
    cfg = _cfg(logdir, num_actors=E, steps_num=H, minibatch_size=24,
               mini_epochs=2, entropy_coef=0.01, max_epochs=2)
    cfg["params"]["network"].update(NET)
    return cfg


def closure(jitted, name):
    """The function ``name`` that a jitted JAX function closes over."""
    f = jitted.__wrapped__
    cells = dict(zip(f.__code__.co_freevars, f.__closure__))
    return cells[name].cell_contents


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, **tol):
    np.testing.assert_allclose(torch.as_tensor(a).detach().numpy(),
                               np.asarray(b), **tol)


@pytest.fixture(scope="module")
def jppo(tmp_path_factory):
    return JPPO(_toy_cfg(tmp_path_factory.mktemp("jppo")),
                env=ToyEnv("jax", E))


def test_gae_and_advantage_normalisation_match_jax(jppo):
    rs = np.random.RandomState(0)
    rew, val = (rs.normal(size=(H, E)).astype(np.float32) for _ in range(2))
    done = (rs.uniform(size=(H, E)) < 0.3).astype(np.float32)
    last = rs.normal(size=(E,)).astype(np.float32)
    want = closure(jppo._train_epoch, "gae")(rew, done, val, last)
    got = gae(*map(torch.as_tensor, (rew, done, val, last)), jppo.gamma,
              jppo.tau)
    _close(got, want, rtol=1e-5, atol=1e-6)
    adv = np.array(want).reshape(-1)
    _close(normalize_advantages(torch.as_tensor(adv)),
           (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8), rtol=1e-5,
           atol=1e-6)
    # the population std, not torch.std's default ddof 1
    assert not np.allclose(
        normalize_advantages(torch.as_tensor(adv)).numpy(),
        (adv - adv.mean()) / (np.std(adv, ddof=1) + 1e-8), rtol=1e-5)


def test_kl_adaptive_rule_at_both_thresholds():
    """lr / 1.5 above twice the threshold (at least 1e-6), lr * 1.5 below
    half of it (at most 1e-2), unchanged between."""
    thr = 0.008
    lr = torch.tensor(3e-4)
    for kl, want in ((0.017, 2e-4), (0.016, 3e-4), (0.0041, 3e-4),
                     (0.0039, 4.5e-4)):
        _close(adapt_lr(lr, torch.tensor(kl), thr), want, rtol=1e-6)
    _close(adapt_lr(torch.tensor(1.2e-6), torch.tensor(1.0), thr), 1e-6,
           rtol=1e-6)
    _close(adapt_lr(torch.tensor(8e-3), torch.tensor(0.0), thr), 1e-2,
           rtol=1e-6)


def test_network_conversion_round_trip(jppo):
    rs = np.random.RandomState(2)
    net = ActorCriticPPO(3, 2, NET, device="cpu")
    load_params(net, jax.device_get(jppo.net_params))
    for name, p, src in param_pairs(net, jax.device_get(jppo.net_params)):
        _close(p, src, rtol=0, atol=0)
    obs = rs.normal(size=(5, 3)).astype(np.float32)
    act = rs.normal(size=(5, 2)).astype(np.float32)
    jmu, jsig, jv = jppo.network(jppo.net_params, obs)
    mu, sig, v = net(torch.as_tensor(obs))
    for a, b in ((mu, jmu), (sig, jsig), (v, jv)):
        _close(a, b, rtol=1e-6, atol=1e-6)
    jnet = JActorCriticPPO(3, 2, NET)
    _close(net.log_prob(mu, sig, torch.as_tensor(act)),
           jnet.log_prob(jmu, jsig, act), rtol=1e-6, atol=1e-6)
    _close(net.entropy(sig), jnet.entropy(jsig), rtol=1e-6, atol=1e-6)


def test_minibatch_loss_matches_jax(jppo, tmp_path):
    """The clipped surrogate, clipped value loss, bound loss, entropy and
    KL of one minibatch (mu pushed past the 1.1 bound), and its gradient."""
    rs = np.random.RandomState(3)
    tt = PPO(_toy_cfg(tmp_path), env=ToyEnv("torch", E))
    params = jax.device_get(jppo.net_params)
    load_params(tt.network, params)
    n = 10
    obs = 3.0 * rs.normal(size=(n, 3)).astype(np.float32)
    args = [obs, rs.normal(size=(n, 2)), rs.normal(size=(n,)) - 2.0,
            rs.normal(size=(n,)), rs.normal(size=(n,)), rs.normal(size=(n,)),
            rs.normal(size=(n, 2)), rs.uniform(0.5, 1.5, (n, 2))]
    args = [np.asarray(a, np.float32) for a in args]
    fn = closure(jppo._train_epoch, "minibatch_loss")
    (want, aux), jg = jax.value_and_grad(fn, has_aux=True)(
        jppo.net_params, 0.0, *args)
    loss, a_l, c_l, ent, kl = tt.minibatch_loss(*map(torch.as_tensor, args))
    for a, b in zip((loss, a_l, c_l, ent, kl), (want,) + tuple(aux)):
        _close(a, b, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(loss, list(tt.network.parameters()))
    got = dict(zip([id(p) for p in tt.network.parameters()], grads))
    for name, p, g in param_pairs(tt.network, jax.device_get(jg)):
        _close(got[id(p)], g, rtol=1e-4, atol=1e-6)


def _jax_draws(key, mini_epochs):
    """The action noise [H, E, A] and the permutations of JAX's epoch with
    ``key`` (its splits in play_steps, then the permutation keys)."""
    noise = []
    for _ in range(H):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (E, 2))))
    key, k_perm = jax.random.split(key)
    perms = [_t(jax.random.permutation(k, H * E))
             for k in jax.random.split(k_perm, mini_epochs)]
    return _t(np.stack(noise)), perms


def test_whole_epoch_matches_jax(jppo, tmp_path):
    jp = jppo
    state = (jp.net_params, jp.opt_state, jp.cur_lr, jp.env_state,
             jp.obs_rms, jp.val_rms, jp.episode_trackers)
    params, opt, lr, aux = jp._train_epoch(*state, jax.random.PRNGKey(5))
    env_state, obs_rms, val_rms, trk = (
        aux[k] for k in ("env_state", "obs_rms", "val_rms", "trackers"))
    key = jax.random.PRNGKey(6)
    j2 = jp._train_epoch(params, opt, lr, env_state, obs_rms, val_rms, trk,
                         key)

    tt = PPO(_toy_cfg(tmp_path), env=ToyEnv("torch", E))
    get = jax.device_get
    load_params(tt.network, get(params))
    adam = get(opt[0])
    load_adam_state(tt.opt, tt.network, adam.mu, adam.nu, adam.count)
    tt.cur_lr = _t(lr)
    tt.env_state = {k: _t(v) for k, v in get(env_state).items()}
    tt.episode_trackers = {k: _t(v) for k, v in get(trk).items()}
    for mine, theirs in ((tt.obs_rms, obs_rms), (tt.val_rms, val_rms)):
        for k in ("mean", "var", "count"):
            getattr(mine, k).copy_(_t(getattr(get(theirs), k)))
    noise, perms = _jax_draws(key, tt.mini_epochs)
    stats = tt.train_epoch(noise=noise, perms=perms)

    jparams, jopt, jlr, aux = get(j2)
    for k in ("loss", "a_loss", "c_loss", "kl"):
        _close(stats[k], aux[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("done", "ep_rew_done", "ep_len_done"):
        _close(stats[k].to(torch.float32), np.asarray(aux[k], np.float32),
               rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(stats["cur_lr"]) == float(jlr)
    for name, p, want in param_pairs(tt.network, jparams):
        _close(p, want, rtol=1e-4, atol=1e-5, err_msg=name)
    for moment, tree in (("exp_avg", jopt[0].mu), ("exp_avg_sq", jopt[0].nu)):
        for name, p, want in param_pairs(tt.network, tree):
            _close(tt.opt.state[p][moment], want, rtol=1e-4, atol=1e-7,
                   err_msg=name)
    for p in tt.network.parameters():
        assert int(tt.opt.state[p]["step"]) == int(jopt[0].count)
    for mine, theirs in ((tt.obs_rms, aux["obs_rms"]),
                         (tt.val_rms, aux["val_rms"])):
        for k in ("mean", "var", "count"):
            _close(getattr(mine, k), getattr(theirs, k), rtol=1e-4,
                   atol=1e-5)
    _close(tt.env_state["x"], aux["env_state"]["x"], rtol=1e-4, atol=1e-5)


def test_port_epoch_on_cartpole(tmp_path):
    """One PPO epoch of the port alone on the real CartPole (4 envs, 4
    steps): finite statistics, a changed network, checkpoints written."""
    cfg = _cfg(tmp_path, "cartpole_swing_up.yaml", num_actors=4,
               steps_num=4, minibatch_size=8, mini_epochs=1, max_epochs=1)
    tt = PPO(cfg, device="cpu")
    before = [p.detach().clone() for p in tt.network.parameters()]
    tt.train()
    assert all(np.isfinite(v) for k in ("loss", "kl", "lr")
               for _, _, v in tt.scalars[k])
    assert not all(torch.equal(a, b) for a, b in zip(
        before, tt.network.parameters()))
    assert os.path.exists(os.path.join(tmp_path, "final_policy.pt"))
    tt.load(os.path.join(tmp_path, "final_policy.pt"))

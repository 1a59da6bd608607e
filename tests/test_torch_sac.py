"""The port's SAC (diffrl_tpu_torch.algorithms.sac and .replay, with
models.mlp's DoubleCriticMLP and SACActor and utils.convert) against the
JAX package's SAC and replay buffer, on the CPU.

- replay: ``add`` wrapping the ring, ``sample_prioritized``'s indices,
  probabilities and importance weights on the uniform draws of JAX's key,
  ``update_priorities``: exactly, weights at rtol 1e-6;
- the networks' conversion: twin Q values, the actor's distribution, its
  sample on JAX's noise and its mean action at rtol/atol 1e-6 (log_prob
  1e-5);
- whole epochs on the linear-quadratic toy env of tests/_torch_toy_env.py
  (8 envs, 4 steps per epoch, batches of 16 from a ring of 64), given to
  JAX's SAC through a monkeypatch of diffrl_tpu.envs.make: one seed epoch
  of uniform actions, then one learning epoch, both trainers from JAX's
  initial parameters and on JAX's draws (actions, batch indices, the
  update's noise), rebuilt from its key stream on the host, and with the
  three Adam states set alike to moments from a seed before the learning
  epoch (Adam's first steps, about lr sign(g), would let rounding of a
  gradient near 0 flip a step). Compared after the epochs: the buffer (the
  done flags exactly, the rest at rtol 1e-5 and atol 1e-6: the toy env's
  float32 products round differently in the two packages); the critic
  loss and alpha of each step, the three networks and the actor's Adam
  moments at rtol 1e-4 and atol 1e-5 (4 updates of reassociated float32
  sums), log alpha at atol 5e-5, the observation statistics at rtol 1e-5.
  The log-probability's squash term log(1 - tanh(u)^2) moves by ~0.1 per
  float32 unit of an action with 1 - a^2 near 1e-6 (one sample of this
  epoch sits at 1.3e-6): the actor loss, whose mean it moves by 6e-3, is
  held at atol 1e-2, and the Adam moments of what it feeds at rtol 1e-3
  and atol 1e-4 (the critic's, through the target's next log-probability:
  2.5e-5 seen) and rtol 5e-2 (the temperature's: 1.8 % seen);
- one short port epoch on the real CartPole, no JAX.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

import diffrl_tpu.envs as jenvs
from diffrl_tpu.algorithms import replay as jreplay
from diffrl_tpu.algorithms.sac import SAC as JSAC
from diffrl_tpu.models import DoubleCriticMLP as JDouble, SACActor as JActor

from diffrl_tpu_torch.algorithms import SAC, replay
from diffrl_tpu_torch.models import DoubleCriticMLP, SACActor
from diffrl_tpu_torch.utils.convert import (load_adam_state, load_params,
                                            param_pairs)

sys.path.insert(0, os.path.dirname(__file__))
from _torch_toy_env import ToyEnv  # noqa: E402

HERE = os.path.dirname(__file__)
E, H, B = 8, 4, 16
NET = {"mlp": {"units": [16, 16], "activation": "relu"},
       "critic_mlp": {"units": [16, 16], "activation": "relu"},
       "log_std_bounds": [-5, 2]}


def _cfg(logdir, name="ant.yaml", **config):
    with open(os.path.join(HERE, "..", "examples", "cfg", "sac", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(logdir), "seed": 0}
    cfg["params"]["config"].update(config)
    return cfg


def _toy_cfg(logdir):
    cfg = _cfg(logdir, num_actors=E, num_steps_per_episode=H, batch_size=B,
               replay_buffer_size=64, num_seed_steps=1, max_epochs=2)
    cfg["params"]["network"].update(NET)
    return cfg


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, **tol):
    np.testing.assert_allclose(torch.as_tensor(a).detach().numpy(),
                               np.asarray(b), **tol)


def _filled(rs, n_add, cap=12, E=4, prioritized=True):
    """JAX's buffer and the port's after the same ``n_add`` batches."""
    jb = jreplay.make_buffer(cap, 3, 2, prioritized=prioritized)
    tb = replay.make_buffer(cap, 3, 2, prioritized=prioritized,
                            device="cpu")
    for _ in range(n_add):
        batch = [rs.normal(size=s).astype(np.float32)
                 for s in ((E, 3), (E, 2), (E,), (E, 3), (E,))]
        jb = jreplay.add(jb, *batch)
        replay.add(tb, *map(torch.as_tensor, batch))
    return jb, tb


def test_replay_add_wraps_like_jax():
    jb, tb = _filled(np.random.RandomState(0), 4)
    for k in ("obs", "actions", "rews", "next_obs", "dones", "prio"):
        _close(tb[k], jb[k], rtol=0, atol=0)
    assert (tb["idx"], tb["count"]) == (int(jb["idx"]), int(jb["count"]))
    assert tb["idx"] == 4 and tb["count"] == 12


def test_prioritized_sampling_and_priorities_match_jax():
    """Half-filled ring with random priorities: JAX's indices and weights
    on the key's uniform draws, then its priority update (unique rows)."""
    rs = np.random.RandomState(1)
    jb, tb = _filled(rs, 2, cap=16)
    prio = rs.uniform(0.1, 2.0, 16).astype(np.float32)
    jb = dict(jb, prio=jnp.asarray(prio))
    tb["prio"] = torch.as_tensor(prio)
    key = jax.random.PRNGKey(3)
    jidx, jbatch, jw = jreplay.sample_prioritized(jb, key, 6, 0.6, 0.4)
    tidx, tbatch, tw = replay.sample_prioritized(
        tb, 6, 0.6, 0.4, u=_t(jax.random.uniform(key, (6,))))
    _close(tidx, jidx, rtol=0, atol=0)
    assert int(tidx.max()) < 8
    _close(tw, jw, rtol=1e-6)
    for a, b in zip(tbatch, jbatch):
        _close(a, b, rtol=0, atol=0)
    p = prio[:8] ** 0.6
    _close(tw, (8 * p[tidx.numpy()] / p.sum()) ** -0.4
           / ((8 * p[tidx.numpy()] / p.sum()) ** -0.4).max(), rtol=1e-5)
    rows = np.array([1, 5, 2])
    td = np.array([0.5, -3.0, 0.25], np.float32)
    jb = jreplay.update_priorities(jb, jnp.asarray(rows), td)
    replay.update_priorities(tb, torch.as_tensor(rows), torch.as_tensor(td))
    _close(tb["prio"], jb["prio"], rtol=0, atol=0)
    _close(tb["max_prio"], jb["max_prio"], rtol=0, atol=0)
    tidx, *_ = replay.sample_uniform(tb, 5, idx=torch.tensor([0, 7, 7, 3,
                                                              1]))
    assert tidx.tolist() == [0, 7, 7, 3, 1]


def test_network_conversion_round_trip():
    rs = np.random.RandomState(2)
    jc, ja = JDouble(3, 2, NET), JActor(3, 2, NET)
    cp, ap = jc.init(jax.random.PRNGKey(0)), ja.init(jax.random.PRNGKey(1))
    tc, ta = DoubleCriticMLP(3, 2, NET, device="cpu"), SACActor(
        3, 2, NET, device="cpu")
    load_params(tc, jax.device_get(cp))
    load_params(ta, jax.device_get(ap))
    obs = rs.normal(size=(5, 3)).astype(np.float32)
    act = rs.uniform(-1, 1, (5, 2)).astype(np.float32)
    for a, b in zip(tc(torch.as_tensor(obs), torch.as_tensor(act)),
                    jc(cp, obs, act)):
        _close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(ta.dist(torch.as_tensor(obs)), ja.dist(ap, obs)):
        _close(a, b, rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(4)
    ja_act, ja_logp = ja.sample(ap, obs, key)
    t_act, t_logp = ta.sample(torch.as_tensor(obs),
                              _t(jax.random.normal(key, (5, 2))))
    _close(t_act, ja_act, rtol=1e-6, atol=1e-6)
    _close(t_logp, ja_logp, rtol=1e-5, atol=1e-5)
    _close(ta.mean_action(torch.as_tensor(obs)), ja.mean_action(ap, obs),
           rtol=1e-6, atol=1e-6)


def _jax_draws(key, seed_phase, count, cap=64):
    """JAX's per-step draws of an epoch with ``key``: its four-way split
    per step (actions, batch, update), the update's three-way split; the
    ring's fill ``count`` before the epoch gives the batch's range."""
    draws = []
    for _ in range(H):
        key, k_act, k_batch, k_upd = jax.random.split(key, 4)
        count = min(count + E, cap)
        if seed_phase:
            draws.append({"actions": _t(jax.random.uniform(
                k_act, (E, 2), minval=-1.0, maxval=1.0))})
            continue
        _, k1, k2 = jax.random.split(k_upd, 3)
        draws.append({"actions": _t(jax.random.normal(k_act, (E, 2))),
                      "idx": _t(jax.random.randint(k_batch, (B,), 0, count)),
                      "eps_next": _t(jax.random.normal(k1, (B, 2))),
                      "eps_pi": _t(jax.random.normal(k2, (B, 2)))})
    return draws, count


def _warm_adam(learner, tt):
    """The JAX learner with its three Adam states set to moments from a
    seed at count 10, given to the port's optimizers too (utils.convert):
    Adam's first steps move each parameter by about lr sign(g), which
    float32 rounding of a gradient near 0 can flip; later steps are smooth
    in g."""
    rs = np.random.RandomState(9)
    learner = list(learner)
    for i, (opt, mod) in zip((4, 5, 6), ((tt.actor_opt, tt.actor),
                                         (tt.critic_opt, tt.critic),
                                         (tt.alpha_opt, tt.log_alpha))):
        st = learner[i][0]
        mu = jax.tree.map(lambda x: jnp.asarray(
            rs.normal(0.0, 1e-2, x.shape), jnp.float32), st.mu)
        nu = jax.tree.map(lambda x: jnp.asarray(
            rs.uniform(1e-2, 2e-2, x.shape), jnp.float32), st.nu)
        count = jnp.asarray(10, jnp.int32)
        learner[i] = (st._replace(count=count, mu=mu, nu=nu),
                      *learner[i][1:])
        load_adam_state(opt, mod, jax.device_get(mu), jax.device_get(nu), 10)
    return tuple(learner)


def test_whole_epochs_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jenvs, "make",
                        lambda name, **kw: ToyEnv("jax", kw["num_envs"]))
    js = JSAC(_toy_cfg(tmp_path / "jax"))
    tt = SAC(_toy_cfg(tmp_path / "port"), env=ToyEnv("torch", E))
    get = jax.device_get
    for mod, params in ((tt.actor, js.actor_params),
                        (tt.critic, js.critic_params),
                        (tt.target_critic, js.target_critic_params),
                        (tt.log_alpha, js.log_alpha)):
        load_params(mod, get(params))

    carry = [js._learner_tuple(), js.env_state, js.buffer,
             js.episode_trackers]
    count = 0
    for seed_phase, k in ((True, 7), (False, 8)):
        if not seed_phase:
            carry[0] = _warm_adam(carry[0], tt)
        key = jax.random.PRNGKey(k)
        fn = js._train_epoch_seed if seed_phase else js._train_epoch
        (*carry, _), jouts = fn(*carry, key)
        draws, count = _jax_draws(key, seed_phase, count)
        touts = tt.train_epoch(seed_phase=seed_phase, draws=draws)
    learner, _, jbuf, _ = get(carry)
    jouts = get(jouts)

    _close(tt.buffer["dones"], jbuf["dones"], rtol=0, atol=0)
    for k in ("obs", "actions", "rews", "next_obs"):
        _close(tt.buffer[k], jbuf[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert (tt.buffer["idx"], tt.buffer["count"]) == (
        int(jbuf["idx"]), int(jbuf["count"])) == (0, 64)
    losses = touts["losses"].numpy()
    _close(losses[:, 0], jouts["c_loss"], rtol=1e-4, atol=1e-5)
    _close(losses[:, 2], jouts["alpha"], rtol=1e-4, atol=1e-5)
    # log(1 - tanh(u)^2) moves by ~0.1 per float32 unit of the action where
    # 1 - a^2 is near 1e-6 (one sample of step 2 at 1.3e-6: 6e-3 in the
    # mean): what depends on logp's value is held looser
    _close(losses[:, 1], jouts["a_loss"], rtol=1e-4, atol=1e-2)
    _close(touts["done"], jouts["done"], rtol=0, atol=0)
    (actor, critic, target, log_alpha, a_opt, c_opt, al_opt,
     obs_rms) = learner
    for mod, params in ((tt.actor, actor), (tt.critic, critic),
                        (tt.target_critic, target)):
        for name, p, want in param_pairs(mod, params):
            _close(p, want, rtol=1e-4, atol=1e-5, err_msg=name)
    _close(tt.log_alpha, log_alpha, rtol=1e-4, atol=5e-5)
    for opt, mod, st, tol in (
            (tt.actor_opt, tt.actor, a_opt, dict(rtol=1e-4, atol=1e-5)),
            (tt.critic_opt, tt.critic, c_opt, dict(rtol=1e-3, atol=1e-4)),
            (tt.alpha_opt, tt.log_alpha, al_opt, dict(rtol=5e-2, atol=0))):
        for (name, p, m), (_, _, v) in zip(param_pairs(mod, st[0].mu),
                                           param_pairs(mod, st[0].nu)):
            s = opt.state[p]
            _close(s["exp_avg"], m, err_msg=name, **tol)
            _close(s["exp_avg_sq"], v, err_msg=name, **tol)
            assert int(s["step"]) == int(st[0].count) == 10 + H
    for k in ("mean", "var", "count"):
        _close(getattr(tt.obs_rms, k), getattr(obs_rms, k), rtol=1e-5,
               atol=1e-6)

    # the conversion of an Adam state: a fresh port trainer given JAX's
    fresh = SAC(_toy_cfg(tmp_path / "fresh"), env=ToyEnv("torch", E))
    load_adam_state(fresh.critic_opt, fresh.critic, c_opt[0].mu,
                    c_opt[0].nu, c_opt[0].count)
    for name, p, want in param_pairs(fresh.critic, c_opt[0].mu):
        _close(fresh.critic_opt.state[p]["exp_avg"], want, rtol=0, atol=0,
               err_msg=name)


def test_port_epochs_on_cartpole(tmp_path):
    """A seed epoch and a learning epoch of the port alone on the real
    CartPole (4 envs, 2 steps): finite losses and alpha, a changed actor,
    the ring filled with 16 transitions."""
    cfg = _cfg(tmp_path, "cartpole_swing_up.yaml", num_actors=4,
               num_steps_per_episode=2, batch_size=8, num_seed_steps=1,
               max_epochs=2, replay_buffer_size=64)
    tt = SAC(cfg, device="cpu")
    before = [p.detach().clone() for p in tt.actor.parameters()]
    tt.train()
    assert all(np.isfinite(v) for k in ("c_loss", "a_loss", "alpha")
               for _, _, v in tt.scalars[k])
    assert not all(torch.equal(a, b) for a, b in zip(
        before, tt.actor.parameters()))
    assert tt.buffer["count"] == 16
    assert os.path.exists(os.path.join(tmp_path, "final_policy.pt"))

"""The port's PPO on config-built networks (diffrl_tpu_torch.algorithms.ppo,
the A2CNetwork path) against the JAX package's, on the CPU.

Both trainers are built on the contextual bandit of tests/test_builders.py
(the JAX one on its _ToyDiscreteEnv, the port on chip_smoke.ToyBandit, its
torch counterpart) with that test's configs: a discrete head on an MLP, a
conv trunk on the 6 x 6 image, and an MLP with an LSTM after it. The JAX
parameters go into the port's network; one minibatch drawn from a numpy
seed goes through JAX's own minibatch_loss (a closure of its jitted epoch)
and the port's builder_loss: the loss and its terms at rtol 1e-5, atol
1e-6, the gradient w.r.t. every parameter at rtol 1e-4, atol 1e-6 in
units of each tensor's largest entry. With the LSTM, the whole update
path too: from one recorded rollout, GAE, advantage normalization and
JAX's chunking of [H, E] into seq_length chunks (its reshapes, applied
here with jnp) give JAX's loss for the port's first minibatch.
Then tests/test_builders.py's three train() smokes at their thresholds,
and an LSTM policy on the real CartPole for one epoch, saved and loaded.
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

from diffrl_tpu_torch.algorithms import PPO
from diffrl_tpu_torch.utils.convert import load_params, param_pairs

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, ".."))
import chip_smoke  # noqa: E402
from test_builders import _ToyDiscreteEnv  # noqa: E402

torch.set_num_threads(1)  # the suite's pytest workers share a few cores

NETS = {
    "discrete": ({"mlp": {"units": [32]}, "space": {"discrete": {}}},
                 False, {}),
    "cnn": ({"cnn": {"convs": [{"filters": 4, "kernel_size": 3,
                                "strides": 2}], "activation": "relu"},
             "mlp": {"units": [16]}, "space": {"discrete": {}}}, True, {}),
    "lstm": ({"mlp": {"units": [16]}, "rnn": {"name": "lstm", "units": 8},
              "space": {"discrete": {}}}, False, {"seq_length": 4}),
}
E, H = 8, 8


def closure(jitted, name):
    f = jitted.__wrapped__
    return dict(zip(f.__code__.co_freevars, f.__closure__))[name] \
        .cell_contents


def _trainers(kind, tmp_path):
    net, image, extra = NETS[kind]
    jcfg = chip_smoke.toy_ppo_cfg(net, num_envs=E, steps=H, epochs=1,
                                  **extra)
    jcfg["params"]["general"]["logdir"] = str(tmp_path / "jax")
    tcfg = chip_smoke.toy_ppo_cfg(net, num_envs=E, steps=H, epochs=1,
                                  **extra)
    tcfg["params"]["general"]["logdir"] = str(tmp_path / "torch")
    jp = JPPO(jcfg, env=_ToyDiscreteEnv(num_envs=E, image=image))
    tp = PPO(tcfg, env=chip_smoke.ToyBandit(E, image=image, device="cpu"))
    assert jp.use_builder and tp.use_builder
    load_params(tp.network, jax.device_get(jp.net_params))
    return jp, tp


def _batch(jp, n, seq, rs):
    """A minibatch of n rows ([n, seq, ...] chunks with a recorded
    state when the net is recurrent)."""
    net = jp.network
    lead = (n, seq) if seq else (n,)
    obs_shape = getattr(jp.env, "obs_shape", (4,))
    f = np.float32
    b = dict(obs=rs.normal(size=lead + tuple(obs_shape)).astype(f),
             actions=rs.randint(0, 4, size=lead).astype(np.int32),
             logp=(rs.normal(size=lead) - 1.4).astype(f),
             head=rs.normal(size=lead + (4,)).astype(f),
             adv=rs.normal(size=lead).astype(f),
             ret=rs.normal(size=lead).astype(f),
             value=rs.normal(size=lead).astype(f),
             done=(rs.uniform(size=lead) < 0.3).astype(f))
    if seq:
        b["rnn"] = jax.tree.map(
            lambda z: (0.1 * rs.normal(size=z.shape)).astype(f),
            net.initial_rnn_state((n,)))
    return b


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_t(v) for v in tree)
    return torch.as_tensor(np.array(tree))


def _close(a, b, rtol=1e-5, atol=1e-6, name=""):
    np.testing.assert_allclose(torch.as_tensor(a).detach().numpy(),
                               np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("kind", list(NETS))
def test_minibatch_loss_and_gradient_match_jax(kind, tmp_path):
    jp, tp = _trainers(kind, tmp_path)
    rs = np.random.RandomState(0)
    batch = _batch(jp, 12, 4 if kind == "lstm" else 0, rs)
    fn = closure(jp._train_epoch, "minibatch_loss")
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        jp.net_params, batch)
    terms = tp.builder_loss(_to_t(batch))
    for a, b, name in zip(terms, (jloss,) + tuple(jaux),
                          ("loss", "a_loss", "c_loss", "entropy", "kl")):
        _close(a, b, name=name)
    params = list(tp.network.parameters())
    grads = dict(zip(map(id, params), torch.autograd.grad(terms[0], params)))
    for name, p, g in param_pairs(tp.network, jax.device_get(jg)):
        g = np.asarray(g)
        _close(grads[id(p)], g, 1e-4, 1e-6 * max(np.abs(g).max(), 1e-30),
               name)


def test_lstm_update_path_matches_jax(tmp_path):
    jp, tp = _trainers("lstm", tmp_path)
    with torch.no_grad():
        outs, last_value = tp.play_steps()
    seq = tp.seq_length
    assert outs["rnn"][0][0].shape == (H, E, 8)
    # JAX's GAE, normalization and chunking of the same records
    o = jax.tree.map(lambda t: np.asarray(t), outs)
    advs = closure(jp._train_epoch, "gae")(o["rew"], o["done"], o["value"],
                                           np.asarray(last_value))
    returns = advs + o["value"]
    advs = (advs - advs.mean()) / (advs.std() + 1e-8)
    data = dict(obs=o["obs"], actions=o["actions"], logp=o["logp"],
                head=o["head"], adv=advs, ret=returns, value=o["value"],
                done=o["done"])

    def chunk(x):
        x = jnp.asarray(x).reshape((H // seq, seq, E) + x.shape[2:])
        x = jnp.moveaxis(x, 2, 1)
        return x.reshape((H // seq * E, seq) + x.shape[3:])
    data = jax.tree.map(chunk, data)
    data["rnn"] = jax.tree.map(
        lambda x: jnp.asarray(x).reshape((H // seq, seq, E) + x.shape[2:])
        [:, 0].reshape((H // seq * E,) + x.shape[2:]), o["rnn"])
    B, mb = H // seq * E, tp.minibatch_size // seq
    perm = np.random.RandomState(1).permutation(B)
    first = jax.tree.map(lambda x: x[perm[:mb]], data)
    want, _ = closure(jp._train_epoch, "minibatch_loss")(jp.net_params,
                                                         first)
    stats = tp.update(outs, last_value, perms=[torch.as_tensor(perm)] * 2)
    assert stats.shape == (4, 2 * (B // mb))
    _close(stats[0, 0], want, name="first minibatch loss")


@pytest.mark.parametrize("kind", ["discrete", "cnn", "gru"])
def test_bandit_train_smokes(kind):
    """tests/test_builders.py's smokes at their thresholds (the discrete
    net above 6, the conv net above 4, the GRU above 2: random play earns
    2 per episode)."""
    ppo, rew, _ = chip_smoke.bandit(kind, "cpu")
    assert ppo.use_builder and np.isfinite(rew)


def test_lstm_policy_on_cartpole(tmp_path):
    """ppo/cartpole_swing_up.yaml with an LSTM after its MLP (a continuous
    head on the builder path): one epoch, finite statistics, a changed
    network, the checkpoint written and loaded."""
    with open(os.path.join(HERE, "..", "examples", "cfg", "ppo",
                           "cartpole_swing_up.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(tmp_path), "seed": 0}
    cfg["params"]["network"]["rnn"] = {"name": "lstm", "units": 8}
    cfg["params"]["config"].update(num_actors=4, steps_num=4,
                                   minibatch_size=8, mini_epochs=1,
                                   max_epochs=1, seq_length=2)
    tt = PPO(cfg, device="cpu")
    assert tt.use_builder and tt.network.space == "continuous"
    before = [p.detach().clone() for p in tt.network.parameters()]
    tt.train()
    assert all(np.isfinite(v) for k in ("loss", "kl", "lr")
               for _, _, v in tt.scalars[k])
    assert not all(torch.equal(a, b) for a, b in zip(
        before, tt.network.parameters()))
    path = os.path.join(tmp_path, "final_policy.pt")
    after = [p.detach().clone() for p in tt.network.parameters()]
    with torch.no_grad():
        for p in tt.network.parameters():
            p.zero_()
    tt.load(path)
    assert all(torch.equal(a, b) for a, b in zip(after,
                                                 tt.network.parameters()))
    rew, length = tt.evaluate_policy(1)
    assert np.isfinite(rew) and np.isfinite(length)

"""The port's config-built networks (diffrl_tpu_torch.models.builders:
conv trunks, LSTM/GRU cells, categorical heads, A2CNetwork) against the
JAX package's (diffrl_tpu/models/builders.py), on the CPU, mirroring
tests/test_builders.py's unit tests.

Each network is built in both packages from the same config, the JAX
parameters (from its own init) carried into the port's module
(utils.convert.load_params; conv weights HWIO -> OIHW), inputs drawn from
a numpy seed. Tolerances: values rtol 1e-5, atol 1e-6 (float32, sums
reassociated: XLA's conv and matmuls against torch's); gradients w.r.t.
every parameter (and the input of the conv) rtol 1e-4, atol 1e-6 in units
of each tensor's largest entry. The parameters also come back from the
port unchanged (utils.convert.jax_params), bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffrl_tpu.models import builders as jb

from diffrl_tpu_torch.models import builders as tb
from diffrl_tpu_torch.utils.convert import jax_params, load_params, param_pairs

torch.set_num_threads(1)  # the suite's pytest workers share a few cores

CONVS = [{"filters": 8, "kernel_size": 3, "strides": 2},
         {"filters": 4, "kernel_size": 3, "strides": 1}]


def _close(a, b, rtol=1e-5, atol=1e-6, name=""):
    np.testing.assert_allclose(torch.as_tensor(a).detach().numpy(),
                               np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=name)


def _grad_close(a, b, name):
    b = np.asarray(b)
    _close(a, b, 1e-4, 1e-6 * max(float(np.abs(b).max()), 1e-30), name)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_conv_matches_jax():
    jp = jb.init_conv(jax.random.PRNGKey(0), 2, CONVS)
    layers = tb.init_conv(2, CONVS, device="cpu")
    for conv, layer in zip(layers, jax.device_get(jp)):
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(np.ascontiguousarray(
                np.transpose(np.asarray(layer["w"]), (3, 2, 0, 1)))))
            conv.bias.copy_(torch.as_tensor(np.array(layer["b"])))
    rs = np.random.RandomState(0)
    x = rs.normal(size=(3, 5, 12, 12, 2)).astype(np.float32)
    want = jb.apply_conv(jp, x, CONVS)
    xt = torch.as_tensor(x).requires_grad_()
    got = tb.apply_conv(layers, xt)
    assert got.shape == (3, 5, tb.conv_output_dim((12, 12, 2), CONVS))
    assert tb.conv_output_dim((12, 12, 2), CONVS) == \
        jb.conv_output_dim((12, 12, 2), CONVS)
    _close(got, want, name="conv features")
    w = rs.normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda p, x: jnp.sum(jb.apply_conv(p, x, CONVS) * w),
                  argnums=(0, 1))(jp, x)
    tg = torch.autograd.grad((got * torch.as_tensor(w)).sum(),
                             [xt] + list(layers.parameters()))
    _grad_close(tg[0], jg[1], "d input")
    want_p = [g for layer in jax.device_get(jg[0])
              for g in (np.transpose(layer["w"], (3, 2, 0, 1)), layer["b"])]
    for i, (a, b) in enumerate(zip(tg[1:], want_p)):
        _grad_close(a, b, f"conv parameter {i}")


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_rnn_step_matches_jax(kind):
    jinit, jstep = ((jb.init_lstm, jb.lstm_step) if kind == "lstm"
                    else (jb.init_gru, jb.gru_step))
    tinit, tstep = ((tb.init_lstm, tb.lstm_step) if kind == "lstm"
                    else (tb.init_gru, tb.gru_step))
    jp = jinit(jax.random.PRNGKey(0), 6, 8, layers=2)
    layers = tinit(6, 8, 2, device="cpu")
    with torch.no_grad():
        for cell, layer in zip(layers, jax.device_get(jp)):
            for k in ("wi", "wh", "b"):
                getattr(cell, k).copy_(torch.as_tensor(np.array(layer[k])))
    rs = np.random.RandomState(1)
    x = rs.normal(size=(4, 6)).astype(np.float32)
    n = 2 if kind == "lstm" else 1
    # a nonzero state: wh's gradient is zero at h = 0
    state = [tuple(0.1 * rs.normal(size=(4, 8)).astype(np.float32)
                   for _ in range(n)) for _ in range(2)]
    jy, jstate = jstep(jp, x, state)
    ty, tstate = tstep(layers, torch.as_tensor(x),
                       [tuple(map(torch.as_tensor, s)) for s in state])
    _close(ty, jy, name="output")
    for a, b in zip(tstate, jstate):
        for u, v in zip(a, b):
            _close(u, v, name="state")
    assert float(tstate[0][0].detach().abs().max()) > 0
    jg = jax.grad(lambda p: jnp.sum(jstep(p, x, state)[0] ** 2))(jp)
    tg = torch.autograd.grad((ty ** 2).sum(), list(layers.parameters()))
    want = [layer[k] for layer in jax.device_get(jg)
            for k in ("wi", "wh", "b")]
    for i, (a, b) in enumerate(zip(tg, want)):
        assert float(a.abs().max()) > 0
        _grad_close(a, b, f"{kind} parameter {i}")


def test_categorical_primitives_match_jax():
    logits = np.asarray([[2.0, 0.0, -1.0], [0.0, 0.0, 0.0]], np.float32)
    a = np.asarray([0, 2])
    tl, ta = torch.as_tensor(logits), torch.as_tensor(a)
    _close(tb.categorical_log_prob(tl, ta),
           jb.categorical_log_prob(logits, a), name="log_prob")
    _close(tb.categorical_entropy(tl), jb.categorical_entropy(logits),
           name="entropy")
    np.testing.assert_allclose(tb.categorical_entropy(tl)[1], np.log(3.0),
                               rtol=1e-6)
    shift = logits + np.asarray([1.0, 0.0, 0.0], np.float32)
    _close(tb.categorical_kl(tl, torch.as_tensor(shift)),
           jb.categorical_kl(logits, shift), name="kl")
    _close(tb.categorical_kl(tl, tl), 0.0, atol=1e-6)
    # the Gumbel-max draws follow softmax(logits)
    gen = torch.Generator().manual_seed(0)
    draws = tb.categorical_sample(tl.expand(20000, 2, 3), gen)
    freq = torch.stack([(draws[:, 0] == k).float().mean() for k in range(3)])
    _close(freq, np.asarray(jax.nn.softmax(logits[0])), atol=0.01)


def _nets(cfg, obs_shape, action_dim, action_dims=None, seed=0):
    jnet = jb.A2CNetwork(obs_shape, action_dim, cfg, action_dims=action_dims)
    jp = jax.device_get(jnet.init(jax.random.PRNGKey(seed)))
    tnet = tb.A2CNetwork(obs_shape, action_dim, cfg, action_dims=action_dims,
                         device="cpu")
    load_params(tnet, jp)
    _same_tree(jax_params(tnet, jp), jp)
    return jnet, jp, tnet


def _to_t(tree):
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_t(x) for x in tree)
    return torch.as_tensor(np.array(tree))


def _check_net(jnet, jp, tnet, obs, state=None):
    """Forward, log_prob, entropy, KL and the gradient of a loss through
    all of them, the port against JAX."""
    jhead, jval, jstate = jax.jit(jnet.apply)(jp, obs, state)
    thead, tval, tstate = tnet(torch.as_tensor(obs), _to_t(state))
    jflat, tflat = jax.tree.leaves(jhead), jax.tree.leaves(
        thead, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for a, b in zip(tflat, jflat):
        _close(a, b, name="head")
    _close(tval, jval, name="value")
    for a, b in zip(jax.tree.leaves(tstate or []), jax.tree.leaves(
            jstate or [])):
        _close(a, b, name="rnn state")
    actions = np.array(jnet.sample(jax.random.PRNGKey(3), jhead))
    ta = torch.as_tensor(actions)
    _close(tnet.log_prob(thead, ta), jnet.log_prob(jhead, actions),
           name="log_prob")
    _close(tnet.entropy(thead), jnet.entropy(jhead), name="entropy")
    # the old head: this one moved a little
    old = jax.tree.map(lambda x: x + 0.05, jhead)
    _close(tnet.kl(_to_t(old), thead), jnet.kl(old, jhead), atol=1e-6,
           name="kl")

    def jloss(p):
        head, value, _ = jnet.apply(p, obs, state)
        return (jnp.sum(jnet.log_prob(head, actions)) + jnp.sum(value ** 2)
                + jnp.sum(jnet.entropy(head)) + jnet.kl(old, head))

    jg = jax.device_get(jax.jit(jax.grad(jloss))(jp))
    tloss = (tnet.log_prob(thead, ta).sum() + (tval ** 2).sum()
             + tnet.entropy(thead).sum() + tnet.kl(_to_t(old), thead))
    params = list(tnet.parameters())
    grads = dict(zip(map(id, params), torch.autograd.grad(tloss, params)))
    pairs = param_pairs(tnet, jg)
    assert len(pairs) == len(params)
    for name, p, g in pairs:
        _grad_close(grads[id(p)], g, name)


@pytest.mark.parametrize("sigma", ["fixed", "head"])
def test_a2c_continuous_matches_jax(sigma):
    cfg = {"mlp": {"units": [16, 8]},
           "space": {"continuous": {"fixed_sigma": sigma == "fixed",
                                    "sigma_init": {"val": -0.5}}}}
    jnet, jp, tnet = _nets(cfg, 7, 3)
    obs = np.random.RandomState(2).normal(size=(4, 7)).astype(np.float32)
    _check_net(jnet, jp, tnet, obs)
    (mu, sigma_t), value, state = tnet(torch.as_tensor(obs))
    assert mu.shape == (4, 3) and sigma_t.shape == (4, 3)
    assert value.shape == (4,) and state is None


def test_a2c_discrete_and_multidiscrete_match_jax():
    jnet, jp, tnet = _nets({"mlp": {"units": [16]},
                            "space": {"discrete": {}}}, 5, 4)
    obs = np.random.RandomState(3).normal(size=(6, 5)).astype(np.float32)
    _check_net(jnet, jp, tnet, obs)
    logits, _, _ = tnet(torch.as_tensor(obs))
    a = tnet.sample(logits, torch.Generator().manual_seed(1))
    assert a.shape == (6,) and a.dtype == torch.int64
    jnet, jp, tnet = _nets({"mlp": {"units": [16]},
                            "space": {"multi_discrete": {}}}, 5, None,
                           action_dims=[3, 2], seed=2)
    _check_net(jnet, jp, tnet, obs)
    heads, _, _ = tnet(torch.as_tensor(obs))
    assert heads[0].shape == (6, 3) and heads[1].shape == (6, 2)
    assert tnet.sample(heads, torch.Generator().manual_seed(1)).shape == \
        (6, 2)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_a2c_cnn_rnn_separate_matches_jax(kind):
    cfg = {"separate": True,
           "cnn": {"convs": [{"filters": 4, "kernel_size": 3, "strides": 2}],
                   "activation": "relu"},
           "mlp": {"units": [16]},
           "rnn": {"name": kind, "units": 8, "layers": 2,
                   "before_mlp": kind == "gru"},
           "space": {"discrete": {}}}
    jnet, jp, tnet = _nets(cfg, (8, 8, 1), 3)
    rs = np.random.RandomState(4)
    obs = rs.normal(size=(2, 8, 8, 1)).astype(np.float32)
    state = jax.tree.map(lambda z: 0.1 * rs.normal(size=z.shape).astype(
        np.float32), jnet.initial_rnn_state((2,)))
    _check_net(jnet, jp, tnet, obs, state)
    # recurrence: the same obs from the evolved state gives other logits
    t0 = tnet.initial_rnn_state((2,))
    assert [tuple(z.shape) for layer in t0 for z in layer] == \
        [(2, 8)] * (2 * len(t0[0]))
    lg1, _, s1 = tnet(torch.as_tensor(obs), t0)
    lg2, _, _ = tnet(torch.as_tensor(obs), s1)
    assert float((lg2 - lg1).detach().abs().max()) > 1e-6


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_rnn_stepwise_equals_jax_scan(kind):
    """Steps one at a time through the port (as PPO's chunked minibatches
    run them) equal JAX's lax.scan over the sequence."""
    cfg = {"mlp": {"units": [8]}, "rnn": {"name": kind, "units": 6},
           "space": {"discrete": {}}}
    jnet, jp, tnet = _nets(cfg, 4, 2)
    obs_seq = np.random.RandomState(5).normal(size=(5, 3, 4)).astype(
        np.float32)

    def scan_step(s, o):
        lg, _, s = jnet.apply(jp, o, s)
        return s, lg

    _, scanned = jax.lax.scan(scan_step, jnet.initial_rnn_state((3,)),
                              obs_seq)
    state, outs = tnet.initial_rnn_state((3,)), []
    for t in range(5):
        lg, _, state = tnet(torch.as_tensor(obs_seq[t]), state)
        outs.append(lg)
    _close(torch.stack(outs), scanned, name="logits over the sequence")

"""The port's L-BFGS (diffrl_tpu_torch.optim.LBFGS) against optax.lbfgs
with scale_by_zoom_linesearch(max_linesearch_steps=8), the JAX BPTT's
``algo: lbfgs`` optimizer, and one BPTT L-BFGS epoch against the JAX
trainer's, on the CPU.

Problems, float32, from fixed starts: Rosenbrock in 2-d from (-1.2, 1)
and from (0, 2) (the latter takes 5-6 probes per search on its way), a
quadratic with condition number 1e4 (the zoom's interpolation), and the
pseudo-Huber sum sqrt(1 + x^2) from far away (the interval search doubles
the step up to 5 times). For 10 updates each, the probes per search are
equal and the iterates agree to 1e-4 of their largest entry (float32 sums
of both packages reassociate; the largest seen was 4.5e-5). The search's
failure path (8 probes, then the safe step) runs on sum sqrt(|x| + 1e-3),
whose kink at 0 the search cannot satisfy the curvature test near: for 5
updates. Further on, the iterates sit within 1e-3 of the kink, where the
float32 rounding of either package decides the search.

BPTT: the linear-quadratic toy env of tests/_torch_toy_env.py (4 envs, 6
steps a window, an episode of 5 steps, so that envs reset inside the
window) with examples/cfg/bptt/cartpole_swing_up.yaml's network made
deterministic, obs_rms on, and ``algo: lbfgs``; each trainer's env is the
toy env (its make is patched). From the JAX actor's weights, two updates:
each probe re-runs the window from the same state. The losses, gradient
norms and parameters after each update at rtol 1e-4, atol 1e-6 in units
of each tensor's largest entry, the probes per search equal, the env
state and observation statistics (those of the first run of the window,
not of a probe) at rtol 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import diffrl_tpu.algorithms.bptt as jbptt_mod

import diffrl_tpu_torch.algorithms.bptt as tbptt_mod
from diffrl_tpu_torch.optim import LBFGS
from diffrl_tpu_torch.utils.convert import load_params, param_pairs

sys.path.insert(0, os.path.dirname(__file__))
from _torch_toy_env import ToyEnv  # noqa: E402

torch.set_num_threads(1)  # the suite's pytest workers share a few cores

HERE = os.path.dirname(__file__)

_RS = np.random.RandomState(0)
_Q, _ = np.linalg.qr(_RS.normal(size=(6, 6)))
_A = (_Q @ np.diag(np.logspace(0, 4, 6)) @ _Q.T).astype(np.float32)
_B = _RS.normal(size=6).astype(np.float32)
_X6 = _RS.normal(size=6).astype(np.float32)


def _rosen(x, m):
    return m.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


PROBLEMS = {
    "rosenbrock": (_rosen, [-1.2, 1.0]),
    "rosenbrock_0_2": (_rosen, [0.0, 2.0]),
    "quadratic_1e4": (lambda x, m: 0.5 * x @ (m.asarray(_A) @ x)
                      - m.asarray(_B) @ x, _X6),
    "pseudo_huber": (lambda x, m: m.sum(m.sqrt(1.0 + x * x)),
                     [8.0, -6.0, 10.0]),
    "kink": (lambda x, m: m.sum(m.sqrt(m.abs(x) + 1e-3)), [2.0, -1.0, 0.5]),
}
UPDATES = {"kink": 5}


class _TorchMath:
    sum = staticmethod(torch.sum)
    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)
    asarray = staticmethod(torch.as_tensor)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_lbfgs_matches_optax(name):
    f, x0 = PROBLEMS[name]
    x0 = np.asarray(x0, np.float32)

    def fj(x):
        return f(x, jnp)

    opt = optax.lbfgs(learning_rate=None, memory_size=10,
                      linesearch=optax.scale_by_zoom_linesearch(
                          max_linesearch_steps=8))

    @jax.jit
    def update(x, st):
        v, g = jax.value_and_grad(fj)(x)
        u, st = opt.update(g, st, x, value=v, grad=g, value_fn=fj)
        return optax.apply_updates(x, u), st

    def value_and_grad(w):
        w = w.detach().requires_grad_()
        with torch.enable_grad():
            v = f(w, _TorchMath)
            g, = torch.autograd.grad(v, w)
        return v.detach(), g

    x, st = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    p = torch.nn.Parameter(torch.as_tensor(x0.copy()))
    tl = LBFGS([p])
    probes = []
    for k in range(UPDATES.get(name, 10)):
        x, st = update(x, st)
        tl.step(*value_and_grad(p.detach()), value_and_grad)
        want = np.asarray(x)
        probes.append(tl.linesearch_steps)
        assert tl.linesearch_steps == int(st[2].info.num_linesearch_steps), \
            f"update {k}: probes {probes}"
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"update {k}")
        np.testing.assert_allclose(float(tl.learning_rate),
                                   float(st[2].learning_rate), rtol=1e-4)
    if name in ("rosenbrock_0_2", "pseudo_huber"):
        assert max(probes) >= 5
    if name == "kink":
        assert probes.count(8) >= 3        # ran out, took the safe step


class _State(dict):
    def detach(self):
        return _State({k: v.detach() for k, v in self.items()})


class _TorchToy(ToyEnv):
    """The toy env with the state methods the port's BPTT calls."""

    def __init__(self, num_envs):
        super().__init__("torch", num_envs)

    def reset(self, key=None):
        return _State(super().reset())

    def step(self, state, actions):
        new, *rest = super().step(state, actions)
        return (_State(new), *rest)

    def initialize_trajectory(self, state):
        s = state.detach()
        return s, self.batch_observations(s)


def _cfg(logdir):
    with open(os.path.join(HERE, "..", "examples", "cfg", "bptt",
                           "cartpole_swing_up.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(logdir), "seed": 0}
    cfg["params"]["algo"]["name"] = "lbfgs"
    cfg["params"]["network"]["actor"] = "ActorDeterministicMLP"
    cfg["params"]["network"]["actor_mlp"]["units"] = [16, 16]
    cfg["params"]["config"].update(num_actors=4, steps_num=6, max_epochs=2,
                                   obs_rms=True, save_interval=0)
    return cfg


def _scaled(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-6 * max(np.abs(b).max(), 1e-30),
                               err_msg=name)


def test_bptt_lbfgs_epochs_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jbptt_mod.env_registry, "make",
                        lambda *a, **kw: ToyEnv("jax", 4))
    monkeypatch.setattr(tbptt_mod.env_registry, "make",
                        lambda *a, **kw: _TorchToy(4))
    jt = jbptt_mod.BPTT(_cfg(tmp_path / "jax"))
    tt = tbptt_mod.BPTT(_cfg(tmp_path / "torch"), device="cpu")
    assert jt.is_lbfgs and tt.is_lbfgs
    load_params(tt.actor, jax.device_get(jt.actor_params))
    state = (jt.actor_params, jt.actor_opt_state, jt.env_state, jt.obs_rms,
             jt.episode_trackers)
    for k in range(2):
        params, opt_state, loss, aux, gnorm = jax.device_get(
            jt._actor_update(*state, jax.random.PRNGKey(k)))
        stats = tt.train_epoch()
        _scaled(stats["actor_loss"], loss, f"update {k} loss")
        _scaled(stats["gnorm"], gnorm, f"update {k} gnorm")
        assert tt.actor_opt.linesearch_steps == int(
            opt_state[2].info.num_linesearch_steps)
        for name, p, want in param_pairs(tt.actor, params):
            _scaled(p.detach(), want, f"update {k} {name}")
        np.testing.assert_allclose(tt.env_state["x"], aux["env_state"]["x"],
                                   rtol=1e-5, atol=1e-6)
        for key in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(tt.obs_rms, key),
                                       getattr(aux["obs_rms"], key),
                                       rtol=1e-5, atol=1e-6)
        state = (params, opt_state, aux["env_state"], aux["obs_rms"],
                 aux["trackers"])
    # the optimizer's memory goes into the checkpoint and comes back
    tt.save("lbfgs")
    other = tbptt_mod.BPTT(_cfg(tmp_path / "other"), device="cpu")
    other.load(os.path.join(tmp_path / "torch", "lbfgs.pt"))
    assert other.actor_opt.count == 2
    for k, v in tt.actor_opt.state_dict().items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(
            getattr(other.actor_opt, k)))

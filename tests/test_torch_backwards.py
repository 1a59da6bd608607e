"""The env's reverse passes (``sim_backward``) on the CPU: "manual"
(simulate's hand-written reverse pass, _SimulateManual), "lb_ad"
(simulate_batched_lb with reverse="residual": each cached substep an
autograd node of K1's and K2's wrappers, the refresh substep through
autograd) and "pallas" (the replay path with K1 and K2), against the JAX
package's and against the port's "lb"; and the trainers taking every
value.

Against JAX: one env step of CartPole (4 substeps, mm 4) on "manual"
with both packages, tests/_torch_urdf_snu.py's check_env_step: values at
rtol 1e-5, atol 5e-5, the gradient of sum(reward) + <w, obs> w.r.t.
(actions, joint_q, joint_qd) at rtol 1e-3, atol 1e-4 in units of each
env's largest entry (testing.check_vjp). "lb_ad" against JAX's is
tests/test_torch_lb_ad.py (each JAX reference compiles for about 25 s).
Against the port's "lb" on Ant (E = 4) and on TinySNU
(tests/_torch_urdf_snu.py: ball joints, 55 muscles, ground contacts; 8
substeps, mm 4, so that a cached substep's cotangent crosses a refresh;
its "lb" gradient is held against JAX's in tests/test_torch_tiny_snu.py):
on the CPU "pallas" runs "lb"'s plain stages and "lb_ad" "manual"'s, so
each pair is equal bit for bit. "manual" and "lb_ad" replay each refresh
substep under autograd, where "lb" takes its VJP in closed form (the
adjoint kernel's and the mass-matrix adjoint kernel's plain versions), so
the two sum the same terms in another order: "lb" is held to "manual" run
in float64 by the float64 rule (testing.check_against_f64, rtol 0), with
"manual" in float32 as the plain version whose error it may not pass.
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml


import diffrl_tpu_torch.config as tconfig
import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.algorithms import BPTT, SHAC
from diffrl_tpu_torch.envs.base import EnvState as TState
from diffrl_tpu_torch.testing import check_against_f64

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
from _torch_urdf_snu import TTinySNU, check_env_step  # noqa: E402

torch.set_num_threads(1)  # the suite's pytest workers share a few cores

E = 4


def test_manual_env_step_matches_jax():
    check_env_step("CartPoleSwingUp", backward="manual")


def _port_grad(name, backward, mm, dtype=torch.float32):
    """The gradient of one env step, its inputs from a float32 state
    (widened to ``dtype``)."""
    kw = dict(num_envs=E, seed=0, stochastic_init=True, device="cpu",
              MM_caching_frequency=mm, sim_backward=backward)
    env = TTinySNU(**kw) if name == "TinySNU" else tenvs.make(name, **kw)
    assert env.sim_backward == backward
    s = env.reset()
    with torch.no_grad():
        for _ in range(2):
            s, *_ = env.step(s, torch.zeros((E, env.num_acts)))
    gen = torch.Generator().manual_seed(0)
    acts = (torch.rand((E, env.num_acts), generator=gen) * 2 - 1
            ).to(dtype).requires_grad_()
    q = s.joint_q.to(dtype).requires_grad_()
    qd = s.joint_qd.to(dtype).requires_grad_()
    _, obs, rew, _, info = env.step(
        TState(q, qd, s.actions.to(dtype), s.progress), acts)
    w = torch.randn(obs.shape, generator=gen).to(dtype)
    return torch.autograd.grad(
        (info["obs_before_reset"] * w).sum() + rew.sum(), (acts, q, qd))


@pytest.mark.parametrize("name,mm", [("Ant", 16), ("TinySNU", 4)])
def test_backwards_equal_lb(name, mm):
    labels = ("actions", "joint_q", "joint_qd")
    want = _port_grad(name, "lb", mm)
    replay = _port_grad(name, "manual", mm)
    for backward, same in (("lb_ad", replay), ("pallas", want)):
        got = _port_grad(name, backward, mm)
        for lab, a, b in zip(labels, got, same):
            assert float(b.abs().max()) > 0.0
            assert torch.equal(a, b), f"{name} {backward} d{lab}"
    exact = _port_grad(name, "manual", mm, torch.float64)
    for lab, a, b, x in zip(labels, want, replay, exact):
        check_against_f64(f"{name} lb d{lab}", a.T, b.T, x.T, 0.0, 0.0)


def test_env_takes_pallas_and_the_config_default():
    env = tenvs.make("Ant", num_envs=2, device="cpu", sim_backward="pallas")
    assert env.sim_backward == "pallas"
    old = tconfig.default_sim_backward
    try:
        tconfig.default_sim_backward = "manual"
        assert tenvs.make("Ant", num_envs=2, device="cpu").sim_backward == \
            "manual"
        tconfig.default_sim_backward = "auto"
        assert tenvs.make("Ant", num_envs=2, device="cpu").sim_backward == \
            "lb"
    finally:
        tconfig.default_sim_backward = old
    with pytest.raises(ValueError, match="sim_backward"):
        tenvs.make("Ant", num_envs=2, device="cpu", sim_backward="scan")


def _cfg(algo, logdir, backward):
    with open(os.path.join(HERE, "..", "examples", "cfg", algo,
                           "cartpole_swing_up.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(logdir), "seed": 0}
    cfg["params"]["diff_env"]["sim_backward"] = backward
    cfg["params"]["config"].update(num_actors=2, steps_num=2, max_epochs=1,
                                   save_interval=0, critic_iterations=1,
                                   num_batch=1)
    return cfg


@pytest.mark.parametrize("algo", ["shac", "bptt"])
def test_trainers_take_every_sim_backward(algo, tmp_path):
    """The trainers hand diff_env.sim_backward to the env unchanged, as the
    JAX trainers do; one epoch on "lb_ad" (2 envs, 2 steps) trains."""
    cls = {"shac": SHAC, "bptt": BPTT}[algo]
    for backward in ("lb", "lb_ad", "pallas", "remat", "manual"):
        tr = cls(_cfg(algo, tmp_path / backward, backward), device="cpu")
        assert tr.env.sim_backward == backward
    tr = cls(_cfg(algo, tmp_path / "train", "lb_ad"), device="cpu")
    params = [p.detach().clone() for p in tr.actor.parameters()]
    tr.train()
    assert not all(torch.equal(a, b) for a, b in zip(
        params, tr.actor.parameters()))
    assert all(np.isfinite(v) for _, _, v in tr.scalars["actor_loss"])

"""The port's check machinery on the CPU: the fixed-order sums of the plain
engine, and a failed kernel check's witness with its replay.

- articulation_lb's fixed-order gather and scatter-sum (``_gather``,
  ``_scatter_sum``) against index_select and the sequential index_add_ on
  the CPU: the same bits, values and cotangents; and the plain path run
  twice gives the same bits (testing.check_repeatable; on the card the same
  check runs at E = 4096 in tests/test_torch_cuda.py and chip_smoke.py);
- a check given a witness (testing.check_kernel) that fails on an injected
  off entry writes the failing env's inputs and its off entries as one .npz
  and names it; tools/replay_witness.py replays it: the port's float32 plain
  version gives the saved plain values again (rtol 1e-6), its float64 one
  the saved float64 answers (rtol 1e-12), and JAX's plain version (CartPole)
  agrees with the float32 plain version at the adjoint's tolerance (rtol
  5e-4, atol 1e-5), while the injected value stands apart from all three;
- the boundary rule's measurements on SNU Humanoid's initial state
  (contacts and muscles): select_margins and select_rounding name every
  select, the plain path's float32 rounding of each select's argument is
  a few units, under SELECT_ULPS; a contact made to touch the ground
  exactly has a depth margin under 1 unit, in that env alone.
"""

import os
import sys

import numpy as np
import pytest
import torch

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch import testing
from diffrl_tpu_torch.sim import articulation_lb as tlb

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import replay_witness  # noqa: E402


def test_fixed_order_sums_match_sequential_index_add():
    rs = np.random.RandomState(0)
    idx = np.array([2, 0, 2, 2, 1, 0, 2])
    fan = tlb._fan(idx, 4, "cpu")
    x = torch.as_tensor(rs.normal(size=(7, 6, 5)).astype(np.float32)
                        ).requires_grad_()
    want = torch.zeros((4, 6, 5)).index_add_(0, torch.as_tensor(idx), x)
    got = tlb._scatter_sum(x, fan)
    assert torch.equal(got, want)
    g = torch.as_tensor(rs.normal(size=(4, 6, 5)).astype(np.float32))
    assert torch.equal(torch.autograd.grad(got, x, g)[0],
                       g[torch.as_tensor(idx)])
    y = torch.as_tensor(rs.normal(size=(4, 3)).astype(np.float32)
                        ).requires_grad_()
    gy = torch.as_tensor(rs.normal(size=(7, 3)).astype(np.float32))
    got = torch.autograd.grad(tlb._gather(y, fan), y, gy)[0]
    want = torch.autograd.grad(y[torch.as_tensor(idx)], y, gy)[0]
    assert torch.equal(got, want)


def test_plain_path_repeatable_on_the_cpu():
    env = tenvs.make("SNUHumanoid", num_envs=3, stochastic_init=True,
                     MM_caching_frequency=8, device="cpu")
    s = env.reset()
    g = torch.Generator()
    g.manual_seed(0)
    acts = torch.rand((3, env.num_acts), generator=g)
    ma = env.action_to_controls(acts)[1].T.contiguous()
    q = s.joint_q.T.contiguous()
    q[1] -= 0.2
    ja = torch.zeros((env.model.dof_count, 3))
    n = testing.check_repeatable(env.model, q, s.joint_qd.T.contiguous(), ja,
                                 ma, env.dt / env.sim_substeps, g)
    assert n == 15


def _cartpole_vjp(E=4):
    env = tenvs.make("CartPoleSwingUp", num_envs=E, stochastic_init=True,
                     MM_caching_frequency=4, device="cpu")
    s = env.reset()
    rs = np.random.RandomState(1)
    acts = torch.as_tensor(rs.uniform(-1, 1, (E, env.num_acts)), dtype=torch.float32)
    ja = env.action_to_controls(acts)[0].T.contiguous()
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = tlb.refresh_substep_lb(
            env.model, s.joint_q.T.contiguous(), s.joint_qd.T.contiguous(),
            ja, None, h)
    gq = torch.as_tensor(rs.normal(size=q1.shape), dtype=torch.float32)
    gqd = torch.as_tensor(rs.normal(size=qd1.shape), dtype=torch.float32)
    args = (env.model, q1, qd1, ja, None, h, H, Hinv, gq, gqd)
    return env, args


def test_failed_check_leaves_a_witness_that_replays(tmp_path, monkeypatch):
    monkeypatch.setattr(testing, "WITNESS_DIR", str(tmp_path))
    env, args = _cartpole_vjp()
    _, q1, qd1, ja, _, h, H, Hinv, gq, gqd = args
    plain = tlb.substep_vjp_lb(*args)
    exact = tlb.substep_vjp_lb(env.model, *(t.double() for t in args[1:4]),
                               None, h, *(t.double() for t in args[6:]))
    kernel = plain[1].clone()
    kernel[1, 2] += 1.0
    witness = testing.substep_witness("CartPoleSwingUp", "substep_vjp", 1,
                                      args)
    margins = tlb.select_margins(env.model, q1, qd1)
    with pytest.raises(AssertionError) as err:
        testing.check_kernel("CartPole dqd", kernel, plain[1], exact[1],
                             2e-4, 1e-5, margins=margins, witness=witness)
    msg = str(err.value)
    assert "first [1, 2] (env 2)" in msg and "witness " in msg
    path = msg.split("witness ")[1]
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    saved = np.load(path)
    assert int(saved["env"]) == 2 and saved["entries"].tolist() == [[1]]
    np.testing.assert_array_equal(saved["q"], q1[:, 2].numpy())
    assert "ma" not in saved

    r = replay_witness.replay(path)
    assert (r["model"], r["kind"], r["output"]) == (
        "CartPoleSwingUp", "substep_vjp", 1)
    np.testing.assert_allclose(r["plain32"], r["plain"], rtol=1e-6)
    np.testing.assert_allclose(r["plain64"], r["want"], rtol=1e-12)
    np.testing.assert_allclose(r["jax"], r["plain32"], rtol=5e-4, atol=1e-5)
    assert abs(r["got"][0] - r["plain64"][0]) > 0.5
    assert set(r["margins"]) == set(tlb.SELECTS)


def test_select_measurements_on_the_initial_state():
    env = tenvs.make("SNUHumanoid", num_envs=2, stochastic_init=True,
                     MM_caching_frequency=8, device="cpu")
    s = env.reset()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    margins = tlb.select_margins(env.model, q, qd)
    rounding = tlb.select_rounding(env.model, q, qd)
    assert set(margins) == set(rounding) == set(tlb.SELECTS)
    assert all(0.0 < v < tlb.SELECT_ULPS for v in rounding.values())
    for name in (tlb.SELECTS[0], tlb.SELECTS[4]):
        assert bool(torch.isfinite(margins[name]).all())
    # lift the root so that one contact's depth is exactly 0 in env 0
    plan = tlb._plan_for(env.model, torch.device("cpu"), torch.float64)
    terms = tlb._select_terms(plan, q.double(), qd.double())
    c = terms[tlb.SELECTS[0]][0]
    k = int(c[:, 0].argmin())
    lifted = q.double().clone()
    lifted[1, 0] -= c[k, 0]
    depth = tlb.select_margins(env.model, lifted, qd)[tlb.SELECTS[0]]
    assert float(depth[0]) < 1.0 and float(depth[1]) > tlb.SELECT_ULPS

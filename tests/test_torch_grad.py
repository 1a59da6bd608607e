"""Gradients of the port's simulator (diffrl_tpu_torch.sim.articulation_lb,
sim.substep_kernels and envs.base) against the JAX package, on the CPU.

- the VJPs of one cached substep and one refresh substep (cotangents on
  q', qd' and, for the refresh, H) against jax.vjp of the JAX lb engine on
  Ant at E = 8: a settled state with ground contacts active, and the same
  state at rest (qd = 0, so every contact's normal velocity is exactly 0:
  the tie in the contact damping's minimum). Tolerances are the Pallas
  adjoint kernel's, tests/test_pallas.py: rtol 2e-4, atol 1e-5;
- the adjoint kernel's CUDA source compiled for the host with g++ (CUDA
  qualifiers and syncs defined away; every thread of a block runs one
  phase before the next starts, so a team's lanes are emulated) against
  its plain version substep_vjp_lb at the same tolerances and against the
  plain version in float64 by diffrl_tpu_torch.testing's rule, at E = 32
  (whole blocks) and E = 37 (a partial block);
- (the window gradient and env.step's gradient against JAX are in
  tests/test_torch_grad_window.py and test_torch_grad_env.py;)
- grad_nan_guard zeroes a NaN cotangent;
- the replay reverse pass runs again on a retained graph;
- the tolerance rules of diffrl_tpu_torch.testing, and the adjoint launch's
  byte and operation counts.
"""

import jax
import numpy as np
import pytest
import torch

import diffrl_tpu.envs as jenvs
from diffrl_tpu.sim import articulation_lb as jlb

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.envs.base import grad_nan_guard
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.testing import (check_against_f64,
                                     check_env_distribution, check_kernel,
                                     check_vjp)

from _torch_host_kernels import build_host_kernel

H_ANT = 1.0 / 60.0 / 16
VJP_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ant():
    jm = jenvs.make("Ant", num_envs=8, MM_caching_frequency=16).model
    tm = tenvs.make("Ant", num_envs=8, MM_caching_frequency=16,
                    device="cpu").model
    return jm, tm


def _settled(tm, E, seed, steps=14):
    """Env-minor numpy (q [C, E], qd [D, E]) after `steps` zero-action env
    steps from the start pose with perturbed joint angles: the torso has
    come down and feet touch the ground (contacts active)."""
    rs = np.random.RandomState(seed)
    q = np.tile(np.asarray(tm.joint_q_init), (E, 1)).astype(np.float32)
    q[:, 7:] += rs.uniform(-0.2, 0.2, (E, 8)).astype(np.float32)
    q, qd = torch.as_tensor(q), torch.zeros((E, tm.dof_count))
    for _ in range(steps):
        q, qd = tlb.simulate_batched_lb(tm, q, qd, None, None, dt=1.0 / 60.0,
                                        substeps=16, mass_matrix_freq=16)
    return (np.ascontiguousarray(q.numpy().T),
            np.ascontiguousarray(qd.numpy().T))


def _contacts_active(tm, q):
    plan = tlb._plan_for(tm, "cpu")
    X_sc, _ = tlb._fk(plan, torch.as_tensor(q))
    p = (tlb._tpoint(X_sc[plan.contact_rows_t], plan.contact_point)
         - plan.ground_normal * plan.contact_dist)
    return (p[:, 1, :] < 0).sum(0).numpy()


@pytest.fixture(scope="module")
def states(ant):
    """{"settled": (q, qd, ja), "rest": (q, 0, ja)} env-minor numpy inputs
    plus cotangents, shared by the VJP tests."""
    _, tm = ant
    E = 8
    q, qd = _settled(tm, E, seed=0)
    assert (_contacts_active(tm, q) > 0).all()
    rs = np.random.RandomState(1)
    ja = np.zeros((tm.dof_count, E), np.float32)
    ja[6:] = rs.uniform(-100.0, 100.0, (tm.dof_count - 6, E))
    cot = [rs.normal(size=s).astype(np.float32)
           for s in ((tm.coord_count, E), (tm.dof_count, E),
                     (tm.dof_count, tm.dof_count, E))]
    return {"settled": (q, qd, ja), "rest": (q, np.zeros_like(qd), ja)}, cot


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


@pytest.fixture(scope="module")
def jax_vjps(ant):
    """Jitted (outputs, VJP) of the JAX refresh and cached substeps."""
    jm, _ = ant

    def refresh(q, qd, ja, cot):
        def f(a, b, c):
            q1, qd1, H, _ = jlb.refresh_substep_lb(jm, a, b, c, None, H_ANT)
            return q1, qd1, H
        out, vjp = jax.vjp(f, q, qd, ja)
        return out, vjp(cot)

    def cached(q, qd, ja, H, Hinv, cot):
        out, vjp = jax.vjp(lambda a, b, c, d: jlb.substep_lb(
            jm, a, b, c, None, H_ANT, d, Hinv), q, qd, ja, H)
        return out, vjp(cot)

    return jax.jit(refresh), jax.jit(cached)


@pytest.mark.parametrize("which", ["settled", "rest"])
def test_substep_vjps_match_jax(ant, states, jax_vjps, which):
    """torch.autograd of the port's refresh and cached substeps against
    jax.vjp of the JAX ones: the frozen-factor H cotangent and the contact
    damping's tie at vn == 0 included."""
    _, tm = ant
    jrefresh, jcached = jax_vjps
    (q, qd, ja), (gq, gqd, gH) = states[0][which], states[1]

    (jq1, jqd1, _), want = jrefresh(q, qd, ja, (gq, gqd, gH))
    leaves = [x.requires_grad_() for x in _t(q, qd, ja)]
    q1, qd1, H, Hinv = tlb.refresh_substep_lb(tm, *leaves, None, H_ANT)
    got = torch.autograd.grad((q1, qd1, H), leaves, _t(gq, gqd, gH))
    for lab, a, b in zip(("dq", "dqd", "dja"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VJP_TOL,
                                   err_msg=f"refresh {which} {lab}")

    # the cached substep from the refresh's output, both sides on the same
    # (H, Hinv)
    H, Hinv = H.detach().numpy(), Hinv.detach().numpy()
    args = (np.asarray(jq1), np.asarray(jqd1), ja, H)
    _, want = jcached(*args, Hinv, (gq, gqd))
    leaves = [x.requires_grad_() for x in _t(*args)]
    out = tlb.substep_lb(tm, *leaves[:3], None, H_ANT, leaves[3],
                         torch.as_tensor(Hinv))
    got = torch.autograd.grad(out, leaves, _t(gq, gqd))
    for lab, a, b in zip(("dq", "dqd", "dja", "dH"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VJP_TOL,
                                   err_msg=f"substep {which} {lab}")
    # the plain adjoint, as the kernel wrapper runs it on CPU tensors
    launches = sk.substep_vjp.launches
    plain = sk.substep_vjp(tm, *_t(*args[:3]), None, H_ANT,
                           *_t(H, Hinv, gq, gqd))
    assert sk.substep_vjp.launches == launches and plain[3] is None
    for lab, a, b in zip(("dq", "dqd", "dja", "dH"),
                         plain[:3] + plain[4:], got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=f"substep_vjp {lab}")


def test_simulate_options(ant):
    _, tm = ant
    q = torch.as_tensor(tm.joint_q_init)[None]
    qd = torch.zeros((1, tm.dof_count))
    with pytest.raises(ValueError, match="multiple"):
        tlb.simulate_batched_lb(tm, q, qd, mass_matrix_freq=5)
    with pytest.raises(ValueError, match="reverse"):
        tlb.simulate_batched_lb(tm, q, qd, mass_matrix_freq=16,
                                reverse="scan")
    replay = tlb.simulate_batched_lb(tm, q, qd, mass_matrix_freq=16)
    residual = tlb.simulate_batched_lb(tm, q, qd, mass_matrix_freq=16,
                                       reverse="residual")
    assert all(torch.equal(a, b) for a, b in zip(replay, residual))


def test_grad_nan_guard_zeroes_nan_cotangent():
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    y = grad_nan_guard(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(
        y, x, torch.tensor([float("nan"), float("inf"), -2.0]))
    assert torch.equal(g, torch.tensor([0.0, 0.0, -2.0]))


@pytest.mark.parametrize("mm", [2, 1])
def test_window_gradient_on_a_retained_graph(ant, states, mm):
    """The replay reverse pass can run again on a retained graph and gives
    the same gradient; without retain_graph autograd has freed its saved
    states. mm 1 has no cached substep, only refresh replays."""
    _, tm = ant
    q, qd, ja = (torch.as_tensor(x[:, :2].T.copy())
                 for x in states[0]["settled"])
    leaves = [x.requires_grad_() for x in (q, qd, ja)]
    tq, tqd = tlb.simulate_batched_lb(tm, *leaves, None, dt=1.0 / 60.0,
                                      substeps=4, mass_matrix_freq=mm)
    loss = tq.sum() + tqd.sum()     # no node but the replay saves tensors
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    second = torch.autograd.grad(loss, leaves)
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    with pytest.raises(RuntimeError, match="second time"):
        torch.autograd.grad(loss, leaves)


def test_vjp_check_rules():
    """diffrl_tpu_torch.testing: the per-env atol of check_vjp, and the
    entrywise float64 rule of check_against_f64 that catches an error at a
    small entry which the per-env atol lets through."""
    exact = torch.tensor([[200.0, 1.0], [0.01, 0.5]], dtype=torch.float64)
    plain = (exact + 1e-5).float()
    assert check_vjp("ok", plain, exact.float(), 2e-4, 1e-5) > 0.0
    # 1e-3 at the entry 0.01 is within atol 1e-5 x 200 of env 0
    off = exact.float().clone()
    off[1, 0] += 1e-3
    check_vjp("loose", off, plain, 2e-4, 1e-5)
    with pytest.raises(AssertionError, match="vs float64"):
        check_against_f64("tight", off, plain, exact, 2e-4, 1e-5)
    with pytest.raises(AssertionError, match="1 entries off"):
        check_vjp("env 1", exact.float() + torch.tensor([[0.0, 0.0],
                                                         [0.0, 1e-3]]),
                  plain, 2e-4, 1e-5)
    n_k, n_p, e_k, e_p, need, at_boundary = check_against_f64(
        "same", plain, plain, exact, 2e-4, 1e-5)
    assert (n_k, n_p, need, at_boundary) == (0, 0, 0.0, 0)
    assert e_k == e_p > 0.0


def test_check_kernel_and_env_distribution_rules():
    """testing.check_kernel reports an entry where the kernel is off the
    plain version and lets float64 decide: it passes where the plain
    version is the one off, and fails where the kernel is.
    check_env_distribution fails a kernel path whose error per env is ten
    times the plain path's in most envs, and passes one chaotic env."""
    exact = torch.tensor([[200.0, 1.0], [0.5, 0.25]], dtype=torch.float64)
    kernel = exact.float()
    plain = kernel.clone()
    plain[1, 1] += 1e-2
    err, n_off, _ = check_kernel("plain off", kernel, plain, exact, 2e-4,
                                 1e-5)
    assert n_off == 1 and err == pytest.approx(1e-2, rel=1e-3)
    with pytest.raises(AssertionError, match="vs float64"):
        check_kernel("kernel off", plain, kernel, exact, 2e-4, 1e-5)

    rs = np.random.RandomState(0)
    exact = torch.as_tensor(rs.normal(size=(5, 20)))
    noise = torch.as_tensor(rs.uniform(1e-6, 2e-6, (5, 20)))
    plain = exact + noise
    chaotic = exact + noise
    chaotic[2, 7] += 10.0                 # one env on a contact's other side
    qs = check_env_distribution("one env", chaotic, plain, exact)
    assert qs[0.5][0] == qs[0.5][1]
    with pytest.raises(AssertionError, match="quantile 0.5"):
        check_env_distribution("all envs", exact + 10 * noise, plain, exact)


def test_vjp_launch_is_bound_by_bytes(ant):
    """One adjoint launch at E = 4096 moves 268 floats in and 239 out per
    env. The operations its function needs (the forward once, then the
    adjoint arithmetic) take less time than those bytes at an H100 SXM's
    published 67 TFLOP/s float32 and 3.35 TB/s, even with every contact
    below the ground."""
    _, tm = ant
    E = 4096
    K = len(tlb._plan_for(tm, "cpu").contact_rows)
    _, consts = sk.kernel_tables(tm)
    nbytes = sk.substep_vjp_bytes(tm, E)
    assert nbytes == 4 * (E * (268 + 239) + consts.size)
    least, most = (sk.substep_vjp_flops(tm, E, n) for n in (0, E * K))
    assert sk.substep_forward_flops(tm, E) < least < most
    assert most / 67e12 < nbytes / 3.35e12


# ---------------------------------------------------------------------------
# the adjoint kernel's CUDA source, compiled for the host

@pytest.fixture(scope="module")
def host_vjp(ant, tmp_path_factory):
    return build_host_kernel(ant[1], "substep_vjp",
                             tmp_path_factory.mktemp("vjp"))


@pytest.fixture(scope="module")
def host_states(ant):
    """As ``states``, at E = 37: two whole blocks of 16 envs and a partial
    one. E = 32 takes the first 32 envs."""
    _, tm = ant
    E = 37
    q, qd = _settled(tm, E, seed=4)
    assert (_contacts_active(tm, q) > 0).all()
    rs = np.random.RandomState(5)
    ja = np.zeros((tm.dof_count, E), np.float32)
    ja[6:] = rs.uniform(-100.0, 100.0, (tm.dof_count - 6, E))
    cot = [rs.normal(size=s).astype(np.float32)
           for s in ((tm.coord_count, E), (tm.dof_count, E))]
    return {"settled": (q, qd, ja), "rest": (q, np.zeros_like(qd), ja)}, cot


@pytest.mark.parametrize("E", [32, 37])
@pytest.mark.parametrize("which", ["settled", "rest"])
def test_vjp_kernel_source_matches_plain_on_host(ant, host_states, host_vjp,
                                                 which, E):
    _, tm = ant
    (q, qd, ja), (gq, gqd) = host_states[0][which], host_states[1]
    q, qd, ja, gq, gqd = (np.ascontiguousarray(x[..., :E])
                          for x in (q, qd, ja, gq, gqd))
    tq, tqd, tja = _t(q, qd, ja)
    _, _, H, Hinv = tlb.refresh_substep_lb(tm, tq, tqd, tja, None, H_ANT)
    want = tlb.substep_vjp_lb(tm, tq, tqd, tja, None, H_ANT, H, Hinv,
                              *_t(gq, gqd))
    exact = tlb.substep_vjp_lb(tm, *(t.double() for t in (tq, tqd, tja)),
                               None, H_ANT, H.double(), Hinv.double(),
                               *(t.double() for t in _t(gq, gqd)))
    outs = host_vjp(q, qd, ja, Hinv.numpy(), gq, gqd, dt=H_ANT)
    for lab, got, w, x in zip(("dq", "dqd", "dja", "dH"), outs,
                              want[:3] + want[4:], exact[:3] + exact[4:]):
        np.testing.assert_allclose(got, w.numpy(), **VJP_TOL,
                                   err_msg=f"{which} {lab}")
        check_against_f64(f"{which} {lab}", torch.as_tensor(got), w, x,
                          **VJP_TOL)

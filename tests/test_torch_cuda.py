"""The cached-substep CUDA kernels against their plain versions, on the GPU.

These tests need a CUDA device and nvcc; without them they skip. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the forward kernel at q rtol 2e-5 atol 2e-6, qd rtol 2e-5
atol 2e-5 (one substep; float32 sums taken in another order than the plain
version). The adjoint kernel by the rules of diffrl_tpu_torch/testing.py:
rtol 2e-4 and atol 1e-5 in units of each env's largest cotangent entry
(check_vjp), and entry by entry no further from the float64 plain version
than twice the float32 plain version's error plus rtol and 8 times the
plain version's largest error in that env (check_against_f64).

Both kernels are checked at E = 4096 (the main path), 1000 (a partial last
block) and 1 (one env in a block of 16); two launches on the same inputs
must give the same bits (no atomics); and at E = 4096 each kernel keeps at
least 4 warps resident per SM. On Humanoid, Hopper and Cheetah both kernels
are held at E = 4096 on a settled state with contacts active, against
float64 by the rules of diffrl_tpu_torch/testing.py (check_kernel; on
Humanoid with its floor: a q', qd' or dH entry there inherits the float32
error of a 27-term sum whose terms are about 100 times it), with the
occupancy and spill checks.
"""

import pytest
import torch

import diffrl_tpu_torch.envs as envs
from diffrl_tpu_torch.sim import articulation_lb as lb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.testing import (F64_FLOOR, HUMANOID_FLOOR,
                                     check_against_f64, check_kernel,
                                     check_vjp)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("E", [4096, 1000, 1])
def test_kernel_matches_plain(cuda, E):
    env = envs.make("Ant", num_envs=E, stochastic_init=True,
                    MM_caching_frequency=16, device=cuda)
    s = env.reset()
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    acts = torch.rand((E, env.num_acts), generator=g, device=cuda) * 2 - 1
    ja = env.action_to_controls(acts)[0].T.contiguous()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(env.model, q, qd, ja, None,
                                                 h)
        n = sk.substep_forward.launches
        kq, kqd = sk.substep_forward(env.model, q1, qd1, ja, None, h, H, Hinv)
        assert sk.substep_forward.launches == n + 1
        pq, pqd = lb.substep_lb(env.model, q1, qd1, ja, None, h, H, Hinv)
        again = sk.substep_forward(env.model, q1, qd1, ja, None, h, H, Hinv)
    torch.cuda.synchronize()
    torch.testing.assert_close(kq, pq, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(kqd, pqd, rtol=2e-5, atol=2e-5)
    assert torch.equal(kq, again[0]) and torch.equal(kqd, again[1])


def test_kernel_rejects_bad_inputs(cuda):
    env = envs.make("Ant", num_envs=64, MM_caching_frequency=16, device=cuda)
    s = env.reset()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    ja = torch.zeros_like(qd)
    Hinv = torch.zeros((14, 14, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        sk.substep_forward(env.model, s.joint_q.T, qd, ja, None, 1e-3, None,
                           Hinv)
    with pytest.raises(ValueError, match="contiguous float32"):
        sk.substep_forward(env.model, q, qd, ja, None, 1e-3, None,
                           Hinv.double())


def _settled(env, steps=14):
    s = env.reset()
    zero = torch.zeros((env.num_envs, env.num_acts), device=env.device)
    with torch.no_grad():
        for _ in range(steps):
            s, *_ = env.step(s, zero)
    return s


@pytest.mark.parametrize("E", [4096, 1000, 1])
def test_vjp_kernel_matches_plain(cuda, E):
    env = envs.make("Ant", num_envs=E, stochastic_init=True,
                    MM_caching_frequency=16, device=cuda)
    s = _settled(env)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    acts = torch.rand((E, env.num_acts), generator=g, device=cuda) * 2 - 1
    ja = env.action_to_controls(acts)[0].T.contiguous()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(env.model, q, qd, ja, None,
                                                 h)
    assert sk.active_contacts(env.model, q1) >= E
    gq = torch.randn(q1.shape, generator=g, device=cuda)
    gqd = torch.randn(qd1.shape, generator=g, device=cuda)
    args = (env.model, q1, qd1, ja, None, h, H, Hinv, gq, gqd)
    n = sk.substep_vjp.launches
    got = sk.substep_vjp(*args)
    assert sk.substep_vjp.launches == n + 1 and got[3] is None
    want = lb.substep_vjp_lb(*args)
    exact = lb.substep_vjp_lb(env.model, *(t.double() for t in args[1:4]),
                              None, h, *(t.double() for t in args[6:]))
    again = sk.substep_vjp(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[:3] + got[4:], again[:3] + again[4:]):
        assert torch.equal(a, b)
    for lab, a, b, x in zip(("dq", "dqd", "djoint_act", "dH"),
                            got[:3] + got[4:], want[:3] + want[4:],
                            exact[:3] + exact[4:]):
        check_vjp(lab, a, b, 2e-4, 1e-5)
        check_against_f64(lab, a, b, x, 2e-4, 1e-5)


@pytest.mark.parametrize("name", ["substep_forward", "substep_vjp"])
def test_kernel_occupancy(cuda, name):
    """At the main path's 4096 envs each kernel keeps at least 4 warps
    resident per SM (the card's occupancy query and the grid), with the
    team layout the tables state and no spills (the only local memory is
    the stack frame of sinf/cosf's reduction of huge arguments)."""
    env = envs.make("Ant", num_envs=8, MM_caching_frequency=16, device=cuda)
    k = sk._prepare(name, env.model, cuda, None)
    a = sk.kernel_attributes(k)
    lay = sk.team_layout(env.model)
    assert (a.threads_per_env, a.envs_per_block) == (
        lay.threads_per_env, lay.envs_per_block)
    assert a.smem_bytes == lay.smem_bytes(name)
    assert a.max_blocks_per_sm >= 1
    assert k.built.spill_store_bytes == k.built.spill_load_bytes == 0
    _, warps = a.resident(4096)
    assert warps >= 4.0


def test_vjp_kernel_rejects_bad_inputs(cuda):
    env = envs.make("Ant", num_envs=64, MM_caching_frequency=16, device=cuda)
    s = env.reset()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    ja = torch.zeros_like(qd)
    Hinv = torch.zeros((14, 14, 64), device=cuda)
    gq, gqd = torch.zeros_like(q), torch.zeros_like(qd)
    with pytest.raises(ValueError, match="contiguous float32"):
        sk.substep_vjp(env.model, q, qd, ja, None, 1e-3, None, Hinv,
                       s.joint_q.T, gqd)
    with pytest.raises(ValueError, match="contiguous float32"):
        sk.substep_vjp(env.model, q, qd, ja, None, 1e-3, None, Hinv, gq,
                       gqd.double())
    with pytest.raises(ValueError, match="shape"):
        sk.substep_vjp(env.model, q, qd, ja, None, 1e-3, None, Hinv[:13],
                       gq, gqd)
    with pytest.raises(NotImplementedError, match="muscles"):
        sk.substep_vjp(env.model, q, qd, ja, torch.zeros((2, 64),
                                                         device=cuda),
                       1e-3, None, Hinv, gq, gqd)


# substeps per env step (one mass-matrix period) and zero-action steps from
# reset until ground contacts are active, as chip_smoke.py's MODELS
_MJCF = {"Humanoid": (48, 12), "Hopper": (16, 8), "Cheetah": (16, 16)}


@pytest.mark.parametrize("name", sorted(_MJCF))
def test_kernels_match_plain_on_mjcf_models(cuda, name):
    E = 4096
    mm, settle = _MJCF[name]
    env = envs.make(name, num_envs=E, stochastic_init=True,
                    MM_caching_frequency=mm, device=cuda)
    s = _settled(env, settle)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    acts = torch.rand((E, env.num_acts), generator=g, device=cuda) * 2 - 1
    ja = env.action_to_controls(acts)[0].T.contiguous()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(env.model, q, qd, ja, None,
                                                 h)
    assert sk.active_contacts(env.model, q1) >= E
    gq = torch.randn(q1.shape, generator=g, device=cuda)
    gqd = torch.randn(qd1.shape, generator=g, device=cuda)
    args = (env.model, q1, qd1, ja, None, h, H, Hinv)
    d64 = [t.double() for t in (q1, qd1, ja)]
    kf = sk.substep_forward(*args)
    pf = lb.substep_lb(*args)
    xf = lb.substep_lb(env.model, *d64, None, h, H.double(), Hinv.double())
    kv = sk.substep_vjp(*args, gq, gqd)
    pv = lb.substep_vjp_lb(*args, gq, gqd)
    xv = lb.substep_vjp_lb(env.model, *d64, None, h,
                           *(t.double() for t in (H, Hinv, gq, gqd)))
    torch.cuda.synchronize()
    floor = HUMANOID_FLOOR if name == "Humanoid" else F64_FLOOR
    for lab, a, b, x, atol in (("q", kf[0], pf[0], xf[0], 2e-6),
                               ("qd", kf[1], pf[1], xf[1], 2e-5)):
        check_kernel(f"{name} {lab}", a, b, x, 2e-5, atol, floor)
    for lab, a, b, x in zip(("dq", "dqd", "djoint_act", "dH"),
                            kv[:3] + kv[4:], pv[:3] + pv[4:],
                            xv[:3] + xv[4:]):
        check_kernel(f"{name} {lab}", a, b, x, 2e-4, 1e-5, floor)
    for kname in ("substep_forward", "substep_vjp"):
        k = sk._prepare(kname, env.model, cuda, None)
        assert k.built.spill_store_bytes == k.built.spill_load_bytes == 0
        assert sk.kernel_attributes(k).resident(E)[1] >= 4.0

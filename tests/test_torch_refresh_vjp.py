"""The refresh substep's VJP without its replay, on the CPU.

The refresh substep is the cached substep run on the (H, Hinv) it builds,
and H depends on q alone, so its VJP with cotangents on (q', qd', H) is the
adjoint kernel's plain version (``substep_vjp_lb``) at the refresh's input
plus the mass matrix's adjoint (``mass_matrix_vjp_lb``) with H's whole
cotangent. Held in float64 at E = 3 against autograd of
``refresh_substep_lb`` on Ant, Humanoid, Hopper, Cheetah, CartPole and SNU
Humanoid (its muscles' cotangent included), at rtol and atol 1e-10: the
two sum the same terms in another order. The replay reverse pass
(``_SimulateReplay``) no longer runs ``refresh_substep_lb`` in its
backward, and sends each block's refresh to the mass matrix's adjoint
once. The mass matrix's adjoint kernel (``csrc/mass_matrix_vjp.cuh``),
compiled for the host with g++ (tests/_torch_host_kernels.py), is held at
E = 37 (a partial last block) against its plain version and float64 by the
rule of diffrl_tpu_torch/testing.py (check_kernel, rtol 2e-4, atol 1e-5)
on Ant (free and revolute joints), CartPole (fixed, prismatic, revolute)
and SNU Humanoid (ball joints; the muscles are not read), with each free
and ball joint's quaternion off the unit sphere (the plain version reads
it as it is). This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.testing import check_kernel

from _torch_host_kernels import build_host_kernel

torch.set_num_threads(1)  # the suite's pytest workers share a few cores

NAMES = ("Ant", "Humanoid", "Hopper", "Cheetah", "CartPoleSwingUp",
         "SNUHumanoid")


@pytest.fixture(scope="module")
def models():
    return {n: tenvs.make(n, num_envs=2, device="cpu") for n in NAMES}


def _inputs(env, E, dtype, seed=0):
    """(q, qd, ja, ma | None) env-minor: the start pose and random
    velocities, torques and activations, each coordinate moved by up to
    0.1 (quaternions off the unit sphere too)."""
    m = env.model
    g = torch.Generator().manual_seed(seed)
    q = torch.as_tensor(np.asarray(m.joint_q_init, np.float32))
    q = q[:, None].expand(-1, E) + 0.1 * (
        2 * torch.rand((m.coord_count, E), generator=g) - 1)
    qd = 0.5 * torch.randn((m.dof_count, E), generator=g)
    ja = torch.randn((m.dof_count, E), generator=g)
    M = m.topology.muscle_count
    ma = torch.rand((M, E), generator=g) if M else None
    return [None if t is None else t.to(dtype) for t in (q, qd, ja, ma)]


@pytest.mark.parametrize("name", NAMES)
def test_refresh_vjp_is_the_adjoint_plus_the_mass_matrix_vjp(models, name):
    env = models[name]
    m, h = env.model, env.dt / env.sim_substeps
    q, qd, ja, ma = _inputs(env, 3, torch.float64)
    leaves = [t.clone().requires_grad_() for t in (q, qd, ja, ma)
              if t is not None]
    q1, qd1, H1, _ = tlb.refresh_substep_lb(
        m, *leaves[:3], leaves[3] if ma is not None else None, h)
    g = torch.Generator().manual_seed(1)
    cots = [torch.randn(t.shape, generator=g, dtype=t.dtype)
            for t in (q1, qd1, H1)]
    want = torch.autograd.grad((q1, qd1, H1), leaves, cots)
    with torch.no_grad():
        _, _, H, Hinv = tlb.refresh_substep_lb(m, q, qd, ja, ma, h)
    dq, dqd, dja, dma, dH = tlb.substep_vjp_lb(m, q, qd, ja, ma, h, H, Hinv,
                                               *cots[:2])
    got = [sk.mass_matrix_vjp(m, q, cots[2] + dH, dq), dqd, dja]
    got += [dma] if ma is not None else []
    for lab, a, b in zip(("dq", "dqd", "djoint_act", "dma"), got, want):
        assert float(b.abs().max()) > 0.0
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10,
                                   msg=f"{name} {lab}")


def test_replay_backward_does_not_rerun_the_refresh(models, monkeypatch):
    """Ant, 2 envs, 32 substeps in blocks of 16: the forward runs the
    refresh twice, the backward never, and the mass matrix's adjoint once
    per block; the gradient reaches every input."""
    m = models["Ant"].model
    calls = {"refresh": 0, "mass": 0}
    refresh, mass = tlb.refresh_substep_lb, sk.mass_matrix_vjp

    def counted_refresh(*a, **k):
        calls["refresh"] += 1
        return refresh(*a, **k)

    def counted_mass(*a, **k):
        calls["mass"] += 1
        return mass(*a, **k)

    monkeypatch.setattr(tlb, "refresh_substep_lb", counted_refresh)
    monkeypatch.setattr(sk, "mass_matrix_vjp", counted_mass)
    q, qd, ja, _ = (None if t is None else t.T.contiguous().requires_grad_()
                    for t in _inputs(models["Ant"], 2, torch.float32))
    q1, qd1 = tlb.simulate_batched_lb(m, q, qd, ja, substeps=32,
                                      mass_matrix_freq=16)
    assert calls == {"refresh": 2, "mass": 0}
    grads = torch.autograd.grad(q1.sum() + qd1.sum(), (q, qd, ja))
    assert calls == {"refresh": 2, "mass": 2}
    assert all(bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0
               for t in grads)


@pytest.fixture(scope="module")
def host_mass(models, tmp_path_factory):
    return {n: build_host_kernel(models[n].model, "mass_matrix_vjp",
                                 tmp_path_factory.mktemp(n))
            for n in ("Ant", "CartPoleSwingUp", "SNUHumanoid")}


@pytest.mark.parametrize("name", ["Ant", "CartPoleSwingUp", "SNUHumanoid"])
def test_mass_matrix_vjp_kernel_source_matches_plain_on_host(
        models, host_mass, name):
    m = models[name].model
    E, D = 37, m.dof_count
    q = _inputs(models[name], E, torch.float32, seed=2)[0].contiguous()
    g = torch.Generator().manual_seed(3)
    gH = torch.randn((D, D, E), generator=g)
    dq = torch.randn(q.shape, generator=g)
    want = sk.mass_matrix_vjp(m, q, gH, dq)
    exact = sk.mass_matrix_vjp(m, q.double(), gH.double(), dq.double())
    got = host_mass[name](q.numpy(), gH.numpy(), dq.numpy(), dt=None)[0]
    check_kernel(f"{name} dq", torch.as_tensor(got), want, exact, 2e-4,
                 1e-5)

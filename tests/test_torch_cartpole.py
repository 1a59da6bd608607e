"""The port's CartPole swing-up against the JAX package, on the CPU: its
fixed root (the slide bar) with a prismatic cart and a revolute pole, no
ground.

- refresh_substep_lb and substep_lb, values and VJPs, against jax.vjp of
  the JAX ones at E = 4 (tests/_torch_urdf_snu.py: refresh q rtol 2e-5
  atol 1e-6, qd rtol 2e-5 atol 2e-5, H rtol 2e-5 atol 1e-4, VJP rtol 2e-3
  atol 1e-3; cached substep q rtol 2e-5 atol 2e-6, qd rtol 2e-5 atol
  2e-5, VJP rtol 5e-4 atol 1e-5 by diffrl_tpu_torch/testing.py's rules);
- env.step's values and gradient against the JAX env on its lb engine, 4
  substeps in one mass-matrix period (values rtol 1e-5 atol 5e-5,
  gradient rtol 1e-3 atol 1e-4 in units of each env's largest entry);
- the plain path against the dflex golden trajectory
  tests/fixtures/env_cartpole_urdf.npz (60 steps of 4 substeps, mm 4, the
  builder's gravity -9.8 and a constant force of 120 on the cart) at
  tests/test_parity.py's bands (atol 1e-5 for 15 steps, 1e-4 for all);
- both CUDA kernels' sources for CartPole compiled for the host with g++
  (tests/_torch_host_kernels.py) against their plain versions and float64
  by testing.check_kernel at E = 32 and 37 (a partial block of the 16-env
  blocks), the adjoint also at rest.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from diffrl_tpu_torch.sim import articulation_lb as tlb

from _torch_host_kernels import build_host_kernel
from _torch_urdf_snu import (check_cached, check_env_step,
                             check_host_kernels, check_refresh, envs,
                             host_inputs)

HERE = os.path.dirname(__file__)


def test_refresh_substep_matches_jax():
    check_refresh("CartPoleSwingUp")


def test_cached_substep_matches_jax():
    check_cached("CartPoleSwingUp")


def test_env_step_matches_jax():
    check_env_step("CartPoleSwingUp")


def test_cartpole_fixture_plain_path():
    tm = envs("CartPoleSwingUp", 1)[1].model
    fix = np.load(os.path.join(HERE, "fixtures", "env_cartpole_urdf.npz"))
    model = dataclasses.replace(
        tm, gravity=np.array([0.0, -9.8, 0.0], np.float32))
    q = torch.as_tensor(model.joint_q_init)[None]
    qd = torch.zeros((1, 2))
    ja = torch.tensor([[120.0, 0.0]])
    traj = []
    for _ in range(fix["joint_q"].shape[0]):
        q, qd = tlb.simulate_batched_lb(model, q, qd, ja, None,
                                        dt=1.0 / 60.0, substeps=4,
                                        mass_matrix_freq=4)
        traj.append(q[0].numpy())
    got = np.stack(traj)
    np.testing.assert_allclose(got[:15], fix["joint_q"][:15], atol=1e-5)
    np.testing.assert_allclose(got, fix["joint_q"], atol=1e-4)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    env = envs("CartPoleSwingUp", 37)[1]
    return env, *(build_host_kernel(env.model, k, tmp_path_factory.mktemp(k))
                  for k in ("substep_forward", "substep_vjp")), \
        host_inputs(env, 37, seed=11)


@pytest.mark.parametrize("E", [32, 37])
@pytest.mark.parametrize("rest", [False, True])
def test_kernel_sources_match_plain_on_host(host, E, rest):
    check_host_kernels(*host, E, rest=rest)


def test_launch_bounds():
    """One launch at E = 4096: K1 moves 10 floats in (q, qd, joint_act,
    Hinv) and 4 out (q', qd') per env, K2 14 in (with gq, gqd) and 10 out
    (dq, dqd, djoint_act, dH), each with the constants once; no contacts
    and no muscles. With 2 dofs both are bound by operations at an H100
    SXM's published 67 TFLOP/s float32 and 3.35 TB/s."""
    from diffrl_tpu_torch.sim import substep_kernels as sk

    tm = envs("CartPoleSwingUp", 2)[1].model
    E = 4096
    _, consts = sk.kernel_tables(tm)
    f_bytes = sk.substep_forward_bytes(tm, E)
    v_bytes = sk.substep_vjp_bytes(tm, E)
    assert f_bytes == 4 * (E * 14 + consts.size)
    assert v_bytes == 4 * (E * 24 + consts.size)
    f_ops = sk.substep_forward_flops(tm, E)
    assert f_ops < sk.substep_vjp_flops(tm, E, 0)
    assert f_ops / 67e12 > f_bytes / 3.35e12
    assert sk.substep_vjp_flops(tm, E, 0) / 67e12 > v_bytes / 3.35e12

"""The port's ball joints and muscles against the JAX package, on the CPU,
on the 3-bone SNU variant TinySNU (tests/_torch_urdf_snu.py: a free
pelvis, a ball hip, a hinge knee; 55 muscles over 66 segments between
links; 24 ground contacts; 8 substeps in two mass-matrix periods of 4).

- refresh_substep_lb and substep_lb, values and VJPs (the muscle
  activations' cotangent dma included), against jax.vjp of the JAX ones at
  E = 4, at tests/_torch_urdf_snu.py's tolerances;
- env.step's values and gradient against the JAX env on its lb engine:
  the actions reach the simulator only as muscle activations, so the
  gradient w.r.t. the actions is the muscle-activation gradient of the
  replay reverse pass (values rtol 1e-5 atol 5e-5, gradient rtol 1e-3
  atol 1e-4 in units of each env's largest entry);
- both CUDA kernels' sources for TinySNU compiled for the host with g++
  against their plain versions and float64 (testing.check_kernel) at
  E = 37 (a partial block), dma included.
"""

import pytest

from diffrl_tpu_torch.sim import substep_kernels as sk

from _torch_host_kernels import build_host_kernel
from _torch_urdf_snu import (check_cached, check_env_step,
                             check_host_kernels, check_refresh, envs,
                             host_inputs)


def test_refresh_substep_matches_jax():
    check_refresh("TinySNU")


def test_cached_substep_matches_jax():
    check_cached("TinySNU")


def test_env_step_matches_jax():
    check_env_step("TinySNU")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    env = envs("TinySNU", 37)[1]
    return env, *(build_host_kernel(env.model, k, tmp_path_factory.mktemp(k))
                  for k in ("substep_forward", "substep_vjp")), \
        host_inputs(env, 37, seed=11)


@pytest.mark.parametrize("rest", [False, True])
def test_kernel_sources_match_plain_on_host(host, rest):
    env, _, _, ins = host
    assert sk.active_contacts(env.model, ins[0]) > 0
    check_host_kernels(*host, 37, rest=rest)


def test_launch_bounds():
    """One launch at E = 4096: K1 moves 187 floats in (q, qd, joint_act,
    the 55 activations, Hinv) and 22 out per env, K2 209 in (with gq, gqd)
    and 187 out (dq, dqd, djoint_act, dma, dH), each with the constants
    once. The 66 muscle segments add 128 operations each to the forward's
    count and 204 more each to the adjoint's: the same tree without
    muscles (the torque variant) counts exactly that much less."""
    E = 4096
    tm = envs("TinySNU", 2)[1].model
    bare = type(envs("TinySNU", 2)[1])(num_envs=2, device="cpu",
                                       mtu_actuations=False).model
    assert (tm.topology.muscle_count, bare.topology.muscle_count) == (55, 0)
    _, consts = sk.kernel_tables(tm)
    assert sk.substep_forward_bytes(tm, E) == 4 * (E * 209 + consts.size)
    assert sk.substep_vjp_bytes(tm, E) == 4 * (E * 396 + consts.size)
    f_more = sk.substep_forward_flops(tm, E) - sk.substep_forward_flops(
        bare, E)
    assert f_more == 66 * 128 * E
    for n in (0, 100):
        assert sk.substep_vjp_flops(tm, E, n) - sk.substep_vjp_flops(
            bare, E, n) == f_more + 66 * 204 * E

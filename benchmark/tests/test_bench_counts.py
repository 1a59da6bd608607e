"""The benchmark's frozen counts of K1's and K2's operations and bytes
equal the port's own functions on today's tree, on the reference's model
and the port's model of each configuration's robot."""

import pytest
import torch

from benchmark.harness import counts
from benchmark.reference.envs import model_of
from diffrl_tpu_torch import envs as port_envs
from diffrl_tpu_torch.sim import substep_kernels as sk

ROBOTS = ("AntEnv", "HumanoidEnv")


@pytest.mark.parametrize("name", ROBOTS)
@pytest.mark.parametrize("E", (1, 4096, 65536))
def test_kernel_counts_match_the_port(name, E):
    port = port_envs.make(name, num_envs=1, device="cpu").model
    ref = model_of(name)
    assert counts.substep_forward_bytes(ref, E) == \
        sk.substep_forward_bytes(port, E)
    assert counts.substep_forward_flops(ref, E) == \
        sk.substep_forward_flops(port, E)
    assert counts.substep_vjp_bytes(ref, E) == sk.substep_vjp_bytes(port, E)
    for n_active in (0, 3 * E):
        assert counts.substep_vjp_flops(ref, E, n_active) == \
            sk.substep_vjp_flops(port, E, n_active)


@pytest.mark.parametrize("name", ROBOTS)
def test_active_contacts_match_the_port(name):
    env = port_envs.make(name, num_envs=64, device="cpu", seed=3,
                         stochastic_init=True)
    q = env.reset().joint_q
    q = q + 0.3 * torch.randn(q.shape, generator=torch.Generator().
                              manual_seed(1))
    q = q.T.contiguous()
    assert counts.active_contacts(model_of(name), q) == \
        sk.active_contacts(env.model, q)


def test_epoch_counts_are_positive_and_grow_with_the_batch():
    from benchmark.harness import spec

    for name in ("ant.shac_65536", "ant.ppo_65536"):
        cell = spec.load_cell(name)
        cfg = cell.trainer_cfg(0, "")
        model = model_of(cell.config["diff_env"]["name"])
        fn = counts.EPOCH_FLOPS[cell.trainer]
        a = fn(model, cfg, cell.config["model"], 1024, 0)
        b = fn(model, cfg, cell.config["model"], 2048, 0)
        assert 0 < a < b

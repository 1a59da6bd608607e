"""The benchmark's frozen counts of K3's operations and bytes
(``harness/counts_k3.py``) equal the port's own functions on today's tree,
on the reference's model and the port's model of each configuration's
robot."""

import pytest

from benchmark.harness import counts_k3
from benchmark.reference.envs import model_of
from diffrl_tpu_torch import envs as port_envs
from diffrl_tpu_torch.sim import substep_kernels as sk

ROBOTS = ("AntEnv", "HumanoidEnv")


@pytest.mark.parametrize("name", ROBOTS)
@pytest.mark.parametrize("E", (1, 4096, 32768))
def test_k3_counts_match_the_port(name, E):
    port = port_envs.make(name, num_envs=1, device="cpu").model
    ref = model_of(name)
    assert counts_k3.mass_matrix_vjp_bytes(ref, E) == \
        sk.mass_matrix_vjp_bytes(port, E)
    assert counts_k3.mass_matrix_vjp_flops(ref, E) == \
        sk.mass_matrix_vjp_flops(port, E)

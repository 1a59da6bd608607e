"""The cached-substep CUDA kernel against its plain version, on the GPU.

These tests need a CUDA device and nvcc; without them they skip. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the kernel's: q rtol 2e-5 atol 2e-6, qd rtol 2e-5 atol 2e-5
(one substep; float32 sums taken in another order than the plain version).
"""

import pytest
import torch

import diffrl_tpu_torch.envs as envs
from diffrl_tpu_torch.sim import articulation_lb as lb
from diffrl_tpu_torch.sim import substep_kernels as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("E", [4096, 1000])
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
    torch.cuda.synchronize()
    torch.testing.assert_close(kq, pq, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(kqd, pqd, rtol=2e-5, atol=2e-5)


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

"""The CUDA sources of both substep kernels, generated for Humanoid (22
links, 27 dofs, 10 levels, 35 contacts) and Hopper (a planar base of two
slides and a hinge, no free joint), compiled for the host with g++
(tests/_torch_host_kernels.py) and held against their plain versions on
the CPU, at E = 32 and 37: the blocks hold 16 envs (a team of 8 lanes),
so 37 leaves a partial last block.

Inputs: each env's start pose with its base lowered so that ground
contacts are active (tests/_torch_mjcf.py), and its refresh substep's
factorization. K1 against substep_lb and K2 against substep_vjp_lb, both
also against the plain version run in float64, by the rules of
diffrl_tpu_torch/testing.py (check_kernel; K1 at q rtol 2e-5 atol 2e-6 and
qd rtol 2e-5 atol 2e-5, K2 at rtol 2e-4 atol 1e-5) that chip_smoke.py
holds the card's builds to; K2 also at rest (qd = 0: every contact's
normal velocity is 0, the tie of the contact damping's minimum).
This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.testing import check_kernel

from _torch_host_kernels import build_host_kernel

SUBSTEPS = {"Humanoid": 48, "Hopper": 16}
DROP = {"Humanoid": (-0.12, -0.06), "Hopper": (-0.10, -0.04)}
MODELS = sorted(SUBSTEPS)


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """{name: (model, h, K1 host build, K2 host build, (q1, qd1, ja, H,
    Hinv, gq, gqd) at E = 37)}."""
    out = {}
    E = 37
    for name in MODELS:
        env = tenvs.make(name, num_envs=E, MM_caching_frequency=SUBSTEPS[name],
                         device="cpu")
        m = env.model
        h = env.dt / env.sim_substeps
        rs = np.random.RandomState(11)
        q = np.tile(np.asarray(m.joint_q_init, np.float64), (E, 1))
        free = 7 if m.topology.joint_type[0] == 4 else 0
        q[:, free:] += rs.uniform(-0.1, 0.1, (E, m.coord_count - free))
        q[:, 1] += rs.uniform(*DROP[name], E)
        qd = rs.uniform(-0.5, 0.5, (E, m.dof_count))
        acts = torch.as_tensor(rs.uniform(-1.0, 1.0, (E, env.num_acts)),
                               dtype=torch.float32)
        ja = env.action_to_controls(acts)[0].T.contiguous()
        q, qd = (torch.as_tensor(x.T.copy(), dtype=torch.float32)
                 for x in (q, qd))
        with torch.no_grad():
            q1, qd1, H, Hinv = tlb.refresh_substep_lb(m, q, qd, ja, None, h)
        assert sk.active_contacts(m, q1) >= E // 2
        gq = torch.as_tensor(rs.normal(size=q1.shape), dtype=torch.float32)
        gqd = torch.as_tensor(rs.normal(size=qd1.shape), dtype=torch.float32)
        out[name] = (m, h, *(build_host_kernel(
            m, k, tmp_path_factory.mktemp(f"{name}_{k}"))
            for k in ("substep_forward", "substep_vjp")),
            (q1, qd1, ja, H, Hinv, gq, gqd))
    return out


def _np(*xs):
    return [np.ascontiguousarray(x.numpy()) for x in xs]


@pytest.mark.parametrize("E", [32, 37])
@pytest.mark.parametrize("name", MODELS)
def test_forward_kernel_source_matches_plain_on_host(setups, name, E):
    m, h, k1, _, ins = setups[name]
    q1, qd1, ja, H, Hinv = (x[..., :E].contiguous() for x in ins[:5])
    want = tlb.substep_lb(m, q1, qd1, ja, None, h, H, Hinv)
    exact = tlb.substep_lb(m, *(x.double() for x in (q1, qd1, ja)), None, h,
                           H.double(), Hinv.double())
    got = k1(*_np(q1, qd1, ja, Hinv), dt=h)
    for lab, g, w, x, atol in zip(("q", "qd"), got, want, exact,
                                  (2e-6, 2e-5)):
        check_kernel(f"{name} {lab}", torch.as_tensor(g), w, x, 2e-5, atol)


@pytest.mark.parametrize("E", [32, 37])
@pytest.mark.parametrize("which", ["settled", "rest"])
@pytest.mark.parametrize("name", MODELS)
def test_vjp_kernel_source_matches_plain_on_host(setups, name, which, E):
    m, h, _, k2, ins = setups[name]
    q1, qd1, ja, H, Hinv, gq, gqd = (x[..., :E].contiguous() for x in ins)
    if which == "rest":
        qd1 = torch.zeros_like(qd1)
    args = (q1, qd1, ja, H, Hinv, gq, gqd)
    want = tlb.substep_vjp_lb(m, *args[:3], None, h, *args[3:])
    exact = tlb.substep_vjp_lb(m, *(x.double() for x in args[:3]), None, h,
                               *(x.double() for x in args[3:]))
    got = k2(*_np(q1, qd1, ja, Hinv, gq, gqd), dt=h)
    for lab, g, w, x in zip(("dq", "dqd", "dja", "dH"), got,
                            want[:3] + want[4:], exact[:3] + exact[4:]):
        check_kernel(f"{name} {which} {lab}", torch.as_tensor(g), w, x, 2e-4,
                     1e-5)

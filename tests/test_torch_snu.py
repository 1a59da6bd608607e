"""The port's SNU Humanoid on the CPU: the dflex golden trajectory, the
muscle path against the TPU kernels, and both CUDA kernels' sources for the
full SNU tree.

- the plain path against tests/fixtures/env_snu_muscles.npz (16 steps of
  48 substeps, mm 48, the builder's gravity -9.8, no joint torques, the
  152 muscles at constant activations of 0.05 of their peak force) at
  tests/test_parity.py's bands for SNU Humanoid (atol 1e-4 for 15 steps,
  1e-3 for all);
- the kernel wrappers' plain paths on tests/test_pallas.py's two-link
  muscle model against the TPU kernels themselves,
  pallas_substep.substep_{forward,vjp}_batched in interpret mode, at E =
  1024 (the TPU kernels take E % 1024 == 0), at tests/test_pallas.py's
  tolerances (q rtol/atol 2e-6, qd rtol 2e-6 atol 2e-5; VJP rtol 2e-4
  atol 1e-5);
- both CUDA kernels' sources for SNU Humanoid (11 links, 4 ball joints,
  88 contacts, 152 muscles over 198 segments) compiled for the host with
  g++ (tests/_torch_host_kernels.py) against their plain versions and
  float64 by testing.check_kernel at E = 32 and 37 (a partial block), dma
  included; the adjoint also at rest;
- the float64 rule's envs at a select's boundary (a named select within
  testing.SELECT_ULPS float32 units of it, articulation_lb.select_margins),
  which settled SNU Humanoid states can hold.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffrl_tpu.sim.pallas_substep import (substep_forward_batched,
                                           substep_vjp_batched)

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.sim.model import JOINT_REVOLUTE, ModelBuilder
from diffrl_tpu_torch.testing import check_against_f64

from _torch_host_kernels import build_host_kernel
from _torch_urdf_snu import check_host_kernels, host_inputs
from test_pallas import _two_link_muscle

HERE = os.path.dirname(__file__)
QI = (0.0, 0.0, 0.0, 1.0)


def _snu(E):
    return tenvs.make("SNUHumanoid", num_envs=E, MM_caching_frequency=8,
                      device="cpu")


def test_snu_fixture_plain_path():
    env = _snu(1)
    fix = np.load(os.path.join(HERE, "fixtures", "env_snu_muscles.npz"))
    model = dataclasses.replace(
        env.model, gravity=np.array([0.0, -9.8, 0.0], np.float32))
    q = torch.as_tensor(model.joint_q_init)[None]
    qd = torch.zeros((1, model.dof_count))
    ja = torch.zeros((1, model.dof_count))
    ma = torch.tensor([[0.05 * m.peak_force for m in env.skeleton.muscles]])
    traj = []
    for _ in range(fix["joint_q"].shape[0]):
        q, qd = tlb.simulate_batched_lb(model, q, qd, ja, ma,
                                        dt=1.0 / 60.0, substeps=48,
                                        mass_matrix_freq=48)
        traj.append(q[0].numpy())
    got = np.stack(traj)
    np.testing.assert_allclose(got[:15], fix["joint_q"][:15], atol=1e-4)
    np.testing.assert_allclose(got, fix["joint_q"], atol=1e-3)


def _port_two_link_muscle():
    """tests/test_pallas.py's two-link muscle model, built by the port."""
    import dataclasses

    b = ModelBuilder()
    b.add_articulation()
    l0 = b.add_link(-1, np.array([0.0, 1.0, 0.0, *QI]), axis=(0.0, 0.0, 1.0),
                    type=JOINT_REVOLUTE)
    b.add_shape_capsule(l0, pos=(0.25, 0.0, 0.0), radius=0.05,
                        half_width=0.25, density=500.0)
    l1 = b.add_link(l0, np.array([0.5, 0.0, 0.0, *QI]), axis=(0.0, 0.0, 1.0),
                    type=JOINT_REVOLUTE)
    b.add_shape_capsule(l1, pos=(0.25, 0.0, 0.0), radius=0.05,
                        half_width=0.25, density=500.0)
    b.add_muscle([l0, l1], [np.array([0.05, 0.05, 0.0]),
                            np.array([0.2, 0.05, 0.0])],
                 f0=10.0, lm=0.3, lt=0.1, lmax=0.5, pen=0.0)
    return dataclasses.replace(
        b.finalize(), ground=False,
        gravity=np.array([0.0, -9.81, 0.0], np.float32))


def test_plain_substep_matches_pallas_kernels_interpret():
    jm, tm = _two_link_muscle(), _port_two_link_muscle()
    E, h = 1024, 1.0 / 60.0 / 4
    rs = np.random.RandomState(1)
    q = rs.uniform(-0.4, 0.4, (2, E)).astype(np.float32)
    qd = rs.uniform(-0.2, 0.2, (2, E)).astype(np.float32)
    ja = rs.uniform(-0.5, 0.5, (2, E)).astype(np.float32)
    ma = rs.uniform(0.1, 0.9, (1, E)).astype(np.float32)
    gq = rs.normal(size=(2, E)).astype(np.float32)
    gqd = rs.normal(size=(2, E)).astype(np.float32)
    t = [torch.as_tensor(x) for x in (q, qd, ja, ma, gq, gqd)]
    _, _, H, Hinv = tlb.refresh_substep_lb(tm, *t[:4], h)
    j = [jnp.asarray(x) for x in (q, qd, ja, ma, gq, gqd)]
    jH, jHinv = jnp.asarray(H.numpy()), jnp.asarray(Hinv.numpy())
    jq, jqd = substep_forward_batched(jm, h, *j[:4], jHinv)
    jv = substep_vjp_batched(jm, h, *j[:4], jH, jHinv, j[4], j[5])
    # on CPU tensors the kernel wrappers run the plain versions
    n = (sk.substep_forward.launches, sk.substep_vjp.launches)
    tq, tqd = sk.substep_forward(tm, *t[:4], h, H, Hinv)
    tv = sk.substep_vjp(tm, *t[:4], h, H, Hinv, *t[4:])
    assert (sk.substep_forward.launches, sk.substep_vjp.launches) == n
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), rtol=2e-6,
                               atol=2e-5)
    for lab, a, b in zip(("dq", "dqd", "dja", "dma", "dH"), tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-5, err_msg=lab)
    assert float(tv[3].abs().max()) > 0.0



@pytest.fixture(scope="module")
def host(tmp_path_factory):
    env = _snu(37)
    return env, *(build_host_kernel(env.model, k, tmp_path_factory.mktemp(k))
                  for k in ("substep_forward", "substep_vjp")), \
        host_inputs(env, 37, seed=11)


@pytest.mark.parametrize("E", [32, 37])
@pytest.mark.parametrize("rest", [False, True])
def test_kernel_sources_match_plain_on_host(host, E, rest):
    env, _, _, ins = host
    assert sk.active_contacts(env.model, ins[0][..., :E]) >= E
    check_host_kernels(*host, E, rest=rest)


def test_f64_rule_sets_select_boundaries_apart():
    """testing.check_against_f64 with select margins: where a select's
    argument lies within float32 rounding of its boundary (a contact just
    touching, as some settled SNU Humanoid states hold) and the kernel
    alone took its other side, the answer jumps by 10 there; the env is
    counted apart and named with its select and margin. The same jump in an
    env whose selects lie far from their boundaries still fails, and so
    does an error that a float64 answer at a random state within 4 float32
    units of the inputs (the rule this one replaced) would have matched,
    where no select is near its boundary."""
    def fn(x, y):
        return (torch.where(x - 1.0 < 0.0, 10.0, 0.0) + x * y,)

    x = torch.tensor([[1.0, 2.0, 0.5, 3.0]])
    y = torch.tensor([[0.5, 0.25, 1.0, 2.0]])
    exact = fn(x.double(), y.double())[0]
    plain = exact.float()
    # the select x - 1 < 0, in float32 units of x
    margins = {"depth": ((x.double() - 1.0).abs() / (2.0 ** -23 * x.abs()))
               [0]}
    kernel = plain.clone()
    kernel[0, 0] += 10.0
    with pytest.raises(AssertionError, match="vs float64"):
        check_against_f64("no margins", kernel, plain, exact, 2e-4, 1e-5)
    apart = []
    *_, need, at_boundary = check_against_f64(
        "boundary", kernel, plain, exact, 2e-4, 1e-5, margins=margins,
        apart=apart)
    assert (need, at_boundary) == (0.0, 1)
    assert apart == ["boundary env 0: depth at 0 float32 units"]
    kernel[0, 1] += 10.0
    with pytest.raises(AssertionError, match=r"1 envs at a select's "
                       r"boundary\).* in 1 envs, first \[0, 1\].*"
                       r"depth at 4\.19e\+06 float32 units"):
        check_against_f64("fault", kernel, plain, exact, 2e-4, 1e-5,
                          margins=margins)

    # a steep continuous answer at 0: a state 2 float32 units away moves
    # it by 768, as far as a fault in the kernel
    def steep(x):
        return ((x - 3.0) * 2.0 ** 30,)

    x = torch.tensor([[1.0, 3.0]])
    exact = steep(x.double())[0]
    plain = exact.float()
    kernel = plain.clone()
    kernel[0, 1] += 768.0
    neighbour = steep(x.double() * (1.0 + 2.0 ** -22))[0]
    check_against_f64("a neighbour", kernel, plain, neighbour, 2e-4, 1e-5)
    far = {"depth": torch.full((2,), 1e6, dtype=torch.float64)}
    with pytest.raises(AssertionError, match=r"0 envs at a select's "
                       r"boundary\).* first \[0, 1\]"):
        check_against_f64("steep", kernel, plain, exact, 2e-4, 1e-5,
                          margins=far)

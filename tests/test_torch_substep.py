"""The port's articulation substep (diffrl_tpu_torch.sim.articulation_lb and
sim.substep_kernels, the module that holds the cached-substep kernel)
against the JAX package, on the CPU.

- refresh_substep_lb / substep_lb against JAX articulation_lb on Ant at
  E = 8, at tests/test_articulation_lb.py's tolerances (q rtol 2e-5
  atol 2e-6; qd rtol 2e-5 atol 2e-5);
- the kernel wrapper's plain path against the TPU kernel itself,
  pallas_substep.substep_forward_batched in interpret mode, on
  tests/test_pallas.py's pendulum-with-ground model, at that file's
  tolerances (rtol 2e-6; atol 2e-6 on q, 2e-5 on qd);
- the forward simulate against the dflex golden Ant trajectory, at
  tests/test_parity.py's tolerances (atol 1e-5 for 15 steps, 1e-4 for 40);
- the CUDA kernel's source compiled for the host with g++ (CUDA qualifiers
  and syncs defined away; every thread of a block runs one phase before the
  next starts, so a team's lanes are emulated) against substep_lb at the
  kernel's tolerances, at E = 32 (whole blocks of 16 envs) and E = 37 (a
  partial block), so its arithmetic and lane-to-work map are checked where
  no GPU is present;
- the generated tables: level spans, children, contact order and the team
  layout.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffrl_tpu.envs as jenvs
from diffrl_tpu.sim import articulation_lb as jlb
from diffrl_tpu.sim.pallas_substep import substep_forward_batched

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.sim.model import (JOINT_BALL, JOINT_PRISMATIC,
                                        JOINT_REVOLUTE, ModelBuilder)

from _torch_host_kernels import build_host_kernel
from test_pallas import _pendulum_ground

HERE = os.path.dirname(__file__)
QI = (0.0, 0.0, 0.0, 1.0)
H_ANT = 1.0 / 60.0 / 16


@pytest.fixture(scope="module")
def ant():
    jm = jenvs.make("Ant", num_envs=8, MM_caching_frequency=16).model
    tm = tenvs.make("Ant", num_envs=8, MM_caching_frequency=16,
                    device="cpu").model
    return jm, tm


def _ant_inputs(model, E, seed):
    """Env-minor (q [C, E], qd [D, E], joint_act [D, E]) numpy inputs: torso
    heights from 0.3 to 0.8 so ground contacts are active in some envs."""
    rs = np.random.RandomState(seed)
    q = np.tile(np.asarray(model.joint_q_init), (E, 1))
    q = (q + rs.uniform(-0.1, 0.1, q.shape)).astype(np.float32)
    q[:, 1] = rs.uniform(0.3, 0.8, E)
    qd = rs.uniform(-0.5, 0.5, (E, model.dof_count)).astype(np.float32)
    ja = np.zeros((E, model.dof_count), np.float32)
    ja[:, 6:] = rs.uniform(-100.0, 100.0, (E, model.dof_count - 6))
    return [np.ascontiguousarray(x.T) for x in (q, qd, ja)]


def _port_pendulum():
    b = ModelBuilder()
    b.add_articulation()
    l0 = b.add_link(-1, np.array([0.0, 0.4, 0.0, *QI]), axis=(0.0, 0.0, 1.0),
                    type=JOINT_REVOLUTE, limit_lower=-0.5, limit_upper=0.5,
                    limit_ke=20.0, limit_kd=2.0, stiffness=3.0, damping=0.5)
    b.add_shape_capsule(l0, pos=(0.3, 0.0, 0.0), radius=0.08, half_width=0.3,
                        density=500.0, ke=100.0, kd=10.0, kf=10.0, mu=0.5)
    return dataclasses.replace(
        b.finalize(), ground=True,
        gravity=np.array([0.0, -9.81, 0.0], np.float32))


def test_refresh_and_cached_substep_match_jax(ant):
    jm, tm = ant
    q, qd, ja = _ant_inputs(tm, 8, seed=0)
    jq, jqd, jH, jHinv = jax.jit(
        lambda a, b, c: jlb.refresh_substep_lb(jm, a, b, c, None, H_ANT))(
            q, qd, ja)
    tq, tqd, tH, tHinv = tlb.refresh_substep_lb(
        tm, *map(torch.as_tensor, (q, qd, ja)), None, H_ANT)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), rtol=2e-5,
                               atol=2e-5)
    # H and Hinv: relative to the largest entry (reassociated float32 sums)
    for a, b in ((tH, jH), (tHinv, jHinv)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5,
                                   atol=2e-6 * np.abs(b).max())

    jq2, jqd2 = jax.jit(
        lambda a, b, c, H, Hi: jlb.substep_lb(jm, a, b, c, None, H_ANT, H,
                                              Hi))(q, qd, ja, jH, jHinv)
    tq2, tqd2 = tlb.substep_lb(
        tm, *map(torch.as_tensor, (q, qd, ja)), None, H_ANT,
        torch.as_tensor(np.array(jH)), torch.as_tensor(np.array(jHinv)))
    np.testing.assert_allclose(tq2.numpy(), np.asarray(jq2), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(tqd2.numpy(), np.asarray(jqd2), rtol=2e-5,
                               atol=2e-5)


def test_plain_substep_matches_pallas_kernel_interpret():
    jm = _pendulum_ground()
    tm = _port_pendulum()
    E, h = 1024, 1.0 / 60.0 / 4          # the TPU kernel takes E % 1024 == 0
    rs = np.random.RandomState(3)
    q = rs.uniform(-1.3, -0.3, (1, E)).astype(np.float32)
    qd = rs.uniform(-0.5, 0.5, (1, E)).astype(np.float32)
    ja = rs.uniform(-0.5, 0.5, (1, E)).astype(np.float32)
    _, _, H, Hinv = tlb.refresh_substep_lb(
        tm, *map(torch.as_tensor, (q, qd, ja)), None, h)
    jq, jqd = substep_forward_batched(jm, h, jnp.asarray(q), jnp.asarray(qd),
                                      jnp.asarray(ja), None,
                                      jnp.asarray(Hinv.numpy()))
    # on CPU tensors the kernel wrapper runs the plain version
    launches = sk.substep_forward.launches
    tq, tqd = sk.substep_forward(tm, *map(torch.as_tensor, (q, qd, ja)),
                                 None, h, H, Hinv)
    assert sk.substep_forward.launches == launches
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), rtol=2e-6,
                               atol=2e-5)


def test_simulate_matches_dflex_ant_fixture(ant):
    _, tm = ant
    fix = np.load(os.path.join(HERE, "fixtures", "env_ant_mjcf.npz"))
    # the fixture scene keeps the builder's gravity (-9.8), constant torques
    model = dataclasses.replace(
        tm, gravity=np.array([0.0, -9.8, 0.0], np.float32))
    q = torch.as_tensor(model.joint_q_init)[None]
    qd = torch.zeros((1, model.dof_count))
    ja = torch.zeros((1, model.dof_count))
    ja[0, 6:] = torch.as_tensor(40.0 * np.sin(np.arange(8)),
                                dtype=torch.float32)
    traj = []
    for _ in range(fix["joint_q"].shape[0]):
        q, qd = tlb.simulate_batched_lb(model, q, qd, ja, None,
                                        dt=1.0 / 60.0, substeps=16,
                                        mass_matrix_freq=16)
        traj.append(q[0].numpy())
    got = np.stack(traj)
    np.testing.assert_allclose(got[:15], fix["joint_q"][:15], atol=1e-5)
    np.testing.assert_allclose(got, fix["joint_q"], atol=1e-4)


def test_kernel_tables_pack_the_plan(ant):
    _, tm = ant
    header, consts = sk.kernel_tables(tm)
    plan = tlb._plan_for(tm, "cpu")
    L, K = tm.link_count, len(plan.contact_rows)
    assert f"#define DRL_NL {L}" in header
    assert f"#define DRL_NK {K}" in header
    assert "#define DRL_PARENT {-1, 0, 0, 0, 0, 1, 2, 3, 4}" in header
    links = consts[:L * 34].reshape(L, 34)
    np.testing.assert_array_equal(links[:, 0:7], plan.X_pj.numpy()[:, :, 0])
    np.testing.assert_array_equal(links[:, 7:14], plan.X_cm.numpy()[:, :, 0])
    np.testing.assert_array_equal(links[:, 26], plan.m.numpy()[:, 0, 0])
    np.testing.assert_array_equal(consts[L * 34:L * 34 + 3], tm.gravity)
    assert consts.size == L * 34 + 3 + K * 8
    contacts = consts[L * 34 + 3:].reshape(K, 8)
    np.testing.assert_array_equal(contacts[:, 4:8], tm.contact_mat)
    # one launch at E = 4096 moves (15 + 14 + 14 + 196 + 15 + 14) floats
    # per env plus the constants
    assert sk.substep_forward_bytes(tm, 4096) == \
        4 * (4096 * 268 + consts.size)


def test_kernel_rejects_unsupported_models():
    b = ModelBuilder()
    b.add_articulation()
    b.add_link(-1, np.array([0.0, 1.0, 0.0, *QI]), axis=(0.0, 0.0, 1.0),
               type=JOINT_BALL)
    with pytest.raises(NotImplementedError, match="joint types"):
        sk.kernel_tables(b.finalize())
    b = ModelBuilder()
    b.add_articulation()
    l0 = b.add_link(-1, np.array([0.0, 1.0, 0.0, *QI]), axis=(0.0, 0.0, 1.0),
                    type=JOINT_PRISMATIC)
    b.add_muscle([l0, l0], [np.zeros(3), np.ones(3)], f0=1.0, lm=0.3,
                 lt=0.1, lmax=0.5, pen=0.0)
    with pytest.raises(NotImplementedError, match="muscles"):
        sk.kernel_tables(b.finalize())
    with pytest.raises(ValueError, match="CUDA"):
        sk.prepare_substep_forward(_port_pendulum(), "cpu")


# ---------------------------------------------------------------------------
# the CUDA source, compiled for the host

def _header_tables(header):
    """{name: int or [int]} of the generated header's #defines."""
    out = {}
    for line in header.splitlines():
        if line.startswith("#define DRL_"):
            _, name, val = line.split(" ", 2)
            out[name[4:]] = ([int(x) for x in val.strip("{}").split(",")]
                             if val.startswith("{") else int(val))
    return out


def assert_table_invariants(tm):
    """The level spans, children and contact lists the kernels sweep by,
    against the engine plan; returns the header's tables."""
    header, _ = sk.kernel_tables(tm)
    plan = tlb._plan_for(tm, "cpu")
    t = _header_tables(header)
    L = t["NL"]
    starts = t["LEVEL_START"]
    assert len(starts) == t["NLEV"] + 1 and starts[0] == 0 and \
        starts[-1] == L
    assert [(a, b) for a, b in zip(starts, starts[1:])] == list(plan.levels)
    level = np.zeros(L, np.int64)
    for lv, (a, b) in enumerate(zip(starts, starts[1:])):
        assert a < b
        level[a:b] = lv
    # every link in exactly one span; each parent's level before its child's
    assert np.bincount(level, minlength=t["NLEV"]).sum() == L
    parent = t["PARENT"]
    for r in range(L):
        assert parent[r] < 0 or level[parent[r]] == level[r] - 1
    # children: descending rows, exactly the links whose parent is r
    cs, ch = t["CHILD_START"], t["CHILDREN"]
    for r in range(L):
        assert ch[cs[r]:cs[r + 1]] == [c for c in range(L - 1, -1, -1)
                                       if parent[c] == r]
    # contacts: the plan's contact-to-link order, ascending per link
    assert t["CONTACT_ROW"] == plan.contact_rows.tolist()
    ks, kl = t["LINK_CONTACT_START"], t["LINK_CONTACTS"]
    assert ks[-1] == t["NK"] == len(plan.contact_rows)
    for r in range(L):
        assert kl[ks[r]:ks[r + 1]] == np.nonzero(
            plan.contact_rows == r)[0].tolist()
    assert t["NCHILD"] == len(ch) == cs[-1] == sum(p >= 0 for p in parent)
    return t


def test_kernel_tables_team_layout(ant):
    """The level spans, children and contact lists the kernels sweep by,
    and the team size and shared-memory slots the header states."""
    _, tm = ant
    t = assert_table_invariants(tm)
    # Ant: levels of 1, 4 and 4 links, 14 dofs: T = 8, 16 envs per
    # 128-thread block
    lay = sk.team_layout(tm)
    assert (t["T"], t["BLOCK_THREADS"]) == (lay.threads_per_env,
                                            lay.block_threads) == (8, 128)
    assert lay.envs_per_block == 16
    assert (t["FWD_ENV_WORDS"], t["VJP_ENV_WORDS"]) == (
        lay.forward_words, lay.vjp_words) == (697, 1571)
    _, consts = sk.kernel_tables(tm)
    assert lay.const_words == consts.size
    assert lay.smem_bytes("substep_forward") == (16 * 697 + consts.size) * 4
    assert lay.smem_bytes("substep_vjp") == (16 * 1571 + consts.size) * 4
    # the pendulum: one link, the smallest team (8 lanes, so that 4096
    # envs still give every SM of an H100 several warps)
    pl = sk.team_layout(_port_pendulum())
    assert (pl.threads_per_env, pl.envs_per_block) == (8, 16)


@pytest.fixture(scope="module")
def host_forward(ant, tmp_path_factory):
    return build_host_kernel(ant[1], "substep_forward",
                             tmp_path_factory.mktemp("forward"))


@pytest.mark.parametrize("E", [32, 37])
def test_kernel_source_matches_plain_on_host(ant, host_forward, E):
    _, tm = ant
    q, qd, ja = _ant_inputs(tm, E, seed=5)
    tq, tqd, tja = map(torch.as_tensor, (q, qd, ja))
    q1, qd1, H, Hinv = tlb.refresh_substep_lb(tm, tq, tqd, tja, None, H_ANT)
    want_q, want_qd = tlb.substep_lb(tm, q1, qd1, tja, None, H_ANT, H, Hinv)
    got_q, got_qd = host_forward(*(x.numpy() for x in (q1, qd1, tja, Hinv)),
                                 dt=H_ANT)
    np.testing.assert_allclose(got_q, want_q.numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_qd, want_qd.numpy(), rtol=2e-5, atol=2e-5)

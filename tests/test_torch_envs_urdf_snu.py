"""The port's CartPole (URDF) and SNU Humanoid (SNU XML, muscles) against
the JAX package's, on the CPU: the importers' models, the kernel tables,
the batched hooks, the registry and the SHAC networks.

- Model field by field (topology exactly, arrays to atol 1e-7: both the
  same float64 host math rounded to float32) and the engine plan's tables,
  the muscle segments included, from each package's own copy of the
  assets (the copies must be equal); the SNU importer's muscles (names,
  peak forces, links) as well;
- the generated kernel tables: sizes, level widths, motion-subspace
  columns, team layout and shared memory per block; the muscle tables
  (each segment's rows and muscle, each muscle's segment span, each link's
  segment ends in the plain version's index_add_ order) and the segment
  points at the end of the constants; the bounds' byte counts (every
  [k, E] array once, the muscle activations and their cotangent
  included);
- the hooks (action_to_controls, observations, reward, termination, the
  invalid mask) on injected states against the JAX env's hooks vmapped
  over the batch, at rtol/atol 1e-6 (the same float32 operations), the
  torque variant of SNU Humanoid too;
- the registry and sizes (CartPole 5 obs / 1 action; SNU Humanoid 53 obs
  / 152 muscle actions, or 71 / 18 with torques);
- the mesh reader against JAX's on an OBJ and an STL file, and the URDF
  importer's mesh collider read through it (tests/test_torch_builder.py
  holds the collider's Model against JAX's);
- SHAC from examples/cfg/shac/{cartpole_swing_up,snu_humanoid}.yaml:
  actor 5-64-64-1 and 53-512-256-152, critic 5-64-64-1 and 53-256-256-1,
  ELU with LayerNorm on the hidden layers as the JAX package builds them;
  outputs equal to the JAX networks' on the same weights (through
  utils/convert.py) at rtol/atol 1e-5.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import diffrl_tpu.envs as jenvs
from diffrl_tpu.models import ActorStochasticMLP as JActor
from diffrl_tpu.models import CriticMLP as JCritic
from diffrl_tpu.sim import articulation_lb as jlb
from diffrl_tpu.sim.importers import meshio as jmeshio

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.algorithms import SHAC
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.sim.importers import meshio as tmeshio
from diffrl_tpu_torch.sim.importers.urdf import urdf_load
from diffrl_tpu_torch.sim.model import GEO_MESH, ModelBuilder, \
    np_transform_identity
from diffrl_tpu_torch.utils.convert import load_params

from _torch_scenes import assert_models_equal
from test_torch_substep import _header_tables, assert_table_invariants

HERE = os.path.dirname(__file__)
NAMES = ["CartPoleSwingUp", "SNUHumanoid"]
ASSETS = {"CartPoleSwingUp": ["cartpole.urdf"],
          "SNUHumanoid": ["snu/human.xml", "snu/muscle284.xml",
                          "licenses/snu-LICENSE.txt"]}
MM = {"CartPoleSwingUp": 4, "SNUHumanoid": 8}


def envs(name, E, **kw):
    kw = dict(num_envs=E, MM_caching_frequency=MM[name], **kw)
    return jenvs.make(name, **kw), tenvs.make(name, device="cpu", **kw)


@pytest.mark.parametrize("name", NAMES)
def test_model_fields_match_jax(name):
    j = os.path.join(HERE, "..", "diffrl_tpu", "envs", "assets")
    t = os.path.join(HERE, "..", "diffrl_tpu_torch", "envs", "assets")
    for f in ASSETS[name]:
        assert filecmp.cmp(os.path.join(j, f), os.path.join(t, f),
                           shallow=False), f
    je, te = envs(name, 2)
    jm, tm = je.model, te.model
    # every field: topology and scalars exactly, arrays to atol
    assert_models_equal(tm, jm, 1e-7)
    jp, tp = jlb._plan_for(jm), tlb._plan_for(tm, "cpu")
    for key in ("order", "parent_row", "subtree", "dof_perm", "coord_perm",
                "anc_pair", "contact_rows", "seg_row0", "seg_row1", "seg_m"):
        np.testing.assert_array_equal(getattr(tp, key), getattr(jp, key),
                                      err_msg=key)
    assert tp.levels == jp.levels
    for key in ("seg_r0", "seg_r1"):
        np.testing.assert_array_equal(getattr(tp, key).numpy(),
                                      np.asarray(getattr(jp, key)))
    if name == "SNUHumanoid":
        jmus, tmus = je.skeleton.muscles, te.skeleton.muscles
        assert [(m.name, m.peak_force, m.links) for m in tmus] == [
            (m.name, m.peak_force, m.links) for m in jmus]
        assert te.skeleton.links == je.skeleton.links


# (links, coords, dofs, contacts, level widths, motion-subspace columns,
# muscles, segments, shared memory per block of K1 and of K2): every
# model gets a team of 8 lanes; SNU Humanoid's adjoint block of 230 KB
# (231,136 B with the int tables) fits the card's 227 KiB
LAYOUT = {
    "CartPoleSwingUp": (3, 2, 2, 0, [1, 1, 1], 3, 0, 0, 7268, 17764),
    "SNUHumanoid": (11, 29, 24, 88, [1, 2, 2, 2, 4], 18, 152, 198, 107556,
                    230052),
}


@pytest.mark.parametrize("name", NAMES)
def test_kernel_tables_and_team_layout(name):
    tm = envs(name, 2)[1].model
    t = assert_table_invariants(tm)
    L, C, D, K, widths, NS, M, NSEG, fwd, vjp = LAYOUT[name]
    assert (t["NL"], t["NC"], t["ND"], t["NK"], t["NS"], t["NM"],
            t["NSEG"]) == (L, C, D, K, NS, M, NSEG)
    starts = t["LEVEL_START"]
    assert [b - a for a, b in zip(starts, starts[1:])] == widths
    # the root: CartPole's fixed slide bar, SNU Humanoid's free pelvis
    assert t["PARENT"][0] == -1 and t["TYPE"][0] == (
        3 if name == "CartPoleSwingUp" else 4)
    # each link's first motion-subspace column: with a ball joint 1 per
    # scalar joint and 3 per ball joint, without one 1 per link
    cols = [{0: 1, 1: 1, 2: 3}.get(ty, 0) if 2 in t["TYPE"] else 1
            for ty in t["TYPE"]]
    assert t["SSTART"] == np.cumsum([0] + cols)[:-1].tolist()
    lay = sk.team_layout(tm)
    assert (lay.threads_per_env, lay.envs_per_block, t["T"]) == (8, 16, 8)
    assert (lay.smem_bytes("substep_forward"),
            lay.smem_bytes("substep_vjp")) == (fwd, vjp)
    assert vjp + 4 * (7 * L + 2 * max(K, 1) + (L - 1) + 2 + len(widths)
                      + 1) <= 232448
    # the muscle tables against the engine plan
    plan = tlb._plan_for(tm, "cpu")
    _, consts = sk.kernel_tables(tm)
    if NSEG:
        assert t["SEG_ROW0"] == plan.seg_row0.tolist()
        assert t["SEG_ROW1"] == plan.seg_row1.tolist()
        assert t["SEG_M"] == plan.seg_m.tolist()
        ms = t["MUSCLE_SEG_START"]
        assert len(ms) == M + 1 and ms[-1] == NSEG
        for m in range(M):
            assert all(x == m for x in t["SEG_M"][ms[m]:ms[m + 1]])
        es, ends = t["LINK_END_START"], t["LINK_ENDS"]
        assert es[-1] == len(ends) == 2 * NSEG
        for r in range(L):
            want = [2 * k for k in np.nonzero(plan.seg_row0 == r)[0]] + [
                2 * k + 1 for k in np.nonzero(plan.seg_row1 == r)[0]]
            assert ends[es[r]:es[r + 1]] == want
        segs = consts[lay.const_words:].reshape(NSEG, 6)
        np.testing.assert_array_equal(segs[:, 0:3],
                                      plan.seg_r0.numpy()[:, :, 0])
        np.testing.assert_array_equal(segs[:, 3:6],
                                      plan.seg_r1.numpy()[:, :, 0])
    assert consts.size == lay.const_words + 6 * NSEG
    # the bounds: every [k, E] array once, the activations (K1, K2) and
    # their cotangent (K2) included; more operations for the adjoint
    E = 4096
    assert sk.substep_forward_bytes(tm, E) == 4 * (
        E * (2 * C + 3 * D + M + D * D) + consts.size)
    assert sk.substep_vjp_bytes(tm, E) == 4 * (
        E * (3 * C + 5 * D + 2 * M + 2 * D * D) + consts.size)
    assert sk.substep_vjp_flops(tm, E, 0) > sk.substep_forward_flops(tm, E)


def _hooks(env, q, qd, acts):
    ja, ma = env.action_to_controls(acts)
    obs = env.observations(q, qd, acts)
    return ja, ma, obs, env.reward(obs, acts), env.termination(obs), \
        env.invalid_mask(obs, q, qd)


@pytest.mark.parametrize("name,mtu", [("CartPoleSwingUp", True),
                                      ("SNUHumanoid", True),
                                      ("SNUHumanoid", False)])
def test_hooks_match_jax(name, mtu):
    """The batched hooks against the JAX env's per-env hooks, vmapped, on
    16 states: perturbed start poses, fast; on SNU Humanoid some below the
    termination height, and two carry a NaN and a huge velocity."""
    E = 16
    kw = {} if name == "CartPoleSwingUp" else {"mtu_actuations": mtu}
    je, te = envs(name, E, **kw)
    m = te.model
    rs = np.random.RandomState(7)
    q = (np.tile(m.joint_q_init, (E, 1))
         + rs.uniform(-0.6, 0.6, (E, m.coord_count))).astype(np.float32)
    qd = rs.uniform(-5.0, 5.0, (E, m.dof_count)).astype(np.float32)
    acts = rs.uniform(-1.0, 1.0, (E, te.num_acts)).astype(np.float32)
    if name == "SNUHumanoid":
        q[:, 1] = rs.uniform(0.2, 1.2, E)
        qd[3, 5] = np.nan
        q[4, 9] = 2e6
    jf = jax.jit(jax.vmap(lambda a, b, c: _hooks(je, a, b, c)))
    want = jf(q, qd, acts)
    got = _hooks(te, *(torch.as_tensor(x) for x in (q, qd, acts)))
    for lab, a, b in zip(("joint_act", "muscle_act", "obs", "reward",
                          "termination", "invalid"), got, want):
        if a is None:
            assert b is None, lab
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} {lab}")
    if te.early_termination:
        assert bool(got[4].any()) and not bool(got[4].all())
    else:               # CartPole: no termination hook
        assert not bool(got[4].any())
    assert bool(got[5].any()) == (name == "SNUHumanoid")
    assert te.zero_reward_on_invalid() == je.zero_reward_on_invalid()


def test_registry_and_sizes():
    for name in NAMES:
        je, te = envs(name, 2)
        assert type(tenvs.make(f"{name}Env", num_envs=2, device="cpu")) is \
            type(te)
        assert (te.num_obs, te.num_acts, te.sim_substeps, te.dt,
                te.episode_length, te.early_termination) == (
            je.num_obs, je.num_acts, je.sim_substeps, je.dt,
            je.episode_length, je.early_termination)
    assert [envs(n, 2)[1].num_obs for n in NAMES] == [5, 53]
    assert [envs(n, 2)[1].num_acts for n in NAMES] == [1, 152]
    je, te = envs("SNUHumanoid", 2, mtu_actuations=False)
    assert (te.num_obs, te.num_acts) == (je.num_obs, je.num_acts) == (71, 18)
    assert te.model.topology.muscle_count == 0
    # SNU Humanoid: each muscle's strength is its peak force times the
    # strength scale twice, as in the JAX env
    te = envs("SNUHumanoid", 2)[1]
    np.testing.assert_allclose(
        te.muscle_strengths.numpy(),
        [0.36 * m.peak_force for m in te.skeleton.muscles], rtol=1e-6)


def test_mesh_reader_matches_jax(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"
                   "f 1/1/1 -2/1/1 -1//1\n")
    stl = tmp_path / "tri.stl"
    stl.write_text("solid t\nfacet normal 0 0 1\nouter loop\n"
                   "vertex 0 0 0\nvertex 1 0 0\nvertex 0 1 0\nendloop\n"
                   "endfacet\nendsolid t\n")
    for path in (obj, stl):
        for a, b in zip(tmeshio.load_mesh(str(path)),
                        jmeshio.load_mesh(str(path))):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    urdf = tmp_path / "mesh.urdf"
    urdf.write_text(
        '<robot name="m"><link name="base"><collision><geometry>'
        f'<mesh filename="{obj}"/></geometry></collision></link></robot>')
    b = ModelBuilder()
    urdf_load(b, str(urdf), np_transform_identity())
    assert b.shape_geo_type == [GEO_MESH]
    np.testing.assert_array_equal(b.shape_geo_src[0].vertices,
                                  jmeshio.load_mesh(str(obj))[0])


@pytest.mark.parametrize("name,cfg_file,dims", [
    ("CartPoleSwingUp", "cartpole_swing_up.yaml",
     ([5, 64, 64, 1], [5, 64, 64, 1])),
    ("SNUHumanoid", "snu_humanoid.yaml",
     ([53, 512, 256, 152], [53, 256, 256, 1]))])
def test_shac_config_networks(tmp_path, name, cfg_file, dims):
    with open(os.path.join(HERE, "..", "examples", "cfg", "shac",
                           cfg_file)) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(tmp_path), "seed": 0}
    cfg["params"]["config"].update(num_actors=2, save_interval=0)
    tt = SHAC(cfg, device="cpu")
    assert type(tt.env).__name__ == f"{name}Env"
    assert tt.env.mm_caching_frequency == MM[name]
    n_obs, n_act = dims[0][0], dims[0][-1]
    assert (tt.num_obs, tt.num_actions) == (n_obs, n_act)
    for net, d in ((tt.actor.mu_net, dims[0]), (tt.critic.critic_net,
                                                 dims[1])):
        assert net.layer_dims == d and net.activation == "elu"
        assert len(net.norms) == len(d) - 2
    network = cfg["params"]["network"]
    key = jax.random.PRNGKey(3)
    obs = np.random.RandomState(0).normal(size=(5, n_obs)).astype(
        np.float32)
    for jnet, tnet, f in (
            (JActor(n_obs, n_act, network), tt.actor,
             lambda n, p, o: n(p, o, deterministic=True)),
            (JCritic(n_obs, network), tt.critic, lambda n, p, o: n(p, o))):
        params = jnet.init(key)
        load_params(tnet, jax.device_get(params))
        with torch.no_grad():
            got = (tnet(torch.as_tensor(obs), deterministic=True)
                   if tnet is tt.actor else tnet(torch.as_tensor(obs)))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(f(jnet, params, jnp.asarray(
                                       obs))), rtol=1e-5, atol=1e-5)
    t = _header_tables(sk.kernel_tables(tt.env.model)[0])
    assert t["NM"] == tt.env.model.topology.muscle_count

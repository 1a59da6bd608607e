"""The port's MJCF envs, Humanoid, Hopper and Cheetah, against the JAX
package's, on the CPU: their models and kernel tables, their batched hooks,
the SHAC Humanoid config's networks and the dflex golden Humanoid
trajectory.

- Model field by field (topology exactly, arrays to atol 1e-7, both the
  same float64 host math rounded to float32) and the engine plan's tables,
  from each package's own copy of the asset (the copies must be equal);
- the generated kernel tables: the sizes, level widths, team layout and
  shared memory per block of each model, and the tables' invariants;
- the hooks (action_to_controls, observations, reward, termination, the
  Humanoid's invalid mask) on injected states against the JAX env's hooks
  vmapped over the batch, at rtol/atol 1e-6 (the same float32 operations);
- the registry, sizes and flags of each env;
- SHAC from examples/cfg/shac/humanoid.yaml: actor 76-256-128-21 and
  critic 76-128-128-1, ELU with LayerNorm on the hidden layers as the JAX
  package builds them (the config has no layer-norm switch; both packages
  put it on every hidden layer), target_critic_alpha 0.995; outputs equal
  to the JAX networks' on the same weights at rtol/atol 1e-5;
- the plain path against tests/fixtures/env_humanoid_mjcf.npz (16 steps of
  48 substeps, mm 48) at tests/test_parity.py's bands for Humanoid (atol
  1e-4 for 15 steps, 1e-3 for all).
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffrl_tpu.models import ActorStochasticMLP as JActor
from diffrl_tpu.models import CriticMLP as JCritic
from diffrl_tpu.sim import articulation_lb as jlb

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.algorithms import SHAC
from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch.utils.convert import load_params

from _torch_mjcf import SUBSTEPS, contact_inputs, envs
from test_torch_substep import assert_table_invariants

HERE = os.path.dirname(__file__)
NAMES = ["Humanoid", "Hopper", "Cheetah"]
ASSETS = {"Humanoid": "humanoid.xml", "Hopper": "hopper.xml",
          "Cheetah": "half_cheetah.xml"}


@pytest.mark.parametrize("name", NAMES)
def test_model_fields_match_jax(name):
    j = os.path.join(HERE, "..", "diffrl_tpu", "envs", "assets")
    t = os.path.join(HERE, "..", "diffrl_tpu_torch", "envs", "assets")
    assert filecmp.cmp(os.path.join(j, ASSETS[name]),
                       os.path.join(t, ASSETS[name]), shallow=False)
    je, te = envs(name, 2)
    jm, tm = je.model, te.model
    assert dataclasses.asdict(tm.topology) == dataclasses.asdict(jm.topology)
    assert tm.ground == jm.ground
    for f in dataclasses.fields(tm):
        if f.name in ("topology", "ground"):
            continue
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if a is None:
            assert b is None, f.name
            continue
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=f.name)
    jp, tp = jlb._plan_for(jm), tlb._plan_for(tm, "cpu")
    for key in ("order", "parent_row", "subtree", "dof_perm", "coord_perm",
                "anc_pair", "contact_rows"):
        np.testing.assert_array_equal(getattr(tp, key), getattr(jp, key),
                                      err_msg=key)
    assert tp.levels == jp.levels


# (links, coords, dofs, contacts, level widths, team, envs per block,
# shared memory per block of K1 and of K2): every model gets the smallest
# team of 8 lanes; Humanoid's adjoint block of 228 KB just fits the card
LAYOUT = {
    "Humanoid": (22, 28, 27, 35, [1, 3, 3, 3, 2, 2, 2, 2, 2, 2], 8, 16,
                 116572, 228316),
    "Hopper": (6, 6, 6, 8, [1, 1, 1, 1, 1, 1], 8, 16, 20348, 48892),
    "Cheetah": (9, 9, 9, 16, [1, 1, 1, 2, 2, 2], 8, 16, 33812, 80020),
}


@pytest.mark.parametrize("name", NAMES)
def test_kernel_tables_and_team_layout(name):
    tm = envs(name, 2)[1].model
    t = assert_table_invariants(tm)
    L, C, D, K, widths, T, epb, fwd, vjp = LAYOUT[name]
    assert (t["NL"], t["NC"], t["ND"], t["NK"]) == (L, C, D, K)
    starts = t["LEVEL_START"]
    assert [b - a for a, b in zip(starts, starts[1:])] == widths
    # a root with parent -1: the free torso, or the planar base's slide
    assert t["PARENT"][0] == -1 and t["TYPE"][0] == (
        4 if name == "Humanoid" else 0)
    lay = sk.team_layout(tm)
    assert (lay.threads_per_env, lay.envs_per_block, t["T"]) == (T, epb, T)
    assert (lay.smem_bytes("substep_forward"),
            lay.smem_bytes("substep_vjp")) == (fwd, vjp)
    # the bounds count the model's own sizes: every [k, E] array once, and
    # more operations than the forward for the adjoint
    E = 4096
    assert sk.substep_forward_bytes(tm, E) == 4 * (
        E * (2 * C + 3 * D + D * D) + lay.const_words)
    assert sk.substep_vjp_bytes(tm, E) == 4 * (
        E * (3 * C + 5 * D + 2 * D * D) + lay.const_words)
    assert sk.substep_vjp_flops(tm, E, 0) > sk.substep_forward_flops(tm, E)


def _hooks(env, q, qd, acts):
    ja, ma = env.action_to_controls(acts)
    obs = env.observations(q, qd, acts)
    return ja, obs, env.reward(obs, acts), env.termination(obs), \
        env.invalid_mask(obs, q, qd)


@pytest.mark.parametrize("name", NAMES)
def test_hooks_match_jax(name):
    """The batched hooks against the JAX env's per-env hooks, vmapped, on
    16 states: perturbed start poses, some below the ground and the
    termination height; on Humanoid two carry a NaN and a huge velocity
    (the invalid mask)."""
    E = 16
    je, te = envs(name, E)
    q, qd, acts, _ = contact_inputs(name, te, E, seed=7, drop=(-0.9, 0.1))
    qd *= 10.0
    if name == "Humanoid":
        qd[3, 5] = np.nan
        q[4, 9] = 2e6
    jf = jax.jit(jax.vmap(lambda a, b, c: _hooks(je, a, b, c)))
    want = jf(q, qd, acts)
    got = _hooks(te, *(torch.as_tensor(x) for x in (q, qd, acts)))
    for lab, a, b in zip(("joint_act", "obs", "reward", "termination",
                          "invalid"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} {lab}")
    if te.early_termination:
        assert bool(got[3].any()) and not bool(got[3].all())
    else:               # Cheetah: no termination hook
        assert not bool(got[3].any())
    assert bool(got[4].any()) == (name == "Humanoid")
    assert te.zero_reward_on_invalid() == je.zero_reward_on_invalid()


def test_registry_and_sizes():
    for name in NAMES:
        je, te = envs(name, 2)
        assert type(tenvs.make(f"{name}Env", num_envs=2, device="cpu")) is \
            type(te)
        assert (te.num_obs, te.num_acts, te.sim_substeps, te.dt) == (
            je.num_obs, je.num_acts, je.sim_substeps, je.dt)
        assert te.early_termination == je.early_termination
        assert te.sim_substeps == SUBSTEPS[name]
    assert [envs(n, 2)[1].num_obs for n in NAMES] == [76, 11, 17]
    assert [envs(n, 2)[1].num_acts for n in NAMES] == [21, 3, 6]
    assert not envs("Cheetah", 2)[1].early_termination


def test_shac_humanoid_config_networks(tmp_path):
    with open(os.path.join(HERE, "..", "examples", "cfg", "shac",
                           "humanoid.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(tmp_path), "seed": 0}
    cfg["params"]["config"].update(num_actors=2, save_interval=0)
    tt = SHAC(cfg, device="cpu")
    assert type(tt.env).__name__ == "HumanoidEnv"
    assert (tt.env.sim_substeps, tt.env.mm_caching_frequency) == (48, 48)
    assert (tt.num_obs, tt.num_actions) == (76, 21)
    assert tt.target_critic_alpha == 0.995 and tt.use_obs_rms
    for net, dims in ((tt.actor.mu_net, [76, 256, 128, 21]),
                      (tt.critic.critic_net, [76, 128, 128, 1])):
        assert net.layer_dims == dims and net.activation == "elu"
        assert len(net.norms) == len(dims) - 2
    # the same weights give the same outputs as the JAX networks
    network = cfg["params"]["network"]
    key = jax.random.PRNGKey(3)
    obs = np.random.RandomState(0).normal(size=(5, 76)).astype(np.float32)
    for jnet, tnet, f in (
            (JActor(76, 21, network), tt.actor,
             lambda n, p, o: n(p, o, deterministic=True)),
            (JCritic(76, network), tt.critic, lambda n, p, o: n(p, o))):
        params = jnet.init(key)
        assert [layer["w"].shape for layer in params["mlp"]] == [
            (b, a) for a, b in zip(jnet.layer_dims, jnet.layer_dims[1:])]
        load_params(tnet, jax.device_get(params))
        with torch.no_grad():
            got = (tnet(torch.as_tensor(obs), deterministic=True)
                   if tnet is tt.actor else tnet(torch.as_tensor(obs)))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(f(jnet, params, jnp.asarray(
                                       obs))), rtol=1e-5, atol=1e-5)


def test_humanoid_fixture_plain_path():
    """The dflex golden Humanoid: the fixture scene keeps the builder's
    gravity (-9.8) and constant torques 25 sin(i) on the 21 hinges."""
    tm = envs("Humanoid", 1)[1].model
    fix = np.load(os.path.join(HERE, "fixtures", "env_humanoid_mjcf.npz"))
    model = dataclasses.replace(
        tm, gravity=np.array([0.0, -9.8, 0.0], np.float32))
    q = torch.as_tensor(model.joint_q_init)[None]
    qd = torch.zeros((1, model.dof_count))
    ja = torch.zeros((1, model.dof_count))
    ja[0, 6:] = torch.as_tensor(25.0 * np.sin(np.arange(21)),
                                dtype=torch.float32)
    traj = []
    for _ in range(fix["joint_q"].shape[0]):
        q, qd = tlb.simulate_batched_lb(model, q, qd, ja, None,
                                        dt=1.0 / 60.0, substeps=48,
                                        mass_matrix_freq=48)
        traj.append(q[0].numpy())
    got = np.stack(traj)
    np.testing.assert_allclose(got[:15], fix["joint_q"][:15], atol=1e-4)
    np.testing.assert_allclose(got, fix["joint_q"], atol=1e-3)

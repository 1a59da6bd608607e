"""The cached-substep CUDA kernels and the mass matrix's adjoint kernel
against their plain versions, on the GPU.

These tests need a CUDA device and nvcc; without them they skip. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the forward kernel at q rtol 2e-5 atol 2e-6, qd rtol 2e-5
atol 2e-5 (one substep; float32 sums taken in another order than the plain
version). The adjoint kernel by the rules of diffrl_tpu_torch/testing.py:
rtol 2e-4 and atol 1e-5 in units of each env's largest cotangent entry
(check_vjp), and entry by entry no further from the float64 plain version
than twice the float32 plain version's error plus rtol and 8 times the
plain version's largest error in that env (check_against_f64), an env
that breaks this while one of its named selects lies within
testing.SELECT_ULPS float32 units of its boundary being at that boundary,
counted apart and printed with the select and its margin
(articulation_lb.select_margins). A failing kernel check leaves a witness
of the failing env under build/witness/ and names it
(tools/replay_witness.py replays it on the CPU).

Both kernels are checked at E = 4096 (the main path), 1000 (a partial last
block) and 1 (one env in a block of 16); two launches on the same inputs
must give the same bits (no atomics); and at E = 4096 each kernel keeps at
least 4 warps resident per SM. On Humanoid, Hopper, Cheetah, CartPole and
SNU Humanoid both kernels are held at E = 4096 on a settled state with
contacts active (CartPole has no ground; SNU Humanoid's 152 muscles at
activations in (0, 1) x strength, their cotangent dma held as well),
against float64 by the rules of diffrl_tpu_torch/testing.py (check_kernel;
on Humanoid with its floor: a q', qd' or dH entry there inherits the
float32 error of a 27-term sum whose terms are about 100 times it), with
the occupancy and spill checks.

The mass matrix's adjoint kernel (K3) is held on all six models at E =
4096 (Ant also at 1000 and 1) on a settled state, with a random cotangent
of H and a random dq to add to, against its plain version and float64 by
the same rule (check_kernel, rtol 2e-4, atol 1e-5, each model's floor); it
counts one launch a call, two launches give the same bits, and it keeps at
least 4 warps resident per SM without spills.

The plain path (refresh, cached substep and both VJPs) gives the same bits
twice on the same inputs at E = 4096 on Ant, Humanoid and SNU Humanoid
(testing.check_repeatable); a kernel check that fails on an injected off
entry leaves a witness that replays; a SHAC epoch on Ant (64 envs x 32
steps of 16 substeps, the mass matrix refreshed once a step) launches the
forward kernel on each cached substep, the adjoint kernel on each substep
(the refresh's VJP takes one too) and the mass matrix's adjoint once a
step; and a PPO and a SAC epoch on Ant launch the forward kernel once per
cached substep and neither adjoint kernel.
"""

import os
import sys

import pytest
import torch

import diffrl_tpu_torch.envs as envs
from diffrl_tpu_torch.sim import articulation_lb as lb
from diffrl_tpu_torch.sim import substep_kernels as sk
from diffrl_tpu_torch import testing
from diffrl_tpu_torch.testing import (check_against_f64, check_kernel,
                                     check_repeatable, check_vjp, f64_floor)
from diffrl_tpu_torch.testing import substep_witness as _witness

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("E", [4096, 1000, 1])
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
        again = sk.substep_forward(env.model, q1, qd1, ja, None, h, H, Hinv)
    torch.cuda.synchronize()
    torch.testing.assert_close(kq, pq, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(kqd, pqd, rtol=2e-5, atol=2e-5)
    assert torch.equal(kq, again[0]) and torch.equal(kqd, again[1])


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


def _settled(env, steps=14):
    s = env.reset()
    zero = torch.zeros((env.num_envs, env.num_acts), device=env.device)
    with torch.no_grad():
        for _ in range(steps):
            s, *_ = env.step(s, zero)
    return s


@pytest.mark.parametrize("E", [4096, 1000, 1])
def test_vjp_kernel_matches_plain(cuda, E):
    env = envs.make("Ant", num_envs=E, stochastic_init=True,
                    MM_caching_frequency=16, device=cuda)
    s = _settled(env)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    acts = torch.rand((E, env.num_acts), generator=g, device=cuda) * 2 - 1
    ja = env.action_to_controls(acts)[0].T.contiguous()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(env.model, q, qd, ja, None,
                                                 h)
    assert sk.active_contacts(env.model, q1) >= E
    gq = torch.randn(q1.shape, generator=g, device=cuda)
    gqd = torch.randn(qd1.shape, generator=g, device=cuda)
    args = (env.model, q1, qd1, ja, None, h, H, Hinv, gq, gqd)
    n = sk.substep_vjp.launches
    got = sk.substep_vjp(*args)
    assert sk.substep_vjp.launches == n + 1 and got[3] is None
    want = lb.substep_vjp_lb(*args)
    exact = lb.substep_vjp_lb(env.model, *(t.double() for t in args[1:4]),
                              None, h, *(t.double() for t in args[6:]))
    margins = lb.select_margins(env.model, q1, qd1)
    again = sk.substep_vjp(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[:3] + got[4:], again[:3] + again[4:]):
        assert torch.equal(a, b)
    for i, lab in ((0, "dq"), (1, "dqd"), (2, "djoint_act"), (4, "dH")):
        w = _witness("Ant", "substep_vjp", i, args)
        check_vjp(lab, got[i], want[i], 2e-4, 1e-5, witness=w)
        apart = []
        check_against_f64(lab, got[i], want[i], exact[i], 2e-4, 1e-5,
                          margins=margins, witness=w, apart=apart)
        print(f"{lab}: {len(apart)} envs at a select's boundary", *apart,
              sep="\n")


@pytest.mark.parametrize("name", ["substep_forward", "substep_vjp",
                                  "mass_matrix_vjp"])
def test_kernel_occupancy(cuda, name):
    """At the main path's 4096 envs each kernel keeps at least 4 warps
    resident per SM (the card's occupancy query and the grid), with the
    team layout the tables state and no spills (the only local memory is
    the stack frame of sinf/cosf's reduction of huge arguments)."""
    env = envs.make("Ant", num_envs=8, MM_caching_frequency=16, device=cuda)
    k = sk._prepare(name, env.model, cuda, None)
    a = sk.kernel_attributes(k)
    lay = sk.team_layout(env.model)
    assert (a.threads_per_env, a.envs_per_block) == (
        lay.threads_per_env, lay.envs_per_block)
    assert a.smem_bytes == lay.smem_bytes(name)
    assert a.max_blocks_per_sm >= 1
    assert k.built.spill_store_bytes == k.built.spill_load_bytes == 0
    _, warps = a.resident(4096)
    assert warps >= 4.0


@pytest.mark.parametrize("name,E", [
    ("Ant", 4096), ("Ant", 1000), ("Ant", 1), ("Humanoid", 4096),
    ("Hopper", 4096), ("Cheetah", 4096), ("CartPoleSwingUp", 4096),
    ("SNUHumanoid", 4096)])
def test_mass_matrix_vjp_kernel_matches_plain(cuda, name, E):
    mm, settle = {"Ant": (16, 14), **_MJCF, **_URDF_SNU}[name]
    env = envs.make(name, num_envs=E, stochastic_init=True,
                    MM_caching_frequency=mm, device=cuda)
    s = _settled(env, settle)
    q = s.joint_q.T.contiguous()
    D = env.model.dof_count
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    gH = torch.randn((D, D, E), generator=g, device=cuda)
    dq = torch.randn(q.shape, generator=g, device=cuda)
    n = sk.mass_matrix_vjp.launches
    got = sk.mass_matrix_vjp(env.model, q, gH, dq)
    assert sk.mass_matrix_vjp.launches == n + 1
    again = sk.mass_matrix_vjp(env.model, q, gH, dq)
    want = dq + lb.mass_matrix_vjp_lb(env.model, q, gH)
    exact = dq.double() + lb.mass_matrix_vjp_lb(env.model, q.double(),
                                                 gH.double())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    check_kernel(f"{name} dq", got, want, exact, 2e-4, 1e-5, f64_floor(name))
    k = sk._prepare("mass_matrix_vjp", env.model, cuda, None)
    assert k.built.spill_store_bytes == k.built.spill_load_bytes == 0
    assert sk.kernel_attributes(k).resident(4096)[1] >= 4.0


def test_vjp_kernel_rejects_bad_inputs(cuda):
    env = envs.make("Ant", num_envs=64, MM_caching_frequency=16, device=cuda)
    s = env.reset()
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    ja = torch.zeros_like(qd)
    Hinv = torch.zeros((14, 14, 64), device=cuda)
    gq, gqd = torch.zeros_like(q), torch.zeros_like(qd)
    with pytest.raises(ValueError, match="contiguous float32"):
        sk.substep_vjp(env.model, q, qd, ja, None, 1e-3, None, Hinv,
                       s.joint_q.T, gqd)
    with pytest.raises(ValueError, match="contiguous float32"):
        sk.substep_vjp(env.model, q, qd, ja, None, 1e-3, None, Hinv, gq,
                       gqd.double())
    with pytest.raises(ValueError, match="shape"):
        sk.substep_vjp(env.model, q, qd, ja, None, 1e-3, None, Hinv[:13],
                       gq, gqd)
    with pytest.raises(ValueError, match="without muscles"):
        sk.substep_vjp(env.model, q, qd, ja, torch.zeros((2, 64),
                                                         device=cuda),
                       1e-3, None, Hinv, gq, gqd)


# the mass-matrix period and zero-action steps from reset until ground
# contacts are active, as chip_smoke.py's MODELS
_MJCF = {"Humanoid": (48, 12), "Hopper": (16, 8), "Cheetah": (16, 16)}
_URDF_SNU = {"CartPoleSwingUp": (4, 4), "SNUHumanoid": (8, 6)}


def _check_model(cuda, name, mm, settle):
    E = 4096
    env = envs.make(name, num_envs=E, stochastic_init=True,
                    MM_caching_frequency=mm, device=cuda)
    s = _settled(env, settle)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    acts = torch.rand((E, env.num_acts), generator=g, device=cuda) * 2 - 1
    ja, ma = env.action_to_controls(acts)
    if ja is None:
        ja = torch.zeros((E, env.model.dof_count), device=cuda)
    ja = ja.T.contiguous()
    ma = ma.T.contiguous() if ma is not None else None
    q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(env.model, q, qd, ja, ma, h)
    if len(lb._plan_for(env.model, cuda).contact_rows):
        assert sk.active_contacts(env.model, q1) >= E
    gq = torch.randn(q1.shape, generator=g, device=cuda)
    gqd = torch.randn(qd1.shape, generator=g, device=cuda)
    args = (env.model, q1, qd1, ja, ma, h, H, Hinv)

    def f64(*xs):
        return [None if t is None else t.double() for t in xs]

    kf = sk.substep_forward(*args)
    pf = lb.substep_lb(*args)
    xf = lb.substep_lb(env.model, *f64(q1, qd1, ja, ma), h, *f64(H, Hinv))
    kv = sk.substep_vjp(*args, gq, gqd)
    pv = lb.substep_vjp_lb(*args, gq, gqd)
    xv = lb.substep_vjp_lb(env.model, *f64(q1, qd1, ja, ma), h,
                           *f64(H, Hinv, gq, gqd))
    margins = lb.select_margins(env.model, q1, qd1)
    torch.cuda.synchronize()
    floor = f64_floor(name)
    apart = []
    for i, (lab, atol) in enumerate((("q", 2e-6), ("qd", 2e-5))):
        check_kernel(f"{name} {lab}", kf[i], pf[i], xf[i], 2e-5, atol, floor,
                     margins, _witness(name, "substep_forward", i, args),
                     apart)
    assert (kv[3] is None) == (ma is None)
    for i, lab in enumerate(("dq", "dqd", "djoint_act", "dma", "dH")):
        if kv[i] is not None:
            check_kernel(f"{name} {lab}", kv[i], pv[i], xv[i], 2e-4, 1e-5,
                         floor, margins, _witness(
                             name, "substep_vjp", i, args + (gq, gqd)),
                         apart)
    print(f"{name}: {len(apart)} envs at a select's boundary", *apart,
          sep="\n")
    for kname in ("substep_forward", "substep_vjp"):
        k = sk._prepare(kname, env.model, cuda, None)
        assert k.built.spill_store_bytes == k.built.spill_load_bytes == 0
        assert sk.kernel_attributes(k).resident(E)[1] >= 4.0


@pytest.mark.parametrize("name", sorted(_MJCF))
def test_kernels_match_plain_on_mjcf_models(cuda, name):
    _check_model(cuda, name, *_MJCF[name])


@pytest.mark.parametrize("name", sorted(_URDF_SNU))
def test_kernels_match_plain_on_urdf_and_snu_models(cuda, name):
    """CartPole's fixed root, SNU Humanoid's ball joints and muscles."""
    _check_model(cuda, name, *_URDF_SNU[name])


@pytest.mark.parametrize("name", ["Ant", "Humanoid", "SNUHumanoid"])
def test_plain_path_is_repeatable(cuda, name):
    """The plain refresh, cached substep and both VJPs, run twice at E =
    4096 on a settled state (SNU Humanoid's muscles at random
    activations), give the same bits: every sum over rows that share a
    destination runs in a fixed order, none through atomics."""
    mm, settle = {"Ant": (16, 14), **_MJCF, **_URDF_SNU}[name]
    E = 4096
    env = envs.make(name, num_envs=E, stochastic_init=True,
                    MM_caching_frequency=mm, device=cuda)
    s = _settled(env, settle)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    acts = torch.rand((E, env.num_acts), generator=g, device=cuda) * 2 - 1
    ja, ma = env.action_to_controls(acts)
    if ja is None:
        ja = torch.zeros((E, env.model.dof_count), device=cuda)
    check_repeatable(env.model, s.joint_q.T.contiguous(),
                     s.joint_qd.T.contiguous(), ja.T.contiguous(),
                     None if ma is None else ma.T.contiguous(),
                     env.dt / env.sim_substeps, g)


def test_failed_kernel_check_leaves_a_witness(cuda, tmp_path, monkeypatch):
    """K2's dq on Ant with one entry pushed off by 1 in an env whose
    selects lie far from their boundaries: the check fails, names the
    witness, and the witness replays on the CPU with the saved plain value
    and float64 answer."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import replay_witness

    monkeypatch.setattr(testing, "WITNESS_DIR", str(tmp_path))
    E = 256
    env = envs.make("Ant", num_envs=E, stochastic_init=True,
                    MM_caching_frequency=16, device=cuda)
    s = _settled(env)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    ja = env.action_to_controls(torch.rand(
        (E, env.num_acts), generator=g, device=cuda) * 2 - 1)[0]
    ja = ja.T.contiguous()
    h = env.dt / env.sim_substeps
    with torch.no_grad():
        q1, qd1, H, Hinv = lb.refresh_substep_lb(
            env.model, s.joint_q.T.contiguous(), s.joint_qd.T.contiguous(),
            ja, None, h)
    gq = torch.randn(q1.shape, generator=g, device=cuda)
    gqd = torch.randn(qd1.shape, generator=g, device=cuda)
    args = (env.model, q1, qd1, ja, None, h, H, Hinv, gq, gqd)
    got = sk.substep_vjp(*args)[0].clone()
    want = lb.substep_vjp_lb(*args)[0]
    exact = lb.substep_vjp_lb(env.model, *(t.double() for t in args[1:4]),
                              None, h, *(t.double() for t in args[6:]))[0]
    margins = lb.select_margins(env.model, q1, qd1)
    least = torch.stack(list(margins.values())).amin(0)
    e = int(torch.argmax(least))
    assert float(least[e]) > testing.SELECT_ULPS
    got[3, e] += 1.0
    with pytest.raises(AssertionError, match=f"env {e}.*witness ") as err:
        check_kernel("Ant dq", got, want, exact, 2e-4, 1e-5, margins=margins,
                     witness=_witness("Ant", "substep_vjp", 0, args))
    r = replay_witness.replay(str(err.value).split("witness ")[1],
                              use_jax=False)
    assert r["entries"] == [(3,)]
    torch.testing.assert_close(torch.as_tensor(r["plain32"]),
                               torch.as_tensor(r["plain"]), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(torch.as_tensor(r["plain64"]),
                               torch.as_tensor(r["want"]), rtol=1e-12,
                               atol=0.0)


def _trainer_cfg(algo, logdir, **config):
    import yaml

    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, "examples", "cfg", algo, "ant.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"seed": 0, "logdir": str(logdir)}
    cfg["params"]["config"].update(config)
    return cfg


def test_shac_epoch_launches(cuda, tmp_path):
    """One SHAC epoch on Ant, 64 envs x 32 steps of 16 substeps with the
    mass matrix refreshed every 16: K1 on the 15 cached substeps of each
    step (480), K2 on every substep (512: the refresh's VJP is one K2 at its
    input) and K3 once a step (32)."""
    from diffrl_tpu_torch.algorithms import SHAC

    cfg = _trainer_cfg("shac", tmp_path, num_actors=64, steps_num=32,
                       max_epochs=1, save_interval=0)
    trainer = SHAC(cfg, device=cuda)
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
    sk.mass_matrix_vjp.launches = 0
    trainer.train_epoch()
    torch.cuda.synchronize()
    assert (sk.substep_forward.launches, sk.substep_vjp.launches,
            sk.mass_matrix_vjp.launches) == (480, 512, 32)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_model_free_epochs_never_launch_the_adjoint(cuda, algo, tmp_path):
    """One PPO epoch and one SAC learning epoch on Ant (64 envs, 4 steps)
    step the env without gradients: the forward kernel runs on each of the
    15 cached substeps of a step, neither adjoint kernel ever."""
    from diffrl_tpu_torch.algorithms import PPO, SAC

    if algo == "ppo":
        cfg = _trainer_cfg(algo, tmp_path, num_actors=64, steps_num=4,
                           minibatch_size=128, mini_epochs=2, max_epochs=1)
        trainer = PPO(cfg, device=cuda)
    else:
        cfg = _trainer_cfg(algo, tmp_path, num_actors=64,
                           num_steps_per_episode=4,
                           batch_size=128, num_seed_steps=1, max_epochs=2,
                           replay_buffer_size=4096)
        trainer = SAC(cfg, device=cuda)
        trainer.train_epoch(seed_phase=True)
    sk.substep_forward.launches = sk.substep_vjp.launches = 0
    sk.mass_matrix_vjp.launches = 0
    trainer.train_epoch()
    torch.cuda.synchronize()
    assert (sk.substep_forward.launches, sk.substep_vjp.launches,
            sk.mass_matrix_vjp.launches) == (4 * 15, 0, 0)

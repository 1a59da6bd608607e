"""The plain reference agrees with the port's plain path (the port on CPU
tensors runs its kernels' plain versions) at E = 4: the start states and
one env step of each robot, and the first SHAC and PPO epochs. In float32
the reference is the port's arithmetic, so the two agree to rounding; in
float64 an env step agrees to float32's error over the step. (Over whole
epochs at four envs one env that takes a contact's other side moves the
means by tenths, so the epochs are compared in float32 here and in
float64 only at the cells' sizes, on the card.)"""

import pytest
import torch

from benchmark.harness import check, spec
from benchmark.harness.subjects import ProgramTrainer, ReferenceTrainer
from benchmark.reference.envs import ENVS
from diffrl_tpu_torch import envs as port_envs

ROBOTS = {"AntEnv": 16, "HumanoidEnv": 48}


def _close(a, b, rtol, atol):
    torch.testing.assert_close(a.double(), b.double(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(ROBOTS))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_env_step_matches_the_port(name, dtype):
    mm = ROBOTS[name]
    port = port_envs.make(name, num_envs=4, seed=7, stochastic_init=True,
                          MM_caching_frequency=mm, device="cpu")
    ref = ENVS[name](4, 7, 1000, True, mm, "cpu", dtype)
    s_p, s_r = port.reset(), ref.reset()
    _close(s_r.joint_q, s_p.joint_q, 1e-6, 1e-6)
    _close(s_r.joint_qd, s_p.joint_qd, 1e-6, 1e-6)
    acts = torch.rand((4, port.num_acts),
                      generator=torch.Generator().manual_seed(3)) * 2 - 1
    out_p = port.step(s_p, acts)
    out_r = ref.step(s_r, acts.to(dtype))
    tol = 2e-5 if dtype == torch.float32 else 2e-3
    for a, b in ((out_r[0].joint_q, out_p[0].joint_q),
                 (out_r[0].joint_qd, out_p[0].joint_qd),
                 (out_r[1], out_p[1]), (out_r[2], out_p[2])):
        _close(a, b, tol, tol)
    assert torch.equal(out_r[3], out_p[3])


@pytest.mark.parametrize("cell_name", ("ant.shac_65536", "ant.ppo_65536"))
def test_first_epochs_match_the_port(cell_name, tmp_path):
    cell = spec.load_cell(cell_name)
    cell.traffic["config"].update(num_actors=4, steps_num=4,
                                  minibatch_size=8)
    prog = check.read(ProgramTrainer(cell, 11, str(tmp_path), "cpu"), 2)
    ref32 = check.read(ReferenceTrainer(cell, 11, "cpu", torch.float32), 2)
    same = check.compare(prog, ref32)
    assert max(same.values()) < 1e-4, same

"""The port's data-parallel training (diffrl_tpu_torch.parallel, the
trainers' ``multi_gpu``) on the CPU: two gloo processes against one.

The mirror of tests/test_distributed.py and tests/test_multichip.py:34-75.
The workers (tests/_torch_dist_worker.py) import torch and the port only;
each is started with a rendezvous timeout and waited for with a timeout of
its own, so a hung rendezvous fails the test. The one-process runs are
held against JAX by test_torch_shac.py, test_torch_ppo.py and
test_torch_ppo_builder.py.

Tolerances: the two ranks' statistics and parameters bit for bit (the
learner is replicated and every reduction gives both the same bits); two
ranks against one process at rtol 1e-5 (the bound of reordered float32
sums), atol 1e-6 for entries near zero (PPO's actor loss is a mean of terms
near 1 that cancel to 1e-4).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
CASES = ("shac", "ppo_mlp", "ppo_lstm")
TIMEOUT_S = 240

torch.set_num_threads(1)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_all(cmds, envs=None):
    """Starts every command at once, waits for each with a timeout, and
    raises with the output of any that failed."""
    procs = [subprocess.Popen(c, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=None if envs is None else envs[i])
             for i, c in enumerate(cmds)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"one": the one-process run, 0 and 1: the two ranks' runs}."""
    d = tmp_path_factory.mktemp("dist")
    port = free_port()
    run_all([[sys.executable, WORKER, "--rank", str(r), "--world", "2",
              "--port", str(port), "--out", str(d / f"{r}.npz")]
             + (["--reference", str(d / "one.npz")] if r == 0 else [])
             for r in (0, 1)])
    return {k: dict(np.load(d / f"{k}.npz")) for k in ("one", 0, 1)}


def _numbers(run, case):
    return {k: v for k, v in run.items()
            if k.startswith(case + "/")
            and not k.endswith(("/fps", "/files"))}


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree_bit_for_bit(runs, case):
    a, b = _numbers(runs[0], case), _numbers(runs[1], case)
    assert a.keys() == b.keys() and f"{case}/params" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process(runs, case):
    one, two = _numbers(runs["one"], case), _numbers(runs[0], case)
    assert one.keys() == two.keys()
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_only_rank_zero_writes(runs):
    for case in CASES:
        assert "final_policy.pt" in runs[0][f"{case}/files"]
        assert list(runs[0][f"{case}/files"]) == \
            list(runs["one"][f"{case}/files"])
        assert runs[1][f"{case}/files"].size == 0


def test_command_line_under_two_ranks(tmp_path):
    """train_shac with a multi_gpu config, each rank started as torchrun
    starts it (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) and given its
    own --logdir: rank 0's holds the config, checkpoint, histories and
    logs; rank 1's is never made."""
    with open(os.path.join(REPO, "examples", "cfg", "shac",
                           "cartpole_swing_up.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(multi_gpu=True, steps_num=4,
                                   critic_iterations=2, save_interval=0)
    cfg["params"]["diff_env"]["sim_backward"] = "lb"
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    port = str(free_port())
    envs = [dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="localhost", MASTER_PORT=port) for r in (0, 1)]
    outs = run_all([[sys.executable, "-m", "diffrl_tpu_torch.train_shac",
                     "--cfg", str(path), "--device", "cpu", "--num-envs",
                     "4", "--max-epochs", "1", "--no-time-stamp",
                     "--logdir", str(tmp_path / f"rank{r}")]
                    for r in (0, 1)], envs)
    assert "iter 1:" in outs[0] and "iter 1:" in outs[1]
    written = sorted(os.listdir(tmp_path / "rank0"))
    for name in ("cfg.yaml", "final_policy.pt", "scalars.npz",
                 "episode_loss_his.npy"):
        assert name in written
    assert not (tmp_path / "rank1").exists()


def test_sac_takes_multi_gpu(tmp_path):
    """JAX's SAC never reads multi_gpu and trains unsharded: the port's
    builds and trains from such a config (it raised before)."""
    sys.path.insert(0, HERE)
    from _torch_toy_env import ToyEnv

    from diffrl_tpu_torch.algorithms import SAC

    with open(os.path.join(REPO, "examples", "cfg", "sac", "ant.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": str(tmp_path), "seed": 0}
    cfg["params"]["config"].update(
        multi_gpu=True, num_actors=8, batch_size=16, max_epochs=2,
        num_seed_steps=1, num_steps_per_episode=4, save_frequency=0,
        replay_buffer_size=64)
    sac = SAC(cfg, env=ToyEnv("torch", num_envs=8))
    assert sac.num_envs == 8
    sac.train()
    assert np.isfinite(sac.scalars["a_loss"][-1][2])

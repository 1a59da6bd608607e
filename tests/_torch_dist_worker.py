"""One process of the port's data-parallel tests (tests/
test_torch_distributed.py): imports torch and the port only, never JAX.

    python tests/_torch_dist_worker.py --rank R --world W --port P --out F
    python tests/_torch_dist_worker.py --rms X.npz --rank R --world W ...

With ``--world 1`` it runs the one-process reference (no process group,
``multi_gpu`` off); otherwise rank R of a gloo group on localhost:P, the
trainers built with ``multi_gpu: true``, and with ``--reference F1`` the
one-process reference into F1 after it left the group. Each case trains on the CPU and
the statistics and parameters go to ``F`` (.npz): SHAC on CartPole
(examples/cfg/shac/cartpole_swing_up.yaml, 8 envs x 8 steps, 1 epoch) and
PPO on the toy env of tests/_torch_toy_env.py (8 envs x 6 steps, 2 epochs),
with its shared-trunk MLP and with an LSTM A2CNetwork.

With ``--rms`` the rank instead updates a RunningMeanStd with its rows of
X's "x" over the mesh and replicates a tensor holding its rank, and writes
the statistics and the replicated value.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from diffrl_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from diffrl_tpu_torch.utils import RunningMeanStd  # noqa: E402

E = 8
PPO_NETS = {
    "ppo_mlp": {"mlp": {"units": [16, 8], "activation": "elu"},
                "space": {"continuous": {"sigma_init": {"val": 0.0}}}},
    "ppo_lstm": {"mlp": {"units": [16]}, "rnn": {"name": "lstm", "units": 8},
                 "space": {"continuous": {"sigma_init": {"val": 0.0}}}},
}


def _cfg(algo, name, logdir, multi, **config):
    with open(os.path.join(HERE, "..", "examples", "cfg", algo, name)) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["general"] = {"logdir": logdir, "seed": 0}
    cfg["params"]["config"].update(multi_gpu=multi, **config)
    return cfg


def run_shac(logdir, multi):
    from diffrl_tpu_torch.algorithms import SHAC

    cfg = _cfg("shac", "cartpole_swing_up.yaml", logdir, multi,
               num_actors=E, steps_num=8, max_epochs=1, save_interval=0)
    cfg["params"]["diff_env"]["sim_backward"] = "lb"
    t = SHAC(cfg, device="cpu")
    t.train()
    return t, t.actor


def run_ppo(kind, logdir, multi):
    from _torch_toy_env import ToyEnv

    from diffrl_tpu_torch.algorithms import PPO

    cfg = _cfg("ppo", "ant.yaml", logdir, multi, num_actors=E, steps_num=6,
               minibatch_size=24, mini_epochs=2, entropy_coef=0.01,
               max_epochs=2, save_frequency=0, seq_length=3)
    cfg["params"]["network"].update(PPO_NETS[kind])
    t = PPO(cfg, env=ToyEnv("torch", num_envs=E))
    t.train()
    return t, t.network


def run_rms(path):
    mesh = mesh_lib.make_data_mesh(device="cpu")
    x = torch.as_tensor(np.load(path)["x"])
    rms = RunningMeanStd(x.shape[1:], device="cpu")
    rms.update(mesh_lib.shard_env_axis(mesh, x), mesh)
    mine = torch.full((3,), float(mesh.rank))
    mesh_lib.replicate(mesh, {"v": mine})
    return {"mean": rms.mean.numpy(), "var": rms.var.numpy(),
            "count": rms.count.numpy(), "replicated": mine.numpy()}


def run_cases(multi):
    out = {}
    for case in ("shac", "ppo_mlp", "ppo_lstm"):
        with tempfile.TemporaryDirectory() as logdir:
            if case == "shac":
                t, net = run_shac(logdir, multi)
            else:
                t, net = run_ppo(case, logdir, multi)
            for k, rows in t.scalars.items():
                out[f"{case}/{k}"] = np.array([v for _, _, v in rows])
            out[f"{case}/params"] = torch.cat(
                [p.detach().reshape(-1) for p in net.parameters()]).numpy()
            out[f"{case}/files"] = np.array(sorted(os.listdir(logdir)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rms", default=None)
    ap.add_argument("--reference", default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    multi = args.world > 1
    if multi:
        mesh_lib.init_distributed(f"localhost:{args.port}", args.world,
                                  args.rank, device="cpu", timeout_s=120)
    if args.rms:
        np.savez(args.out, **run_rms(args.rms))
    else:
        np.savez(args.out, **run_cases(multi))
    if multi:
        dist.destroy_process_group()
    if args.reference:
        np.savez(args.reference, **run_cases(False))


if __name__ == "__main__":
    main()

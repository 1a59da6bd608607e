"""SHAC training command line of the port (counterpart of
examples/train_shac.py): a YAML config from examples/cfg/shac/ plus
overrides, trained on CUDA unless ``--device cpu`` is given.

    python -m diffrl_tpu_torch.train_shac --cfg examples/cfg/shac/humanoid.yaml
    python -m diffrl_tpu_torch.train_shac --cfg examples/cfg/shac/ant.yaml \\
        --device cpu --num-envs 4 --max-epochs 2 --logdir logs/tiny
    python -m diffrl_tpu_torch.train_shac --cfg examples/cfg/shac/ant.yaml \\
        --play --checkpoint logs/tiny/<stamp>/final_policy.pt

A config with ``multi_gpu: true`` trains data-parallel under torchrun,
one rank per card (a world of one without a launcher); only rank 0 writes
the config, checkpoints and logs:

    torchrun --nproc_per_node 4 -m diffrl_tpu_torch.train_shac \
        --cfg my_ant_multi_gpu.yaml

``--save-interval`` overrides the config's save_interval (epochs between
checkpoints, 0 for none) when given. ``--play`` builds the config's player
(``player.num_actors`` envs), loads ``--checkpoint`` and evaluates
``player.games_num`` episodes.
"""

from __future__ import annotations

import argparse
import datetime
import os
from typing import Optional, Sequence

import torch
import yaml

from .algorithms import SHAC
from .parallel.mesh import init_distributed, process_rank
from .utils.common import seeding

_CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "cfg")


def parse_args(doc: str, cfg: str, logdir: str,
               argv: Optional[Sequence[str]] = None):
    """The training command lines' arguments (this one's, train_bptt's and
    train_rl's): ``cfg`` (under examples/cfg/) and ``logdir`` are the
    defaults of --cfg and --logdir."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--cfg", type=str, default=os.path.join(_CFG_DIR,
                                                                cfg))
    parser.add_argument("--play", default=False, action="store_true")
    parser.add_argument("--checkpoint", type=str, default="Base")
    parser.add_argument("--logdir", type=str, default=logdir)
    parser.add_argument("--save-interval", type=int, default=None)
    parser.add_argument("--no-time-stamp", default=False,
                        action="store_true")
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-envs", type=int, default=None)
    parser.add_argument("--max-epochs", type=int, default=None)
    return parser.parse_args(argv)


def get_args(argv: Optional[Sequence[str]] = None):
    return parse_args(__doc__, os.path.join("shac", "ant.yaml"),
                      "logs/tmp/shac/", argv)


def build_config(args):
    """The training config: the YAML file with the command line's
    overrides, and ``params.general`` holding the arguments."""
    with open(args.cfg) as f:
        cfg = yaml.safe_load(f)
    config = cfg["params"]["config"]
    if args.play:
        config["num_actors"] = config.get("player", {}).get("num_actors", 1)
    if args.num_envs is not None:
        config["num_actors"] = args.num_envs
    if args.max_epochs is not None:
        config["max_epochs"] = args.max_epochs
    if args.save_interval is not None:
        # SHAC and BPTT read save_interval, PPO and SAC save_frequency
        key = "save_frequency" if "save_frequency" in config \
            else "save_interval"
        config[key] = args.save_interval
    if not args.no_time_stamp:
        args.logdir = os.path.join(
            args.logdir, datetime.datetime.now().strftime("%y-%m-%d-%H-%M-%S"))
    cfg["params"]["general"] = dict(vars(args), train=not args.play)
    return cfg


def prepare(args):
    """The arguments' config (build_config), with the host's generators
    seeded and, for training, the config written next to the logs by rank
    0. A ``multi_gpu`` config started by a launcher (torchrun sets
    WORLD_SIZE) joins its process group first."""
    cfg = build_config(args)
    if cfg["params"]["config"].get("multi_gpu", False) and \
            "WORLD_SIZE" in os.environ:
        init_distributed(device=args.device)
    seeding(args.seed)
    if not args.play and process_rank() == 0:
        os.makedirs(args.logdir, exist_ok=True)
        with open(os.path.join(args.logdir, "cfg.yaml"), "w") as f:
            yaml.dump(cfg, f)
    return cfg


def run(trainer_cls, args):
    """Builds ``trainer_cls`` from the arguments' config on --device, and
    plays its checkpoint or trains it. Returns the trainer, or what play
    returns."""
    cfg = prepare(args)
    try:
        trainer = trainer_cls(cfg, device=args.device)
        if args.play:
            return trainer.play(cfg)
        trainer.train()
        return trainer
    finally:
        finish()


def finish():
    """Leaves the process group, if this process joined one."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None):
    return run(SHAC, get_args(argv))


if __name__ == "__main__":
    main()

"""SHAC training command line of the port (counterpart of
examples/train_shac.py): a YAML config from examples/cfg/shac/ plus
overrides, trained on CUDA unless ``--device cpu`` is given.

    python -m diffrl_tpu_torch.train_shac --cfg examples/cfg/shac/humanoid.yaml
    python -m diffrl_tpu_torch.train_shac --cfg examples/cfg/shac/ant.yaml \\
        --device cpu --num-envs 4 --max-epochs 2 --logdir logs/tiny
    python -m diffrl_tpu_torch.train_shac --cfg examples/cfg/shac/ant.yaml \\
        --play --checkpoint logs/tiny/<stamp>/final_policy.pt

``--save-interval`` overrides the config's save_interval (epochs between
checkpoints, 0 for none) when given. ``--play`` builds the config's player
(``player.num_actors`` envs), loads ``--checkpoint`` and evaluates
``player.games_num`` episodes.
"""

from __future__ import annotations

import argparse
import datetime
import os
import random
from typing import Optional, Sequence

import numpy as np
import torch
import yaml

from .algorithms import SHAC

_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "cfg", "shac", "ant.yaml")


def get_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", type=str, default=_CFG)
    parser.add_argument("--play", default=False, action="store_true")
    parser.add_argument("--checkpoint", type=str, default="Base")
    parser.add_argument("--logdir", type=str, default="logs/tmp/shac/")
    parser.add_argument("--save-interval", type=int, default=None)
    parser.add_argument("--no-time-stamp", default=False,
                        action="store_true")
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-envs", type=int, default=None)
    parser.add_argument("--max-epochs", type=int, default=None)
    return parser.parse_args(argv)


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
        config["save_interval"] = args.save_interval
    if not args.no_time_stamp:
        args.logdir = os.path.join(
            args.logdir, datetime.datetime.now().strftime("%y-%m-%d-%H-%M-%S"))
    cfg["params"]["general"] = dict(vars(args), train=not args.play)
    return cfg


def main(argv: Optional[Sequence[str]] = None):
    args = get_args(argv)
    cfg = build_config(args)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    trainer = SHAC(cfg, device=args.device)
    if args.play:
        return trainer.play(cfg)
    os.makedirs(args.logdir, exist_ok=True)
    with open(os.path.join(args.logdir, "cfg.yaml"), "w") as f:
        yaml.dump(cfg, f)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

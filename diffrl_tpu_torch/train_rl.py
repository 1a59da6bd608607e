"""Model-free training command line of the port (counterpart of
examples/train_rl.py): a YAML config from examples/cfg/ppo/ or
examples/cfg/sac/ (or any config the Runner's names cover) plus overrides,
dispatched by ``algo.name`` through the Runner and trained on CUDA unless
``--device cpu`` is given.

    python -m diffrl_tpu_torch.train_rl --cfg examples/cfg/ppo/ant.yaml
    python -m diffrl_tpu_torch.train_rl --cfg examples/cfg/sac/ant.yaml \\
        --device cpu --num-envs 4 --max-epochs 1 --logdir logs/tiny

The arguments are train_shac's (``--save-interval`` sets the config's
save_frequency, ``--play`` with ``--checkpoint``, ``--seed``,
``--num-envs``, ``--max-epochs``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from .algorithms import Runner
from .train_shac import parse_args, prepare


def get_args(argv: Optional[Sequence[str]] = None):
    return parse_args(__doc__, os.path.join("ppo", "ant.yaml"),
                      "logs/tmp/rl/", argv)


def main(argv: Optional[Sequence[str]] = None):
    """Trains the config's trainer, or plays its checkpoint; returns the
    trainer."""
    args = get_args(argv)
    runner = Runner(device=args.device)
    runner.load(prepare(args))
    return runner.run({"train": not args.play})


if __name__ == "__main__":
    main()

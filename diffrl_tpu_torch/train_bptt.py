"""BPTT training command line of the port (counterpart of
examples/train_bptt.py): a YAML config from examples/cfg/bptt/ plus
overrides, trained on CUDA unless ``--device cpu`` is given.

    python -m diffrl_tpu_torch.train_bptt --cfg examples/cfg/bptt/ant.yaml
    python -m diffrl_tpu_torch.train_bptt \\
        --cfg examples/cfg/bptt/cartpole_swing_up.yaml --device cpu \\
        --num-envs 4 --max-epochs 1 --logdir logs/tiny

The arguments are train_shac's (``--save-interval``, ``--play`` with
``--checkpoint``, ``--seed``, ``--num-envs``, ``--max-epochs``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from .algorithms import BPTT
from .train_shac import parse_args, run


def get_args(argv: Optional[Sequence[str]] = None):
    return parse_args(__doc__, os.path.join("bptt", "ant.yaml"),
                      "logs/tmp/bptt/", argv)


def main(argv: Optional[Sequence[str]] = None):
    return run(BPTT, get_args(argv))


if __name__ == "__main__":
    main()

"""Algorithm runner (port of diffrl_tpu/algorithms/runner.py): maps
``params.algo.name`` to a trainer, as rl_games' Runner does, and trains or
plays it."""

from __future__ import annotations

from typing import Any, Dict

from .bptt import BPTT
from .ppo import PPO
from .sac import SAC
from .shac import SHAC

ALGOS = {
    "a2c_continuous": PPO,   # rl_games' name for continuous PPO
    "ppo": PPO,
    "sac": SAC,
    "shac": SHAC,
    "bptt": BPTT,
    "adam": BPTT,            # BPTT configs name their optimizer as the algo
    "gd": BPTT,
    "sgd": BPTT,
}


class Runner:
    def __init__(self, device=None):
        self.cfg: Dict[str, Any] = {}
        self.device = device

    def load(self, cfg: Dict[str, Any]):
        self.cfg = cfg

    def run(self, args: Dict[str, Any]):
        """Builds the config's trainer on the runner's device, then trains
        it, or with ``args["train"]`` false plays its checkpoint. Returns
        the trainer."""
        name = self.cfg["params"].get("algo", {}).get("name", "ppo")
        agent = ALGOS[name.lower()](self.cfg, device=self.device)
        if args.get("train", True):
            agent.train()
        else:
            agent.play(self.cfg)
        return agent

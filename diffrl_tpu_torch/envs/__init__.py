"""Environment registry (port of diffrl_tpu/envs/__init__.py: every env of
the JAX package)."""

from .base import DiffEnv, EnvState
from .wrappers import StatefulEnv
from .ant import AntEnv
from .cartpole_swing_up import CartPoleSwingUpEnv
from .cheetah import CheetahEnv
from .hopper import HopperEnv
from .humanoid import HumanoidEnv
from .snu_humanoid import SNUHumanoidEnv

_REGISTRY = {
    "AntEnv": AntEnv,
    "CartPoleSwingUpEnv": CartPoleSwingUpEnv,
    "CheetahEnv": CheetahEnv,
    "HopperEnv": HopperEnv,
    "HumanoidEnv": HumanoidEnv,
    "SNUHumanoidEnv": SNUHumanoidEnv,
    # short aliases
    "Ant": AntEnv,
    "CartPoleSwingUp": CartPoleSwingUpEnv,
    "Cheetah": CheetahEnv,
    "Hopper": HopperEnv,
    "Humanoid": HumanoidEnv,
    "SNUHumanoid": SNUHumanoidEnv,
}


def make(name: str, **kwargs) -> DiffEnv:
    """Build an env by name. Runs on CUDA unless ``device`` says otherwise."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown env '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)

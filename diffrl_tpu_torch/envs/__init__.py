"""Environment registry (port of diffrl_tpu/envs/__init__.py; the MJCF
locomotion envs so far: CartPole and SNU Humanoid arrive with their slice)."""

from .base import DiffEnv, EnvState
from .ant import AntEnv
from .cheetah import CheetahEnv
from .hopper import HopperEnv
from .humanoid import HumanoidEnv

_REGISTRY = {
    "AntEnv": AntEnv,
    "CheetahEnv": CheetahEnv,
    "HopperEnv": HopperEnv,
    "HumanoidEnv": HumanoidEnv,
    # short aliases
    "Ant": AntEnv,
    "Cheetah": CheetahEnv,
    "Hopper": HopperEnv,
    "Humanoid": HumanoidEnv,
}


def make(name: str, **kwargs) -> DiffEnv:
    """Build an env by name. Runs on CUDA unless ``device`` says otherwise."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown env '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)

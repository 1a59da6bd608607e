"""Environment registry (port of diffrl_tpu/envs/__init__.py; Ant so far,
the other envs arrive with their slice)."""

from .base import DiffEnv, EnvState
from .ant import AntEnv

_REGISTRY = {
    "AntEnv": AntEnv,
    "Ant": AntEnv,
}


def make(name: str, **kwargs) -> DiffEnv:
    """Build an env by name. Runs on CUDA unless ``device`` says otherwise."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown env '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)

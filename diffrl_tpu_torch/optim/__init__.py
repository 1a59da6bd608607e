"""Optimizers under the reference's names (port of diffrl_tpu/optim/).

The JAX package's optimizers are optax transforms; here they are
torch.optim optimizers over a module's parameters: ``gd`` (the reference's
plain gradient descent, optim/gd.py), ``sgd`` and ``adam`` (optax's
defaults: b1 0.9, b2 0.999, eps 1e-8 added to the square root, the same
bias corrections). optax.scale_by_adam followed by a learning rate is
Adam itself: PPO, which carries an adaptive learning rate on the device,
uses ``adam`` with ``fused=True`` and that tensor as its learning rate, so
that no step reads it back to the host. ``LBFGS`` is optax.lbfgs with its
zoom line search (BPTT's ``algo: lbfgs``, optim/lbfgs.py).
"""

from __future__ import annotations

import torch

from .lbfgs import LBFGS


def gd(params, learning_rate: float) -> torch.optim.SGD:
    """Plain gradient descent (the reference's GD optimizer)."""
    return torch.optim.SGD(params, lr=learning_rate)


sgd = gd


def adam(params, learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, fused=None) -> torch.optim.Adam:
    """Adam; ``learning_rate`` may be a device scalar with ``fused=True``."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                            eps=eps, fused=fused)

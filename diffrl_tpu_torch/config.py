"""Debug and numerics flags (port of diffrl_tpu/config.py).

- ``verify_fp`` -- check values for NaN and inf. Set it with
                   :func:`enable_fp_verification`, which says what the
                   port checks.
- :func:`gradcheck` -- a central-difference check of any scalar function
                   of a tensor, the port's per-launch gradcheck.

The reference's ``no_grad`` and ``check_grad`` globals are read by nothing
in either package, so the port has none: gradients cost nothing unless
asked for (``torch.no_grad`` where a caller wants none), and a gradient is
checked by calling :func:`gradcheck`.

``default_sim_backward`` is the reverse pass an env takes when it is built
with ``sim_backward=None`` (envs/base.py): "auto" picks "lb" when the model
qualifies (articulations only, substeps a multiple of the mass-matrix
period), else "remat".
"""

from __future__ import annotations

import numpy as np
import torch

verify_fp = False

default_sim_backward = "auto"


def enable_fp_verification(enable: bool = True):
    """Turn the port's NaN and inf checks on or off.

    PyTorch has no global trap like JAX's ``jax_debug_nans``, which raises
    at the first primitive that makes a NaN. While this is on:

    - ``torch.autograd.set_detect_anomaly`` is on: a backward pass raises
      at the first backward function that returns NaN, and names the
      forward operation that made it (with the traceback of its call);
    - ``DiffEnv.step`` runs :func:`check_finite` on what it returns (the
      next state's joint_q and joint_qd, the observations and the reward)
      and raises ``FloatingPointError`` on a non-finite value.

    Forward operations elsewhere are not checked, and a NaN inside a step
    that the step's sanitizing turns into a finite value (a blown-up env's
    reward, the observations of a reset env) raises nothing. Each check
    reads a flag back to the host: a sync per call.
    """
    global verify_fp
    verify_fp = bool(enable)
    torch.autograd.set_detect_anomaly(verify_fp)


def check_finite(*arrays, name: str = "") -> None:
    """Raise FloatingPointError naming ``name[i]`` when the i-th array holds
    a NaN or an inf (the reference's check_finite); None entries pass."""
    for i, a in enumerate(arrays):
        if a is None:
            continue
        if not bool(torch.isfinite(torch.as_tensor(a)).all()):
            raise FloatingPointError(f"non-finite value in {name}[{i}]")


def gradcheck(f, args, eps: float = 1e-3, rtol: float = 5e-2,
              atol: float = 1e-3, argnums: int = 0):
    """Central-difference check of the gradient of a scalar function
    ``f(*args)`` w.r.t. ``args[argnums]`` (the reference's per-launch
    gradcheck), in float64: the argument is cast to float64, its gradient
    taken by ``torch.autograd.grad`` and each entry's central difference
    with step ``eps``. Raises AssertionError when they differ by more than
    rtol and atol (the JAX package's defaults); returns True."""
    x = torch.as_tensor(args[argnums]).detach().to(torch.float64)

    def call(v):
        a = list(args)
        a[argnums] = v
        return f(*a)

    xg = x.clone().requires_grad_()
    with torch.enable_grad():
        analytic, = torch.autograd.grad(call(xg), xg)
    flat = x.reshape(-1)
    fd = np.zeros(flat.numel())
    with torch.no_grad():
        for i in range(flat.numel()):
            xp, xm = flat.clone(), flat.clone()
            xp[i] += eps
            xm[i] -= eps
            fd[i] = (float(call(xp.reshape(x.shape)))
                     - float(call(xm.reshape(x.shape)))) / (2 * eps)
    np.testing.assert_allclose(analytic.detach().cpu().numpy().reshape(-1),
                               fd, rtol=rtol, atol=atol)
    return True

"""diffrl_tpu_torch — the PyTorch + CUDA port of diffrl_tpu for one NVIDIA H100.

`diffrl_tpu/` (JAX) is the reference; this package mirrors its module layout
so each port module sits at the same path as its counterpart. It imports
torch, never jax, and nothing of `diffrl_tpu`.

Numerics are float32 end to end with TF32 off: long rollouts blew up with
NaNs when the reference's matmuls ran below full float32
(diffrl_tpu/__init__.py forces "highest" matmul precision for the same
reason).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is wanted (``device`` None or a CUDA device) and absent;
    CPU runs must ask for ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

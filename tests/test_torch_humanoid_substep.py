"""The port's cached substep on Humanoid (diffrl_tpu_torch.sim.
articulation_lb.substep_lb, the plain version of the K1 and K2 kernels, and
the kernel wrappers on CPU tensors) against the JAX package's, on the CPU
at E = 4: values and the VJP with the frozen-factor H cotangent, at
tests/test_articulation_lb.py's tolerances (tests/_torch_mjcf.py).
"""

from _torch_mjcf import check_cached


def test_humanoid_cached_substep_and_vjp_match_jax():
    check_cached("Humanoid")

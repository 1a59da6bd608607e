"""The port's refresh substep on Humanoid (diffrl_tpu_torch.sim.
articulation_lb.refresh_substep_lb: fk, inverse dynamics, ground contacts,
the CRBA mass matrix of 27 dofs and its unrolled inverse) against the JAX
package's, on the CPU at E = 4: values and the VJP with cotangents on
(q', qd', H), at tests/test_articulation_lb.py's tolerances
(tests/_torch_mjcf.py). One test: JAX's compile of this VJP takes most of
the file's time.
"""

from _torch_mjcf import check_refresh


def test_humanoid_refresh_substep_and_vjp_match_jax():
    check_refresh("Humanoid")

"""The port's refresh and cached substeps on Hopper (a planar base: two
slides and a hinge at the root, no free joint) against the JAX package's,
on the CPU at E = 4: values and VJPs at tests/test_articulation_lb.py's
tolerances (tests/_torch_mjcf.py).
"""

from _torch_mjcf import check_cached, check_refresh


def test_hopper_refresh_substep_and_vjp_match_jax():
    check_refresh("Hopper")


def test_hopper_cached_substep_and_vjp_match_jax():
    check_cached("Hopper")

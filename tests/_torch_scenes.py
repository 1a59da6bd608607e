"""Shared helpers of the port's particle-engine tests: the field-by-field
comparison of a port Model with a JAX Model."""

import dataclasses

import numpy as np


def assert_models_equal(tm, jm, atol=1e-7):
    """Topology exactly, scalars exactly, arrays in shape and dtype and to
    ``atol`` (both builders do the same float64 host math, rounded to
    float32 at finalize)."""
    assert dataclasses.asdict(tm.topology) == dataclasses.asdict(jm.topology)
    for f in dataclasses.fields(tm):
        if f.name == "topology":
            continue
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(a, (bool, int, float, str)):
            assert a == b, f.name
        else:
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, f.name
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f.name)

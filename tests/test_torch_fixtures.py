"""The seven articulation-only dflex scenes of tests/parity_scenes.py
(pendulum2, pendulum2_mm1, cartpole, ball_joint, freefall_box,
muscle_pendulum, arm7) built with the port's ModelBuilder and run through
its link-batched engine on the CPU at E = 1 (chip_smoke.scene_run, which
runs them through the forward kernel on the card), against the golden
trajectories of the reference dflex engine at tests/test_parity.py's
tolerances: joint_q atol 1e-5 over the first 30 steps and 1e-4 over all
(freefall_box 1e-4 and 5e-3), joint_qd at 20 times the second. No JAX is
compiled.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("name", chip_smoke.SCENES)
def test_scene_matches_dflex_on_the_plain_path(name):
    early, full, vel, launches = chip_smoke.scene_run(name, "cpu")
    assert launches == 0     # CPU tensors take the plain version
    tol = chip_smoke.SCENE_TOL.get(name, (1e-5, 1e-4))
    assert early <= tol[0] and full <= tol[1] and vel <= 20 * tol[1]

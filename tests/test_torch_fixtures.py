"""The dflex scenes of tests/parity_scenes.py built with the port's
ModelBuilder and run on the CPU at E = 1 (chip_smoke.scene_run, which runs
them on the card as well): the seven articulation-only scenes (pendulum2,
pendulum2_mm1, cartpole, ball_joint, freefall_box, muscle_pendulum, arm7)
through the link-batched engine, the three particle scenes
(spring_particles, particle_ground, fem_block) and tests/test_coupled.py's
coupled scene through sim.articulation.simulate, against their golden
trajectories at tests/test_parity.py's tolerances: joint_q or particle_q
atol 1e-5 over the first 30 steps and 1e-4 over all (freefall_box and
fem_block 1e-4 and 5e-3), velocities at 20 times the second. The coupled
scene's fixture is the JAX package's own run (every 5th of 40 steps); its
first 30 steps are held at test_coupled.py's 2e-5 and all 40 at 1e-4
(chip_smoke.SCENE_TOL says why). No JAX is compiled.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("name",
                         chip_smoke.SCENES + chip_smoke.PARTICLE_SCENES)
def test_scene_matches_dflex_on_the_plain_path(name):
    early, full, vel, launches = chip_smoke.scene_run(name, "cpu")
    assert launches == 0     # CPU tensors take the plain version
    tol = chip_smoke.SCENE_TOL.get(name, (1e-5, 1e-4))
    assert early <= tol[0] and full <= tol[1] and vel <= 20 * tol[1]

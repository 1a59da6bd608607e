"""The port's Hopper env.step (diffrl_tpu_torch.envs.hopper: the planar
base's observations, the clipped height and angle rewards, termination,
the in-graph reset) against the JAX env on its lb engine, on the CPU:
values and the gradient through one step of its 16 substeps with mm 16 in
which env 3 hits the time limit (tests/_torch_mjcf.py's check_env_step and
its tolerances). No env terminates: a hopper pushed below the termination
height springs back above it within the step.
"""

from _torch_mjcf import check_env_step


def test_hopper_env_step_and_gradient_match_jax():
    check_env_step("Hopper", early_done=False)

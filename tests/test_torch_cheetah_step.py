"""The port's Cheetah env.step (diffrl_tpu_torch.envs.cheetah: the planar
base raised and tilted, the progress reward, no early termination) against
the JAX env on its lb engine, on the CPU: values and the gradient through
one step of its 16 substeps with mm 16 in which env 3 hits the time limit
(tests/_torch_mjcf.py's check_env_step and its tolerances).
"""

from _torch_mjcf import check_env_step


def test_cheetah_env_step_and_gradient_match_jax():
    check_env_step("Cheetah", early_done=False)

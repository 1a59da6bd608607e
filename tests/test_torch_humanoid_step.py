"""The port's Humanoid env.step (diffrl_tpu_torch.envs.humanoid: motor
strengths, the height reward's two selects, termination, the invalid mask
and its zeroed reward, the in-graph reset) against the JAX env on its lb
engine, on the CPU: values (rtol 1e-5, atol 5e-5) and the gradient of
sum(reward) + <w, obs> w.r.t. (actions, joint_q, joint_qd) (rtol 1e-3,
atol 1e-4 in units of each env's largest entry, the rule of
diffrl_tpu_torch/testing.py's check_vjp) through one step in which env 0 (lying on the ground)
terminates and env 3 hits the time limit, with ground contacts active.

Both sides run the env's own 48 substeps with mm 48 (one refresh and 47
cached substeps). Cutting the step to 4 substeps, as tests/test_envs.py
cuts its small humanoid, saves no compile time here (JAX compiles the
cached substeps as one scan: over a minute either way) and makes
the substep 1/240 s: the Humanoid's light links then reach hundreds of
rad/s within the step, and float32 differences between the two engines
grow past the tolerances. JAX's compile of this step's gradient takes most
of the file's time.
"""

from _torch_mjcf import check_env_step


def test_humanoid_env_step_and_gradient_match_jax():
    check_env_step("Humanoid")

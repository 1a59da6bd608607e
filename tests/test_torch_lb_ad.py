"""The env's "lb_ad" reverse pass (simulate_batched_lb with
reverse="residual") against the JAX package's "lb_ad", on the CPU.

In the port each cached substep is an autograd node whose forward is K1's
wrapper and whose backward is K2's on the saved inputs (the plain versions
on the CPU), with no replay; the refresh substep is differentiated by
autograd through its plain code. H's cotangent is the frozen-factor one,
-(Hinv g) x^T, and Hinv takes none: JAX's "lb_ad" differentiates the same
convention by XLA's autodiff through its substep scan, so a wrong
convention shows here and not only against the port's own "lb"
(tests/test_torch_backwards.py).

One env step of CartPole (4 substeps, mm 4: a refresh and three cached
substeps) from injected states and actions, both packages on "lb_ad"
(tests/_torch_urdf_snu.py's check_env_step): values at rtol 1e-5, atol
5e-5; the gradient of sum(reward) + <w, obs> w.r.t. (actions, joint_q,
joint_qd) at rtol 1e-3, atol 1e-4 in units of each env's largest entry
(testing.check_vjp). The JAX reference compiles for about 25 s.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _torch_urdf_snu import check_env_step  # noqa: E402


def test_lb_ad_env_step_matches_jax():
    check_env_step("CartPoleSwingUp", backward="lb_ad")

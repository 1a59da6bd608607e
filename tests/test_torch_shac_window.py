"""The port's SHAC window (diffrl_tpu_torch.algorithms.shac.SHAC.rollout
and its backward through the simulator) against the JAX trainer's, on the
CPU, with test_torch_shac.py's trainers (Ant from examples/cfg/shac/
ant.yaml at E = 4, steps_num 2, 4 substeps, mm 4, sim_backward "lb"): the
window loss and the actor gradients at rtol 1e-3 atol 1e-4, the window's
records, the live observation statistics and the env state after it.
"""

import jax
import numpy as np
import torch

from diffrl_tpu_torch.utils.convert import param_pairs

from test_torch_shac import _cfg, _close, _port, jtrainer  # noqa: F401


def test_window_loss_and_actor_grads_match_jax(jtrainer, tmp_path):
    jt = jtrainer
    tt = _port(_cfg(tmp_path), jt)

    def loss(ap):
        return jt._rollout(ap, jt.target_critic_params, jt.env_state,
                           jt.obs_rms, jt.ret_rms, jt.episode_trackers,
                           jax.random.PRNGKey(1), True)

    (jloss, aux), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jt.actor_params)
    tloss, outs = tt.rollout(deterministic=True)
    tloss.backward()
    tol = dict(rtol=1e-3, atol=1e-4)
    _close(tloss, jloss, **tol)
    for name, p, g in param_pairs(tt.actor, jax.device_get(jgrads)):
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(grad, g, err_msg=name, **tol)
    for k in ("obs", "rew", "next_value"):
        _close(outs[k], aux["outs"][k], err_msg=k, **tol)
    np.testing.assert_array_equal(outs["done"].numpy(),
                                  np.asarray(aux["outs"]["done"]))
    # the live statistics moved on; the window used the frozen ones
    _close(tt.obs_rms.mean, aux["obs_rms"].mean, rtol=1e-5, atol=1e-5)
    _close(tt.obs_rms.var, aux["obs_rms"].var, rtol=1e-4, atol=1e-5)
    _close(tt.obs_rms.count, aux["obs_rms"].count, rtol=0, atol=0)
    _close(tt.env_state.joint_q, aux["env_state"].joint_q, **tol)

"""The window gradient of the port's simulate_batched_lb (the replay
reverse pass, diffrl_tpu_torch.sim.articulation_lb) against the JAX
simulate_batched_lb(reverse="replay") on Ant at E = 4, mm 4, 8 substeps
(tests/_lb_window_check.py's shape), on the CPU: values rtol 1e-4 atol
1e-5, grads rtol 1e-3 atol 1e-4. The inputs are test_torch_grad.py's
settled Ant state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffrl_tpu.sim import articulation_lb as jlb

from diffrl_tpu_torch.sim import articulation_lb as tlb
from diffrl_tpu_torch.sim import substep_kernels as sk

from test_torch_grad import _t, ant, states  # noqa: F401  (fixtures)


def test_window_gradient_matches_jax(ant, states):
    """simulate_batched_lb's replay reverse pass over two blocks (mm 4, 8
    substeps: refresh replays and cached-substep VJPs) against JAX's."""
    jm, tm = ant
    E = 4
    rs = np.random.RandomState(2)
    q = states[0]["settled"][0][:, :E].T.copy()
    q += rs.normal(0.0, 0.01, q.shape).astype(np.float32)
    qd = rs.normal(0.0, 0.3, (E, tm.dof_count)).astype(np.float32)
    ja = np.zeros((E, tm.dof_count), np.float32)
    ja[:, 6:] = rs.uniform(-50.0, 50.0, (E, tm.dof_count - 6))
    w_q = rs.normal(size=q.shape).astype(np.float32)
    w_qd = rs.normal(size=qd.shape).astype(np.float32)
    kw = dict(dt=1.0 / 60.0, substeps=8, mass_matrix_freq=4)

    def jloss(a, b, c):
        qn, qdn = jlb.simulate_batched_lb(jm, a, b, c, None, **kw)
        return jnp.sum(qn * w_q) + jnp.sum(qdn * w_qd), (qn, qdn)

    (_, (jq, jqd)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, qd, ja)
    leaves = [x.requires_grad_() for x in _t(q, qd, ja)]
    tq, tqd = tlb.simulate_batched_lb(tm, *leaves, None, **kw)
    loss = torch.sum(tq * torch.as_tensor(w_q)) + torch.sum(
        tqd * torch.as_tensor(w_qd))
    launches = sk.substep_vjp.launches
    tg = torch.autograd.grad(loss, leaves)
    assert sk.substep_vjp.launches == launches    # plain version on CPU
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tqd.detach().numpy(), np.asarray(jqd),
                               rtol=1e-4, atol=1e-5)
    for lab, a, b in zip(("dq", "dqd", "dja"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4, err_msg=f"window grad {lab}")

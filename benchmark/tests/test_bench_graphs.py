"""The reference's substeps replayed as CUDA graphs agree with the eager
functions: one env step of Ant and of Humanoid at 256 envs in float64,
forward and its VJP, through ``simulate_batched_lb`` on the card (the
graphed path) against ``refresh_substep_lb``, ``substep_lb``,
``substep_vjp_lb`` and ``refresh_vjp_lb`` called directly in the same
order, to 1e-12 of each output's largest entry. Ant also runs with four
blocks a step, so that H and Hinv change between graphed calls. On the
H100 (torch 2.11, CUDA 12.8) the two paths agree bit for bit, in these
cases and in every reading of both cells' check epochs at their sizes; the
test prints whether they do. CUDA graphs exist only on the card."""

import pytest
import torch

from benchmark.reference import articulation as art
from benchmark.reference.envs import env_class

E = 256
RTOL = 1e-12


def _eager_step(model, q, qd, ja, h, nblocks, mm, gq, gqd):
    """The env step's simulate and its replay VJP, env-minor, each substep
    by its eager function."""
    blocks = []
    for _ in range(nblocks):
        q0, qd0 = q, qd
        q, qd, H, Hinv = art.refresh_substep_lb(model, q, qd, ja, None, h)
        states = []
        for _ in range(mm - 1):
            states.append((q, qd))
            q, qd = art.substep_lb(model, q, qd, ja, None, h, H, Hinv)
        blocks.append((q0, qd0, states, H, Hinv))
    out = (q, qd)
    gja = torch.zeros_like(ja)
    for q0, qd0, states, H, Hinv in reversed(blocks):
        gH = torch.zeros_like(H)
        for sq, sqd in reversed(states):
            gq, gqd, dja, _, dH = art.substep_vjp_lb(
                model, sq, sqd, ja, None, h, H, Hinv, gq, gqd)
            gja += dja
            gH += dH
        gq, gqd, dja, _ = art.refresh_vjp_lb(model, q0, qd0, ja, None, h,
                                             gq, gqd, gH)
        gja += dja
    return out + (gq, gqd, gja)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mm", (("AntEnv", 16), ("AntEnv", 4),
                                     ("HumanoidEnv", 48)))
def test_graphed_step_matches_the_eager_functions(name, mm):
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need the card")
    env = env_class(name)(E, 5, 1000, True, mm, "cuda", torch.float64)
    gen = torch.Generator(device="cuda").manual_seed(9)
    state = env.reset()
    with torch.no_grad():                      # a settled, moving state
        for _ in range(8):
            acts = torch.rand((E, env.num_acts), generator=gen,
                              device="cuda", dtype=torch.float64) * 2 - 1
            state = env.step(state, acts)[0]
    model, h = env.model, env.dt / env.sim_substeps
    ja = env.action_to_controls(torch.rand(
        (E, env.num_acts), generator=gen, device="cuda",
        dtype=torch.float64) * 2 - 1)
    q, qd = state.joint_q, state.joint_qd
    gq = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.float64)
    gqd = torch.randn(qd.shape, generator=gen, device="cuda",
                      dtype=torch.float64)

    ins = [t.detach().clone().requires_grad_() for t in (q, qd, ja)]
    q1, qd1 = art.simulate_batched_lb(model, *ins, None, env.dt,
                                      env.sim_substeps, mm)
    graphed = (q1.detach().T, qd1.detach().T) + torch.autograd.grad(
        (q1, qd1), ins, (gq, gqd))
    graphed = graphed[:2] + tuple(g.T for g in graphed[2:])
    assert art._GRAPHS[model]

    eager = _eager_step(model, q.T.contiguous(), qd.T.contiguous(),
                        ja.T.contiguous(), h, env.sim_substeps // mm, mm,
                        gq.T.contiguous(), gqd.T.contiguous())
    names = ("q", "qd", "dq", "dqd", "djoint_act")
    bitwise = all(torch.equal(g, e) for g, e in zip(graphed, eager))
    print(f"{name} mm={mm}: bit for bit {bitwise}; relative gaps " + ", ".join(
        f"{n} {float((g - e).abs().max() / e.abs().max()):.3g}"
        for n, g, e in zip(names, graphed, eager)))
    for n, g, e in zip(names, graphed, eager):
        assert torch.isfinite(e).all(), n
        assert float((g - e).abs().max()) <= RTOL * float(e.abs().max()), n
    env.close()
    assert model not in art._GRAPHS

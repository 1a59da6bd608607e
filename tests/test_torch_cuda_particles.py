"""The particle engine's sums on the GPU: the same bits run after run, and
the hashed self-collision equal to all-pairs.

These tests need a CUDA device; without one they skip. This file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_particles.py

On CUDA, autograd scatters the cotangent of a gather with repeated indices
through atomic adds, whose order changes run to run. The element families
sum per particle through fixed tables (articulation_lb._Fan), and the
hashed self-collision, whose candidates change every substep, through
index_put_(accumulate=True), which sorts the indices stably and adds each
destination's entries in order. So two runs of every force family, of its
VJP and of a short simulate window's gradient give the same bits. With no
bucket overflowing, the hashed forces equal all-pairs at
tests/test_particles.py:407's tolerance (rtol 1e-3, atol 1e-2).
"""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402
from diffrl_tpu_torch.sim import particles as part  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _folded(cuda, dim=20, envs=4, capacity=27):
    """chip_smoke's cloth folded in half (many self-contacts), E envs with
    seeded velocities."""
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    model = dataclasses.replace(chip_smoke.cloth_scene(dim),
                                tri_collision_capacity=capacity)
    x = chip_smoke.fold(model, model.state(1, cuda).particle_q[0], g)
    x = x.expand(envs, -1, -1).contiguous()
    v = 0.3 * torch.randn(x.shape, generator=g, device=cuda)
    return model, x, v


def _forces_and_vjp(fn, model, x, v):
    xs = [t.detach().clone().requires_grad_() for t in (x, v)]
    f = fn(model, *xs)
    w = torch.linspace(-1.0, 1.0, f.numel(), device=f.device).reshape(
        f.shape)
    return (f.detach(),) + torch.autograd.grad(f, xs, w, allow_unused=True)


@pytest.mark.parametrize("fn", ["particle_forces",
                                "eval_triangles_contact_hashed",
                                "eval_soft_contacts"])
def test_particle_sums_are_repeatable(cuda, fn):
    model, x, v = _folded(cuda)
    f = getattr(part, fn)
    if fn == "eval_soft_contacts":
        x = x - torch.tensor([0.0, 0.25, 0.0], device=cuda)  # into the dome

        def f(m, a, b):
            return part.eval_soft_contacts(m, a, b)[0]
    runs = [_forces_and_vjp(f, model, x, v) for _ in range(2)]
    torch.cuda.synchronize()
    assert float(runs[0][0].abs().max()) > 0.0
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)


def test_fem_window_gradient_is_repeatable(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    model = chip_smoke.fem_scene((6, 3, 3))
    s = chip_smoke.with_velocities(model, 8, cuda, g, 0.5)
    runs = [chip_smoke.loss_grad(model, s, 2, 16, ("particle_qd",))[1][0]
            for _ in range(2)]
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(*runs)


def test_hashed_equals_all_pairs(cuda):
    model, x, v = _folded(cuda, dim=30, envs=1)
    table = part.hash_table(model, x)[0]
    assert int((table < x.shape[1]).sum()) == x.shape[1]   # no overflow
    with torch.no_grad():
        f_hash = part.eval_triangles_contact_hashed(model, x, v)
        f_all = part.eval_triangles_contact(model, x, v)
    assert float(f_all.abs().max()) > 0.0
    torch.testing.assert_close(f_hash, f_all, rtol=1e-3, atol=1e-2)

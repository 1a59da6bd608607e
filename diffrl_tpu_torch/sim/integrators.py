"""Integrator classes with the reference's ``forward`` API (port of
diffrl_tpu/sim/integrators.py): thin wrappers over ``simulate`` and
``simulate_xpbd``, which are plain differentiable functions."""

from __future__ import annotations

from .articulation import simulate, simulate_xpbd
from .model import Model, State


class SemiImplicitIntegrator:
    """Semi-implicit (symplectic) Euler over articulations + particles."""

    def forward(self, model: Model, state: State, dt: float,
                substeps: int = 1, mass_matrix_freq: int = 1,
                joint_act=None, muscle_act=None) -> State:
        return simulate(
            model, state,
            joint_act=joint_act, muscle_act=muscle_act,
            dt=dt, substeps=substeps, mass_matrix_freq=mass_matrix_freq,
        )


class XPBDIntegrator:
    """Position-based dynamics (particles only, like the reference)."""

    def forward(self, model: Model, state: State, dt: float,
                substeps: int = 1) -> State:
        return simulate_xpbd(model, state, dt=dt, substeps=substeps)

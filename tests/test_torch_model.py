"""The port's model layer (diffrl_tpu_torch.sim.model, importers.mjcf and
the engine plan) against the JAX package's, on Ant from ant.xml.

Both packages build Ant from their own copy of the same MJCF, so the
finalized Model must agree field by field: topology exactly, arrays to
atol 1e-7 (both are the same float64 host math rounded to float32). The
port's level-major plan must produce the JAX plan's index tables exactly.
"""

import dataclasses
import filecmp
import os

import jax  # noqa: F401  (JAX pinned to the CPU by conftest)
import numpy as np
import pytest
import torch

import diffrl_tpu.envs as jenvs
from diffrl_tpu.sim import articulation_lb as jlb

import diffrl_tpu_torch.envs as tenvs
from diffrl_tpu_torch.sim import articulation_lb as tlb

from _torch_scenes import assert_models_equal

ATOL = 1e-7


@pytest.fixture(scope="module")
def ant_models():
    jm = jenvs.make("Ant", num_envs=2, MM_caching_frequency=16).model
    tm = tenvs.make("Ant", num_envs=2, MM_caching_frequency=16,
                    device="cpu").model
    return jm, tm


def test_asset_copy_is_identical():
    here = os.path.dirname(__file__)
    j = os.path.join(here, "..", "diffrl_tpu", "envs", "assets")
    t = os.path.join(here, "..", "diffrl_tpu_torch", "envs", "assets")
    assert filecmp.cmp(os.path.join(j, "ant.xml"), os.path.join(t, "ant.xml"),
                       shallow=False)


def test_ant_model_fields(ant_models):
    jm, tm = ant_models
    # every field: topology and scalars exactly, arrays to atol
    assert_models_equal(tm, jm, ATOL)


def test_ant_plan_tables(ant_models):
    jm, tm = ant_models
    jp = jlb._plan_for(jm)
    tp = tlb._plan_for(tm, "cpu")
    for name in ("order", "row_of", "parent_row", "subtree", "coord_perm",
                 "dof_perm", "inv_coord_perm", "inv_dof_perm", "dof_row",
                 "anc_pair", "contact_rows", "seg_row0", "seg_row1", "seg_m"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    assert tp.levels == jp.levels
    assert [(g.jtype, g.level, g.start, g.stop) for g in tp.groups] == \
        [(g.jtype, g.level, g.start, g.stop) for g in jp.groups]
    for tg, jg in zip(tp.groups, jp.groups):
        np.testing.assert_array_equal(tg.q_idx, jg.q_idx)
        np.testing.assert_array_equal(tg.qd_idx, jg.qd_idx)
        for name in ("axis", "X_pj", "target_ke", "target_kd", "limit_ke",
                     "limit_kd", "target", "lower", "upper"):
            np.testing.assert_allclose(
                getattr(tg, name).numpy(), getattr(jg, name), rtol=0,
                atol=ATOL, err_msg=name)
    for name in ("X_cm", "I3", "m", "contact_point", "contact_dist",
                 "contact_mat", "seg_r0", "seg_r1"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   getattr(jp, name), rtol=0, atol=ATOL,
                                   err_msg=name)
    # the port keeps the armature in canonical dof order
    np.testing.assert_allclose(tp.armature.numpy(),
                               jp.armature[jp.inv_dof_perm], rtol=0,
                               atol=ATOL)


def test_plan_cached_per_model_object(ant_models):
    _, tm = ant_models
    assert tlb._plan_for(tm, "cpu") is tlb._plan_for(tm, torch.device("cpu"))
    variant = dataclasses.replace(tm, gravity=np.zeros(3, np.float32))
    assert tlb._plan_for(variant, "cpu") is not tlb._plan_for(tm, "cpu")
    assert float(tlb._plan_for(variant, "cpu").gravity.abs().sum()) == 0.0

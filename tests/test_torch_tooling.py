"""The port's remaining helpers against the JAX package's, on the CPU.

- eval_mass_matrix_factored and eval_mass_matrix_crba (plain PyTorch,
  batched over envs) against JAX's on Ant (free base, 8 revolute joints) and
  on the ball-joint scene of tests/parity_scenes.py, as
  tests/test_articulation.py:244-284 holds them: at rtol/atol 1e-5 and
  rtol 1e-4 / atol 3e-5 (float32 sums in another order), and against the
  port's own eval_mass_matrix likewise.
- utils.profiling: trace() on the CPU records the block's ops,
  summarize_trace() aggregates them, and a CPU trace has no device time
  (device_busy_share 0).
- utils.common: seeding, get_time_stamp and parse_diff_env_kwargs give
  what JAX's give.
"""

import importlib.util
import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffrl_tpu import envs as jenvs
from diffrl_tpu import sim as jsim
from diffrl_tpu.sim import articulation as jart
from diffrl_tpu.utils import common as jcommon

from diffrl_tpu_torch import envs as tenvs
from diffrl_tpu_torch import sim as tsim
from diffrl_tpu_torch.sim import articulation as tart
from diffrl_tpu_torch.utils import common, profiling

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))


def _ball_scene(builder, np_transform):
    spec = importlib.util.spec_from_file_location(
        "parity_scenes", os.path.join(HERE, "parity_scenes.py"))
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    scenes.SCENES["ball_joint"]["build"](builder, np_transform)
    return builder.finalize()


def _models(name):
    if name == "Ant":
        return (jenvs.make("Ant", num_envs=1).model,
                tenvs.make("Ant", num_envs=1, device="cpu").model)
    return (_ball_scene(jsim.ModelBuilder(), jsim.model.np_transform),
            _ball_scene(tsim.ModelBuilder(), tsim.model.np_transform))


@pytest.mark.parametrize("name", ["Ant", "ball_joint"])
def test_mass_matrix_factored_and_crba_match_jax(name):
    jm, tm = _models(name)
    rs = np.random.RandomState(3)
    q0 = np.asarray(jm.joint_q_init, np.float32)
    qs = np.stack([q0 + 0.3 * rs.normal(size=q0.shape).astype(np.float32)
                   for _ in range(2)])
    quat = slice(3, 7) if name == "Ant" else slice(0, 4)
    qs[:, quat] /= np.linalg.norm(qs[:, quat], axis=-1, keepdims=True)
    qds = 0.5 * rs.normal(size=(2, tm.dof_count)).astype(np.float32)

    q, qd = torch.as_tensor(qs), torch.as_tensor(qds)
    X_sc, X_sm = tart.eval_fk(tm, q)
    S_s, _, _ = tart.eval_id(tm, q, qd, X_sc, X_sm)
    dense = tart.eval_mass_matrix(tm, S_s,
                                  tart.eval_spatial_inertias(tm, X_sm))
    factored = tart.eval_mass_matrix_factored(tm, S_s, X_sm).numpy()
    crba = tart.eval_mass_matrix_crba(tm, S_s, X_sm).numpy()
    np.testing.assert_allclose(factored, dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(crba, dense.numpy(), rtol=1e-4, atol=3e-5)
    for e in range(2):
        jX_sc, jX_sm = jart.eval_fk(jm, jnp.asarray(qs[e]))
        jS, _, _ = jart.eval_id(jm, jnp.asarray(qs[e]), jnp.asarray(qds[e]),
                                jX_sc, jX_sm)
        np.testing.assert_allclose(
            factored[e], np.asarray(jart.eval_mass_matrix_factored(
                jm, jS, jX_sm)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            crba[e], np.asarray(jart.eval_mass_matrix_crba(jm, jS, jX_sm)),
            rtol=1e-4, atol=3e-5)


def test_profiling_trace_and_summary(tmp_path, capsys):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), device="cpu") as log_dir:
        for _ in range(4):
            a = torch.tanh(a @ a)
    assert log_dir == str(tmp_path)
    rows = profiling.summarize_trace(str(tmp_path), top=50)
    by_name = {n: (ms, c) for ms, c, n in rows}
    assert by_name["aten::mm"][1] == 4 and by_name["aten::tanh"][1] == 4
    assert all(ms >= 0 for ms, _, _ in rows)
    assert "aten::mm" in capsys.readouterr().out
    assert profiling.summarize_trace(
        str(tmp_path), top=5, categories=profiling.DEVICE_CATEGORIES) == []
    assert profiling.device_busy_share(
        profiling.load_trace(str(tmp_path))) == 0.0
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "none"))


def test_common_helpers_match_jax(capsys):
    draws = []
    for mod in (jcommon, common):
        assert mod.seeding(7) == 7
        draws.append((random.random(), np.random.rand(), os.environ[
            "PYTHONHASHSEED"]))
    assert draws[0] == draws[1]
    common.seeding(7)
    t1 = torch.rand(3)
    common.seeding(7)
    assert torch.equal(torch.rand(3), t1)
    assert "Setting seed: 7" in capsys.readouterr().out
    stamp = common.get_time_stamp()
    assert re.fullmatch(r"\d\d(-\d\d){5}", stamp)
    assert len(stamp) == len(jcommon.get_time_stamp())
    block = {"name": "AntEnv", "episode_length": 1000,
             "MM_caching_frequency": 16, "stochastic_env": True}
    assert common.parse_diff_env_kwargs(block) == \
        jcommon.parse_diff_env_kwargs(block)
    for fn in ("print_ok", "print_warning", "print_error", "print_info"):
        getattr(common, fn)("msg")
        getattr(jcommon, fn)("msg")
    out = capsys.readouterr().out.splitlines()
    assert out[0::2] == out[1::2]

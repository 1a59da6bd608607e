"""The port's data mesh (diffrl_tpu_torch.parallel.mesh) against the JAX
package's (diffrl_tpu/parallel/mesh.py) on the CPU.

shard_env_axis keeps the rows JAX places on each device of its 8-device
CPU mesh (with and without ``num_envs``: the [E, ...] leaves split, the
scalar and the [2] leaf replicated, and a [8, 3] leaf split by the
heuristic alone), and replicate what it places (the whole tree),
exactly. The RunningMeanStd merge over 2 and 4 gloo
ranks (tests/_torch_dist_worker.py --rms, torch only) equals JAX's
sharded update (tests/test_multichip.py:78-95): mean at rtol 1e-5, var at
rtol 1e-4, the count exactly; replicate hands every rank rank 0's values.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffrl_tpu.parallel import mesh as jmesh
from diffrl_tpu.utils import RunningMeanStd as JRunningMeanStd

from diffrl_tpu_torch.parallel import mesh as tmesh

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_distributed import WORKER, free_port, run_all  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")


def _tree(E=16):
    rs = np.random.RandomState(0)
    return {"q": rs.normal(size=(E, 5)).astype(np.float32),
            "done": rs.uniform(size=(E,)).astype(np.float32),
            "scalar": np.float32(3.0),
            "key": np.array([7, 9], np.uint32),
            "small": rs.normal(size=(8, 3)).astype(np.float32)}


@pytest.mark.parametrize("num_envs", [16, None])
def test_shard_env_axis_places_jax_rows(num_envs):
    tree = _tree()
    mesh = jmesh.make_data_mesh(8)
    placed = jmesh.shard_env_axis(mesh, tree, num_envs)
    devices = list(mesh.devices.flat)
    for rank in range(8):
        mine = tmesh.shard_env_axis(
            tmesh.DataMesh(None, rank, 8, torch.device("cpu")),
            {k: torch.as_tensor(v) for k, v in tree.items()}, num_envs)
        for k, arr in placed.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)
    # the heuristic splits the [8, 3] leaf, num_envs keeps it whole
    assert mine["small"].shape == ((8, 3) if num_envs else (1, 3))
    # replicate: every device holds the whole tree (no group: as it is)
    whole = jmesh.replicate(mesh, tree)
    for rank in range(8):
        mine = tmesh.replicate(
            tmesh.DataMesh(None, rank, 8, torch.device("cpu")),
            {k: torch.as_tensor(v) for k, v in tree.items()})
        for k, arr in whole.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_rms_merge_equals_jax_sharded_update(world, tmp_path):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 3)))
    np.savez(tmp_path / "x.npz", x=x)
    mesh = jmesh.make_data_mesh(8)
    want = jax.jit(lambda r, b: r.update(b))(
        JRunningMeanStd.create((3,)), jmesh.shard_env_axis(mesh,
                                                           jnp.asarray(x)))
    port = str(free_port())
    run_all([[sys.executable, WORKER, "--rms", str(tmp_path / "x.npz"),
              "--rank", str(r), "--world", str(world), "--port", port,
              "--out", str(tmp_path / f"{r}.npz")] for r in range(world)])
    for r in range(world):
        got = np.load(tmp_path / f"{r}.npz")
        np.testing.assert_allclose(got["mean"], np.asarray(want.mean),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["var"], np.asarray(want.var),
                                   rtol=1e-4)
        assert got["count"] == np.asarray(want.count)
        np.testing.assert_array_equal(got["replicated"], np.zeros(3))

"""The port's scene builder for particles, cloth, FEM and mesh shapes, the
mesh SDF bake, the URDF ``<mesh>`` collider and the procedural capsule
chain, field by field against the JAX package's (tests/_torch_scenes.py:
topology and scalars exactly, arrays to atol 1e-7)."""

import numpy as np
import pytest
import torch

import diffrl_tpu.sim.model as JM
from diffrl_tpu.sim.importers.procedural import build_tree as j_build_tree
from diffrl_tpu.sim.importers.urdf import urdf_load as j_urdf_load

import diffrl_tpu_torch.sim.model as TM
from diffrl_tpu_torch.sim.importers import build_tree, urdf_load

from _torch_scenes import assert_models_equal

QI = np.array([0.0, 0.0, 0.0, 1.0])
TET_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
TET_F = np.array([0, 2, 1, 0, 1, 3, 0, 3, 2, 1, 2, 3])


def deformables(M):
    rot = np.array([0.0, 0.0, 0.38268343, 0.92387953])
    b = M.ModelBuilder()
    b.sdf_resolution = 12
    b.add_cloth_grid(pos=(0.0, 1.0, 0.0), rot=rot, vel=(0.1, 0.0, 0.0),
                     dim_x=3, dim_y=2, cell_x=0.1, cell_y=0.2, mass=0.1,
                     fix_left=True, fix_top=True)
    b.add_cloth_grid(pos=(1.0, 1.0, 0.0), rot=QI, vel=(0.0, 0.0, 0.0),
                     dim_x=2, dim_y=2, cell_x=0.1, cell_y=0.1, mass=0.2,
                     reverse_winding=True, fix_right=True, fix_bottom=True)
    b.add_soft_grid(pos=(0.0, 0.4, 0.5), rot=rot, vel=(0.0, -1.0, 0.0),
                    dim_x=3, dim_y=2, dim_z=2, cell_x=0.1, cell_y=0.1,
                    cell_z=0.1, density=100.0, k_mu=500.0, k_lambda=800.0,
                    k_damp=5.0, fix_left=True, fix_top=True)
    b.add_cloth_mesh(pos=(0.0, 2.0, 0.0), rot=rot, scale=0.5,
                     vel=(0.0, 0.0, 0.0), vertices=TET_V, indices=TET_F,
                     density=10.0)
    i = b.add_particle((0.0, 3.0, 0.0), (0.0, 0.0, 0.0), 1.0)
    j = b.add_particle((0.2, 3.1, 0.0), (0.0, 0.0, 0.0), 0.0)
    k = b.add_particle((0.1, 3.0, 0.3), (0.0, 0.0, 0.0), 1.0)
    l_ = b.add_particle((0.0, 3.4, 0.1), (0.0, 0.0, 0.0), 1.0)
    b.add_spring(i, j, ke=50.0, kd=1.0, control=0.0)
    b.add_triangle(i, j, k)
    b.add_edge(i, j, k, l_)
    b.add_edge(i, j, k, l_, rest=0.3)
    b.add_tetrahedron(j, i, k, l_, k_mu=2e3, k_lambda=3e3, k_damp=1.0)
    b.add_articulation()
    link = b.add_link(-1, np.r_[0.0, 0.5, 0.0, QI], axis=(0.0, 0.0, 1.0),
                      type=M.JOINT_REVOLUTE)
    b.add_shape_mesh(link, pos=(0.1, 0.0, 0.0), rot=rot,
                     mesh=M.Mesh(TET_V, TET_F), scale=(0.3, 0.3, 0.3),
                     density=500.0)
    b.add_shape_mesh(-1, mesh=M.Mesh(TET_V * 0.5, TET_F), density=0.0)
    return b.finalize()


def test_particle_builder_and_mesh_sdf_match_jax():
    tm, jm = deformables(TM), deformables(JM)
    assert tm.particle_count == jm.particle_count > 0
    assert tm.sdf_grid.shape == (2, 12, 12, 12)
    assert_models_equal(tm, jm)
    for a, b in zip(TM.bake_mesh_sdf(TET_V, TET_F, resolution=10),
                    JM.bake_mesh_sdf(TET_V, TET_F, resolution=10)):
        np.testing.assert_array_equal(a, np.asarray(b))
    mt, mj = TM.Mesh(TET_V, TET_F), JM.Mesh(TET_V, TET_F)
    assert mt.mass == mj.mass
    np.testing.assert_array_equal(mt.I, mj.I)


def test_urdf_mesh_collider_matches_jax(tmp_path):
    obj = tmp_path / "tet.obj"
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in TET_V)
                   + "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    urdf = tmp_path / "mesh.urdf"
    urdf.write_text(
        '<robot name="m"><link name="base"><collision><origin '
        'xyz="0.1 0 0"/><geometry><mesh filename="tet.obj" '
        'scale="0.5 0.5 0.5"/></geometry></collision></link>'
        '<link name="arm"><collision><geometry><mesh filename="tet.obj"/>'
        '</geometry></collision></link><joint name="j" type="revolute">'
        '<parent link="base"/><child link="arm"/><axis xyz="0 0 1"/>'
        '<origin xyz="0 0.5 0"/><limit lower="-1" upper="1"/></joint>'
        '</robot>')
    models = []
    for M, load in ((TM, urdf_load), (JM, j_urdf_load)):
        b = M.ModelBuilder()
        load(b, str(urdf), M.np_transform_identity(), floating=True)
        b.add_particle((0.0, 2.0, 0.0), (0.0, 0.0, 0.0), 1.0)
        models.append(b.finalize())
    assert models[0].sdf_grid is not None
    assert_models_equal(*models)


@pytest.mark.parametrize("floating", [False, True])
def test_build_tree_matches_jax(floating):
    models = []
    for M, fn in ((TM, build_tree), (JM, j_build_tree)):
        b = M.ModelBuilder()
        b.add_articulation()
        last = fn(b, angle=0.3, max_depth=4, joint_stiffness=2.0,
                  joint_damping=0.5, floating=floating)
        assert last == 3
        models.append(b.finalize())
    assert_models_equal(*models)


def test_batched_state_defaults_to_cuda():
    """``Model.state(num_envs)`` makes the simulators' state on CUDA unless
    the caller names a device; without CUDA it raises instead of quietly
    giving CPU tensors."""
    tm = deformables(TM)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tm.state(num_envs=2)
    st = tm.state(num_envs=2, device="cpu")
    assert st.particle_q.device.type == "cpu"
    assert st.particle_q.dtype == torch.float32
    assert st.particle_q.shape == (2,) + tm.particle_q_init.shape
    np.testing.assert_array_equal(st.particle_q[1].numpy(),
                                  tm.particle_q_init.astype(np.float32))
    assert isinstance(tm.state().particle_q, np.ndarray)

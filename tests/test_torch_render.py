"""The port's USD renderer, HTML viewer and trajectory recorder
(diffrl_tpu_torch.render, .viewer) against the JAX package's, on the CPU.

The same frames go through both: 3 Ant frames (joint_q near its start,
body transforms from each package's eval_fk) and the particle scene of
tests/test_render.py (two particles, a spring, a static sphere, the ground
plane) with the manual helpers. The .usda text must be the JAX text with
every number within 1e-5 (relative, and absolute near zero): both print 6
significant digits of float32 values computed in another order, so a last
digit may differ. The viewer's embedded JSON likewise (its numbers rounded
to 5 decimals: 1.1e-5 absolute), the rest of the HTML exactly.
"""

import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffrl_tpu import envs as jenvs
from diffrl_tpu import render as jrender
from diffrl_tpu import sim as jsim
from diffrl_tpu import viewer as jviewer
from diffrl_tpu.sim.model import State as JState

from diffrl_tpu_torch import envs as tenvs
from diffrl_tpu_torch import render as trender
from diffrl_tpu_torch import viewer as tviewer
from diffrl_tpu_torch.sim import ModelBuilder as TModelBuilder
from diffrl_tpu_torch.sim.model import State as TState

torch.set_num_threads(1)
NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def assert_text_close(got, want, rtol=1e-5, atol=1e-5):
    assert NUM.split(got) == NUM.split(want)
    a = np.array([float(x) for x in NUM.findall(got)])
    b = np.array([float(x) for x in NUM.findall(want)])
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def ant():
    jm = jenvs.make("Ant", num_envs=1).model
    tm = tenvs.make("Ant", num_envs=1, device="cpu").model
    rs = np.random.RandomState(0)
    q0 = np.asarray(jm.joint_q_init, np.float32)
    frames = []
    for _ in range(3):
        q = q0 + 0.2 * rs.normal(size=q0.shape).astype(np.float32)
        q[3:7] /= np.linalg.norm(q[3:7])
        frames.append(q)
    return jm, tm, np.stack(frames)


def _particle_scene(b):
    b.add_particle((0.0, 1.0, 0.0), (0.0, 0.0, 0.0), 1.0)
    b.add_particle((0.5, 1.0, 0.0), (0.0, 0.0, 0.0), 1.0)
    b.add_spring(0, 1, ke=100.0, kd=1.0, control=0.0)
    b.add_shape_sphere(-1, pos=(0.0, 0.0, 0.0), radius=0.3, density=0.0)
    b.add_shape_plane()
    return dataclasses.replace(b.finalize(), ground=True)


def test_usd_ant_frames_match_jax(ant, tmp_path):
    jm, tm, frames = ant
    jr = jrender.UsdRenderer(jm, str(tmp_path / "j.usda"))
    tr = trender.UsdRenderer(tm, str(tmp_path / "t.usda"))
    for i, q in enumerate(frames):
        jr.update(JState(joint_q=jnp.asarray(q)), i / 60.0)
        tr.update(TState(joint_q=torch.as_tensor(q)), i / 60.0)
    want, got = (open(r.save()).read() for r in (jr, tr))
    assert 'def Xform "body_' in got and "xformOp:orient.timeSamples" in got
    assert_text_close(got, want)


def test_usd_particle_scene_matches_jax(tmp_path):
    jm = _particle_scene(jsim.ModelBuilder())
    tm = _particle_scene(TModelBuilder())
    rs = np.random.RandomState(1)
    renderers = (jrender.UsdRenderer(jm, str(tmp_path / "j.usda")),
                 trender.UsdRenderer(tm, str(tmp_path / "t.usda")))
    for i in range(3):
        pq = rs.normal(size=(2, 3)).astype(np.float32)
        renderers[0].update(JState(particle_q=jnp.asarray(pq)), i / 60.0)
        renderers[1].update(TState(particle_q=torch.as_tensor(pq)), i / 60.0)
    verts = rs.normal(size=(4, 3)).astype(np.float32)
    for r in renderers:
        r.add_sphere((1.0, 1.0, 0.0), 0.2, "marker")
        r.add_box((0.0, 2.0, 0.0), (0.1, 0.2, 0.3), "crate", time=0.5)
        r.add_mesh("tri", verts, np.array([0, 1, 2, 1, 2, 3]))
        r.add_line_strip(verts[:3], "muscle0", time=0.25)
    want, got = (open(r.save()).read() for r in renderers)
    assert 'def Points "particles"' in got and 'def Mesh "shape_' in got
    assert_text_close(got, want)


def _data(html):
    head, rest = html.split("const DATA = ", 1)
    data, tail = rest.split(";\n", 1)
    return head + tail, json.loads(data)


def _close_tree(a, b, path="DATA"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert abs(a - b) <= 1.1e-5, (path, a, b)
    else:
        assert a == b, path


def test_html_viewer_and_export_match_jax(ant, tmp_path):
    jm, tm, frames = ant
    jv = jviewer.HtmlViewer(jm, str(tmp_path / "j.html"))
    tv = tviewer.HtmlViewer(tm, str(tmp_path / "t.html"))
    line = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.5]], np.float32)
    for i, q in enumerate(frames):
        jv.update(JState(joint_q=jnp.asarray(q)), i / 60.0)
        tv.update(TState(joint_q=torch.as_tensor(q)), i / 60.0)
        jv.add_line_strip(line * i, "tendon", i / 60.0)
        tv.add_line_strip(torch.as_tensor(line) * i, "tendon", i / 60.0)
    pairs = [(open(jv.save()).read(), open(tv.save()).read())]
    pairs.append(tuple(open(f(m, q, str(tmp_path / n))).read() for f, m, q, n
                       in ((jviewer.export_html, jm, frames, "je.html"),
                           (tviewer.export_html, tm, torch.as_tensor(frames),
                            "te.html"))))
    for want, got in pairs:
        (wt, wd), (gt, gd) = _data(want), _data(got)
        assert gt == wt and len(gd["bodies"]) == 3
        _close_tree(gd, wd)


def test_trajectory_recorder_npz(tmp_path):
    rec = trender.TrajectoryRecorder()
    rs = np.random.RandomState(2)
    frames = [rs.normal(size=(2, 3)).astype(np.float32) for _ in range(4)]
    for f in frames:
        rec.record(TState(joint_q=torch.as_tensor(f[0]),
                          particle_q=torch.as_tensor(f)),
                   reward=torch.tensor(1.5))
    data = np.load(rec.save(str(tmp_path / "traj.npz")))
    assert sorted(data.files) == ["joint_q", "particle_q", "reward"]
    np.testing.assert_array_equal(data["particle_q"], np.stack(frames))
    np.testing.assert_array_equal(data["joint_q"],
                                  np.stack([f[0] for f in frames]))
    assert data["reward"].shape == (4,)

"""Visualization: time-sampled USD export + raw trajectory recording (port
of diffrl_tpu/render.py).

USD's ASCII encoding (.usda) is plain text, so this module writes stages
directly, without the Pixar ``pxr`` bindings; usdview, Omniverse and
Blender read them. Rendering is off the hot path: ``update()`` copies one
env's state to host numpy (body transforms from the port's ``eval_fk`` on
the state's device) and the stage is serialized once in ``save()``. For
the same frames it writes the same text as the JAX package's renderer.

Exports:
- ``UsdRenderer(model, path)``: ``.update(state, time)`` records particle
  positions (Points prim) and rigid body transforms (one Xform per link with
  its collision shapes as child prims); ``add_sphere/add_box/add_mesh/
  add_line_strip`` mirror the reference's helper API.
- ``TrajectoryRecorder``: appends (joint_q, joint_qd[, particle_q]) frames
  and saves an ``.npz`` — the trajectory-parity fixture format used by tests.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

import torch

from .ops import quat_to_matrix  # noqa: F401  (re-export convenience)
from .sim.articulation import eval_fk
from .sim.model import (
    GEO_BOX,
    GEO_CAPSULE,
    GEO_PLANE,
    GEO_SPHERE,
    Model,
    State,
)


def host(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def body_transforms(model: Model, joint_q) -> np.ndarray:
    """Space-frame body transforms [L, 7] of one env's joint_q [C] (a
    tensor on any device, or array-like, float32)."""
    q = joint_q if isinstance(joint_q, torch.Tensor) else torch.as_tensor(
        np.asarray(joint_q, np.float32))
    with torch.no_grad():
        return host(eval_fk(model, q.detach().to(torch.float32)[None])[0][0])


def _fmt(x):
    return f"{float(x):.6g}"


def _vec3(v):
    return f"({_fmt(v[0])}, {_fmt(v[1])}, {_fmt(v[2])})"


def _quatf(q):
    # USD quatf is (w, x, y, z); we store (x, y, z, w)
    return f"({_fmt(q[3])}, {_fmt(q[0])}, {_fmt(q[1])}, {_fmt(q[2])})"


class _Prim:
    """A USD prim accumulating static attrs and time-sampled attrs."""

    def __init__(self, name: str, type_name: str):
        self.name = name
        self.type_name = type_name
        self.attrs: List[str] = []
        self.samples: Dict[str, Dict[float, str]] = {}
        self.children: Dict[str, "_Prim"] = {}

    def child(self, name: str, type_name: str) -> "_Prim":
        if name not in self.children:
            self.children[name] = _Prim(name, type_name)
        return self.children[name]

    def attr(self, decl: str):
        self.attrs.append(decl)

    def sample(self, attr_decl: str, time: float, value: str):
        self.samples.setdefault(attr_decl, {})[time] = value

    def write(self, out: List[str], indent: str = ""):
        out.append(f'{indent}def {self.type_name} "{self.name}"')
        out.append(indent + "{")
        pad = indent + "    "
        for a in self.attrs:
            out.append(pad + a)
        for decl, ts in self.samples.items():
            out.append(f"{pad}{decl}.timeSamples = {{")
            for t in sorted(ts):
                out.append(f"{pad}    {_fmt(t)}: {ts[t]},")
            out.append(pad + "}")
        for c in self.children.values():
            c.write(out, pad)
        out.append(indent + "}")


class UsdRenderer:
    """Writes a time-sampled USD stage of a simulation (single env).

    API parity with the reference renderer: construct with a Model, call
    ``update(state, time)`` per rendered frame, ``save()`` at the end.
    """

    def __init__(self, model: Model, path: str, fps: float = 60.0,
                 particle_radius: float = 0.1):
        self.model = model
        self.path = path
        self.fps = fps
        self.end_time = 0.0
        self.root = _Prim("root", "Xform")

        if model.particle_count:
            p = self.root.child("particles", "Points")
            p.attr(
                "float[] widths = ["
                + ", ".join([_fmt(2 * particle_radius)] * model.particle_count)
                + "]"
            )

        # static shape prims under per-body Xforms (render.py:150-260)
        self._bodies = {}
        if model.shape_body is not None:
            shape_body = np.asarray(model.shape_body)
            shape_type = np.asarray(model.shape_geo_type)
            shape_scale = np.asarray(model.shape_geo_scale)
            shape_X = np.asarray(model.shape_transform)
            for s in range(shape_body.shape[0]):
                b = int(shape_body[s])
                parent = self._body_prim(b)
                geo = int(shape_type[s])
                scale = shape_scale[s]
                X = shape_X[s]
                prim = None
                if geo == GEO_SPHERE:
                    prim = parent.child(f"shape_{s}", "Sphere")
                    prim.attr(f"double radius = {_fmt(scale[0])}")
                elif geo == GEO_BOX:
                    prim = parent.child(f"shape_{s}", "Cube")
                    prim.attr("double size = 2")
                    prim.attr(
                        f"float3 xformOp:scale = {_vec3(scale)}"
                    )
                elif geo == GEO_CAPSULE:
                    prim = parent.child(f"shape_{s}", "Capsule")
                    prim.attr(f"double radius = {_fmt(scale[0])}")
                    prim.attr(f"double height = {_fmt(2.0 * scale[1])}")
                    prim.attr('uniform token axis = "X"')
                elif geo == GEO_PLANE:
                    prim = parent.child(f"shape_{s}", "Mesh")
                    e = 100.0
                    prim.attr("int[] faceVertexCounts = [4]")
                    prim.attr("int[] faceVertexIndices = [0, 1, 2, 3]")
                    prim.attr(
                        "point3f[] points = ["
                        f"({-e}, 0, {-e}), ({e}, 0, {-e}), "
                        f"({e}, 0, {e}), ({-e}, 0, {e})]"
                    )
                if prim is not None and geo != GEO_PLANE:
                    ops = ['"xformOp:translate"', '"xformOp:orient"']
                    prim.attrs.insert(0, f"double3 xformOp:translate = {_vec3(X[0:3])}")
                    prim.attrs.insert(1, f"quatf xformOp:orient = {_quatf(X[3:7])}")
                    if geo == GEO_BOX:
                        ops.append('"xformOp:scale"')
                    prim.attr(f"uniform token[] xformOpOrder = [{', '.join(ops)}]")

    def _body_prim(self, b: int) -> _Prim:
        if b < 0:
            return self.root
        if b not in self._bodies:
            prim = self.root.child(f"body_{b}", "Xform")
            prim.attr(
                'uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:orient"]'
            )
            self._bodies[b] = prim
        return self._bodies[b]

    # ------------------------------------------------------------- per-frame

    def update(self, state: State, time: float):
        """Record one frame (UsdRenderer.update, render.py:269-334)."""
        self.end_time = max(self.end_time, time)
        t = time * self.fps

        if state.particle_q is not None:
            pts = host(state.particle_q)
            val = "[" + ", ".join(_vec3(p) for p in pts) + "]"
            self.root.child("particles", "Points").sample(
                "point3f[] points", t, val
            )

        if self.model.link_count and self._bodies:
            X_sc = body_transforms(self.model, state.joint_q)
            for b, prim in self._bodies.items():
                prim.sample("double3 xformOp:translate", t, _vec3(X_sc[b, 0:3]))
                prim.sample("quatf xformOp:orient", t, _quatf(X_sc[b, 3:7]))

    # ------------------------------------------------------- manual helpers

    def add_sphere(self, pos, radius: float, name: str, time: float = 0.0):
        prim = self.root.child(name, "Sphere")
        if not prim.attrs:
            prim.attr(f"double radius = {_fmt(radius)}")
            prim.attr('uniform token[] xformOpOrder = ["xformOp:translate"]')
        prim.sample("double3 xformOp:translate", time * self.fps, _vec3(pos))

    def add_box(self, pos, extents, name: str, time: float = 0.0):
        prim = self.root.child(name, "Cube")
        if not prim.attrs:
            prim.attr("double size = 2")
            prim.attr(f"float3 xformOp:scale = {_vec3(extents)}")
            prim.attr(
                'uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:scale"]'
            )
        prim.sample("double3 xformOp:translate", time * self.fps, _vec3(pos))

    def add_mesh(self, name: str, vertices, indices, time: float = 0.0):
        prim = self.root.child(name, "Mesh")
        tris = host(indices).reshape(-1, 3)
        if not prim.attrs:
            prim.attr(
                "int[] faceVertexCounts = [" + ", ".join(["3"] * len(tris)) + "]"
            )
            prim.attr(
                "int[] faceVertexIndices = ["
                + ", ".join(str(int(i)) for i in tris.reshape(-1))
                + "]"
            )
        val = "[" + ", ".join(_vec3(v) for v in host(vertices)) + "]"
        prim.sample("point3f[] points", time * self.fps, val)

    def add_line_strip(self, vertices, name: str, time: float = 0.0,
                       radius: float = 0.01):
        """Muscle/path polylines as BasisCurves (render.py:446-495)."""
        verts = host(vertices)
        prim = self.root.child(name, "BasisCurves")
        if not prim.attrs:
            prim.attr('uniform token type = "linear"')
            prim.attr(f"int[] curveVertexCounts = [{len(verts)}]")
            prim.attr(
                "float[] widths = [" + ", ".join([_fmt(2 * radius)] * len(verts)) + "]"
            )
        val = "[" + ", ".join(_vec3(v) for v in verts) + "]"
        prim.sample("point3f[] points", time * self.fps, val)

    # ------------------------------------------------------------------ io

    def save(self):
        out = [
            "#usda 1.0",
            "(",
            '    defaultPrim = "root"',
            "    startTimeCode = 0",
            f"    endTimeCode = {_fmt(self.end_time * self.fps)}",
            f"    timeCodesPerSecond = {_fmt(self.fps)}",
            '    upAxis = "Y"',
            ")",
            "",
        ]
        self.root.write(out)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            f.write("\n".join(out) + "\n")
        return self.path


class TrajectoryRecorder:
    """Raw trajectory capture for parity fixtures and offline tooling."""

    def __init__(self):
        self.frames: Dict[str, List[np.ndarray]] = {}

    def record(self, state: State, **extra):
        def add(name, arr):
            if arr is not None:
                self.frames.setdefault(name, []).append(host(arr))

        add("joint_q", state.joint_q)
        add("joint_qd", state.joint_qd)
        add("particle_q", state.particle_q)
        add("particle_qd", state.particle_qd)
        for k, v in extra.items():
            add(k, v)

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **{k: np.stack(v) for k, v in self.frames.items()})
        return path

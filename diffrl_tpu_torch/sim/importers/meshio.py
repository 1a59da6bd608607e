"""Minimal triangle-mesh file reader (OBJ / STL), dependency-free (port of
diffrl_tpu/sim/importers/meshio.py, unchanged).

The loader of the URDF importer's <mesh> collision geometry (GEO_MESH
shapes, baked into voxel SDFs for the particles' soft contacts).

Returns (vertices[N,3] float64, faces[M*3] int32 flat index list).
"""

from __future__ import annotations

import os
import struct

import numpy as np


def load_mesh(path):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return _load_obj(path)
    if ext == ".stl":
        return _load_stl(path)
    raise ValueError(f"unsupported mesh format '{ext}' ({path})")


def _load_obj(path):
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                # 'v', 'v/vt', 'v//vn', 'v/vt/vn'; 1-based, negatives allowed
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.extend((idx[0], idx[k], idx[k + 1]))
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)


def _load_stl(path):
    with open(path, "rb") as f:
        blob = f.read()
    # ASCII STLs begin with 'solid' AND parse as text; binary headers may
    # also start with 'solid', so verify the binary size equation first.
    if len(blob) >= 84:
        (n_tris,) = struct.unpack("<I", blob[80:84])
        if len(blob) == 84 + 50 * n_tris:
            return _stl_binary(blob, n_tris)
    return _stl_ascii(blob.decode(errors="replace"))


def _stl_binary(blob, n_tris):
    rec = np.frombuffer(blob, dtype=np.uint8, count=50 * n_tris, offset=84)
    rec = rec.reshape(n_tris, 50)
    tri = rec[:, 12:48].copy().view(np.float32).reshape(n_tris, 3, 3)
    return _dedup(tri.astype(np.float64))


def _stl_ascii(text):
    tri = []
    cur = []
    for line in text.splitlines():
        parts = line.split()
        if parts and parts[0] == "vertex":
            cur.append([float(x) for x in parts[1:4]])
            if len(cur) == 3:
                tri.append(cur)
                cur = []
    return _dedup(np.asarray(tri, dtype=np.float64))


def _dedup(tri_soup):
    """[T,3,3] triangle soup -> unique vertices + flat index list."""
    flat = tri_soup.reshape(-1, 3)
    verts, inverse = np.unique(flat, axis=0, return_inverse=True)
    return verts, inverse.astype(np.int32).reshape(-1)

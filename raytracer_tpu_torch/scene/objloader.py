"""Wavefront .obj loader producing triangle soups (NumPy).

Goes through the native parser (``native/raytpu_native.cpp``), the one the
JAX package uses by default, or with ``RAYTPU_NATIVE=0`` through the
Python parser below (the JAX package's): v / f records, the ``v``,
``v/vt``, ``v//vn`` and ``v/vt/vn`` face forms, negative (relative)
indices, fan triangulation of n-gons; normals and uvs are ignored. With
the library on, a native failure raises (the JAX package falls back to
the Python parser).
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch import knobs, native_bridge


def load_obj(path: str) -> np.ndarray:
    """Parse a .obj file -> f32[T, 3, 3] triangles (v0, v1, v2)."""
    if knobs.native():
        return native_bridge.load_obj(path)
    return load_obj_python(path)


def load_obj_python(path: str) -> np.ndarray:
    """Pure-Python parser (the JAX package's ``load_obj_python``)."""
    verts: list[tuple[float, float, float]] = []
    tris: list[tuple[int, int, int]] = []

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "f":
                idx = [_vertex_index(tok, len(verts)) for tok in parts[1:]]
                # Fan triangulation for polygons with >3 vertices.
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
            # vn / vt / o / g / s / usemtl / mtllib intentionally ignored.

    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int64)
    return v[t]  # [T, 3, 3]


def _vertex_index(token: str, num_verts: int) -> int:
    """'5', '5/2', '5//3', '5/2/3' and negative relative indices -> 0-based."""
    s = token.split("/")[0]
    i = int(s)
    return i - 1 if i > 0 else num_verts + i

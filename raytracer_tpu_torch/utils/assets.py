"""Asset resolution + procedural meshes (NumPy; same generators as the
JAX package's ``utils/assets.py``, so both packages build identical
triangle soups and .obj files).

Mesh names resolve against the caller's ``search`` dirs, then
``$RAYTPU_ASSETS`` and the repo's ``assets/`` dir, as the JAX package
searches its first two. Its third, a fixed path to the upstream reference
checkout's ``objects/`` dir, is left to ``search`` or ``$RAYTPU_ASSETS``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

REPO_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets")


def asset_path(name: str, search: Sequence[str] = ()) -> str:
    """Resolve a mesh filename against ``search`` dirs, then
    ``$RAYTPU_ASSETS`` (read at call time), then the repo's ``assets/``
    dir. Raises FileNotFoundError when absent."""
    if os.path.isabs(name) and os.path.exists(name):
        return name
    dirs = [d for d in (*search, os.environ.get("RAYTPU_ASSETS", ""),
                        REPO_ASSETS) if d]
    for base in dirs:
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"asset not found: {name} (searched {dirs})")


def write_obj(path: str, tris: np.ndarray) -> None:
    """Write a triangle soup as a .obj (3 fresh vertices per face), byte
    for byte as the JAX package writes it."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("# generated by raytracer_tpu\n")
        for tri in tris:
            for v in tri:
                f.write(f"v {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n")
        for i in range(len(tris)):
            f.write(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n")


def make_cube(half: float = 0.5) -> np.ndarray:
    """Unit cube, 12 triangles."""
    h = half
    corners = np.array([
        [-h, -h, h], [h, -h, h], [-h, h, h], [h, h, h],
        [-h, h, -h], [h, h, -h], [-h, -h, -h], [h, -h, -h],
    ], np.float32)
    faces = [
        (0, 1, 3), (0, 3, 2), (2, 3, 5), (2, 5, 4), (4, 5, 7), (4, 7, 6),
        (6, 7, 1), (6, 1, 0), (1, 7, 5), (1, 5, 3), (6, 0, 2), (6, 2, 4),
    ]
    return corners[np.asarray(faces)]


def make_ground_plane() -> np.ndarray:
    """XZ unit plane at y=0, 2 triangles."""
    v = np.array([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]], np.float32)
    return v[np.asarray([(0, 1, 2), (0, 2, 3)])]


def make_terrain(n: int = 158, extent: float = 50.0,
                 height: float = 4.0, seed: int = 7) -> np.ndarray:
    """Bumpy (n-1)x(n-1)x2-triangle heightfield; n=158 -> 49,298 tris."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent, extent, n, dtype=np.float32)
    zs = np.linspace(-extent, extent, n, dtype=np.float32)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = np.zeros_like(x)
    for _ in range(8):
        fx, fz = rng.uniform(0.05, 0.3, 2)
        px, pz = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.2, 1.0) * height
        y += (amp * np.sin(fx * x + px) * np.sin(fz * z + pz)).astype(
            np.float32)
    grid = np.stack([x, y, z], axis=-1)

    a = grid[:-1, :-1]
    b = grid[1:, :-1]
    c = grid[1:, 1:]
    d = grid[:-1, 1:]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2]).astype(np.float32)


def make_icosphere(subdivisions: int = 3, radius: float = 1.0) -> np.ndarray:
    """Icosphere triangle soup: 20 * 4**subdivisions triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    tris = verts[np.asarray(faces)]
    for _ in range(subdivisions):
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        m01 = _slerp_mid(v0, v1)
        m12 = _slerp_mid(v1, v2)
        m20 = _slerp_mid(v2, v0)
        tris = np.concatenate([
            np.stack([v0, m01, m20], axis=1),
            np.stack([v1, m12, m01], axis=1),
            np.stack([v2, m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ])
    return (tris * radius).astype(np.float32)


def _slerp_mid(a, b):
    m = (a + b) / 2.0
    return m / np.linalg.norm(m, axis=-1, keepdims=True)

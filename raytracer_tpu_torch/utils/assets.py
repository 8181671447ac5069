"""Asset resolution + procedural meshes (NumPy; same generators as the
JAX package's ``utils/assets.py``, so both packages build identical
triangle soups)."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

_REPO_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets")


def asset_path(name: str, search: Sequence[str] = ()) -> str:
    """Resolve a mesh filename against ``search`` dirs, then the repo's
    ``assets/`` dir. Raises FileNotFoundError when absent."""
    if os.path.isabs(name) and os.path.exists(name):
        return name
    dirs = [d for d in (*search, _REPO_ASSETS) if d]
    for base in dirs:
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"asset not found: {name} (searched {dirs})")


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

"""Ready-made scenes."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.scene.objloader import load_obj
from raytracer_tpu_torch.utils import assets


def flagship_arrays(search: Sequence[str] = ()):
    """(verts, mats, name) of the ~50k-triangle benchmark scene: the
    reference's FinalBaseMesh scaled by 2 on a ground plane when
    ``assets.asset_path`` finds it, else the procedural terrain
    ``make_terrain(n=158)`` (49,298 triangles). Mirrors the JAX package's
    ``__graft_entry__._flagship_scene``."""
    try:
        body = load_obj(assets.asset_path("FinalBaseMesh.obj", search))
    except FileNotFoundError:
        verts = assets.make_terrain(n=158)
        mats = np.zeros((verts.shape[0], 4), np.float32)
        mats[:, 0:3] = (0.55, 0.5, 0.45)
        return verts, mats, "terrain158"
    body = body * 2.0 + np.array([0, -10, 0], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, body]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:2, 0:3] = (0.5, 0.5, 0.5)          # matte grey floor
    mats[2:, 0:3] = (0.6, 0.7, 0.1)          # metal body
    mats[2:, 3] = 1.0
    return verts, mats, "FinalBaseMesh"


def flagship_scene(device="cuda", search: Sequence[str] = ()) -> FastScene:
    """The flagship scene packed on ``device``; prints which scene it
    used."""
    verts, mats, name = flagship_arrays(search)
    print(f"flagship scene: {name} ({verts.shape[0]} triangles)")
    return build_fast_scene_from_arrays(verts, mats, device=device)


def c12_arrays():
    """(verts, mats) of the ``c12_cube`` benchmark scene (``bench.py``): a
    cube on a ground plane, one matte colour."""
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = (0.8, 0.3, 0.3)
    return verts, mats


def c12_camera(width: int = 640, height: int = 480) -> Camera:
    """The ``c12_cube`` benchmark's fixed camera."""
    return Camera(origin=(-10.0, 6.0, 30.0), look_at=(0.0, -6.0, 0.0),
                  vfov_deg=40.0, aspect_ratio=width / height)

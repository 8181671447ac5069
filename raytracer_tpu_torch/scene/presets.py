"""Ready-made scenes: the five reference configurations (``Preset``,
``ALL_PRESETS``, as the JAX package's ``scene/presets.py`` defines them),
the flagship and ``c12_cube`` benchmark scenes, and a stack-limit tree.

Preset meshes resolve through ``utils.assets``; a mesh that is absent
falls back to a procedural one, written once as an .obj into the port's
own cache dir so presets stay plain ``ModelInstance`` lists (JSON
serialisable).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from raytracer_tpu_torch.bvh.bvh4 import STACK_CAP, nodes4_stack_need
from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, LEAF_CID_BITS,
                                                 FastScene)
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.scene.objloader import load_obj
from raytracer_tpu_torch.scene.scene import ModelInstance, Scene
from raytracer_tpu_torch.utils import assets


@dataclasses.dataclass
class Preset:
    name: str
    scene: Scene
    camera: Camera
    config: RenderConfig
    sky_enabled: bool = True
    exposure: float = 0.0


def _procedural_obj(name: str, tris: np.ndarray) -> str:
    """A generated mesh as an .obj in the port's cache dir
    (``raytpu_torch_assets`` under the temp dir). The file is written
    under a temporary name and moved into place, so no reader (another
    process, or the JAX package's cache) ever sees it half written."""
    cache = os.path.join(tempfile.gettempdir(), "raytpu_torch_assets")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, name)
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".part",
                                   dir=cache)
        os.close(fd)
        try:
            assets.write_obj(tmp, tris)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def _asset_or(name: str, fallback_tris) -> str:
    try:
        return assets.asset_path(name)
    except FileNotFoundError:
        return _procedural_obj(name, fallback_tris())


def _ground(y=-10.0, extent=150.0, color=(0.5, 0.5, 0.5)) -> ModelInstance:
    return ModelInstance(
        model_path=_asset_or("ground_plane.obj", assets.make_ground_plane),
        display_name="Ground Plane", position=(0.0, y, 0.0),
        scale=(extent, 1.0, extent), color=color, material_type=0.0)


def config1_cube_plane(width=640, height=480) -> Preset:
    """Cube + ground plane, matte, sky, fixed camera, single bounce."""
    scene = Scene([
        _ground(),
        ModelInstance(model_path=_asset_or("cube.obj", assets.make_cube),
                      display_name="Cube", position=(0.0, -6.0, 0.0),
                      scale=(6.0, 6.0, 6.0), color=(1.0, 0.2, 0.2)),
    ])
    cam = Camera(origin=(-25.0, 30.0, 140.0), look_at=(0.0, -4.0, 0.0),
                 vfov_deg=20.0, aspect_ratio=width / height)
    return Preset("cube_plane", scene, cam,
                  RenderConfig(width=width, height=height, max_bounces=1))


def config2_sphere_light(width=640, height=480) -> Preset:
    """Metal sphere + plane lit by an emissive sphere, no sky."""
    scene = Scene([
        _ground(),
        ModelInstance(
            model_path=_procedural_obj("icosphere3.obj",
                                       assets.make_icosphere(3, 5.0)),
            display_name="Metal Sphere", position=(0.0, -5.0, 0.0),
            color=(0.8, 0.8, 0.9), material_type=1.0),
        ModelInstance(
            model_path=_procedural_obj("icosphere2.obj",
                                       assets.make_icosphere(2, 3.0)),
            display_name="Light", position=(12.0, 14.0, 6.0),
            color=(4.0, 4.0, 4.0), material_type=3.0),
    ])
    cam = Camera(origin=(-20.0, 12.0, 60.0), look_at=(0.0, -4.0, 0.0),
                 vfov_deg=25.0, aspect_ratio=width / height)
    return Preset("sphere_light", scene, cam,
                  RenderConfig(width=width, height=height), sky_enabled=False)


def config3_moon(width=1280, height=720) -> Preset:
    """Emissive Moon.obj (icosphere fallback) over a plane, no sky,
    1280x720."""
    scene = Scene([
        _ground(color=(0.4, 0.4, 0.45)),
        ModelInstance(
            model_path=_asset_or("Moon.obj",
                                 lambda: assets.make_icosphere(3, 1.0)),
            display_name="Moon", position=(0.0, 6.0, 0.0),
            scale=(10.0, 10.0, 10.0), color=(2.5, 2.4, 2.2),
            material_type=3.0),
    ])
    cam = Camera(origin=(-25.0, 30.0, 140.0), look_at=(0.0, 0.0, 0.0),
                 vfov_deg=20.0, aspect_ratio=width / height)
    return Preset("moon_emissive", scene, cam,
                  RenderConfig(width=width, height=height),
                  sky_enabled=False)


def config4_two_humans(width=1280, height=720) -> Preset:
    """Two FinalBaseMesh figures side by side (the terrain
    ``make_terrain(n=158)`` stands in for the mesh when it is absent)."""
    body = _asset_or("FinalBaseMesh.obj",
                     lambda: assets.make_terrain(n=158))
    scene = Scene([
        _ground(),
        ModelInstance(model_path=body, display_name="Human",
                      position=(-9.0, -10.0, 0.0), scale=(2.0, 2.0, 2.0),
                      color=(0.7, 0.6, 0.5)),
        ModelInstance(model_path=body, display_name="Human2",
                      position=(9.0, -10.0, 2.0), scale=(2.0, 2.0, 2.0),
                      color=(0.5, 0.55, 0.7)),
    ])
    cam = Camera(origin=(-25.0, 30.0, 140.0), look_at=(0.0, 8.0, 0.0),
                 vfov_deg=25.0, aspect_ratio=width / height)
    return Preset("two_humans", scene, cam,
                  RenderConfig(width=width, height=height))


def config5_car_showcase(width=1920, height=1080) -> Preset:
    """Mixed Lambertian / metal / emissive, exposure +0.5, 1920x1080: the
    car slot holds ``white_mesh.obj`` (an icosphere when absent), beside a
    background terrain and an emissive sun."""
    scene = Scene([
        _ground(color=(0.35, 0.35, 0.35)),
        ModelInstance(
            model_path=_asset_or("white_mesh.obj",
                                 lambda: assets.make_icosphere(4, 6.0)),
            display_name="Car", position=(0.0, -8.0, 0.0),
            scale=(2.0, 2.0, 2.0), color=(0.6, 0.7, 0.1),
            material_type=1.0),
        ModelInstance(
            model_path=_procedural_obj("terrain_bg2.obj",
                                       assets.make_terrain(n=120,
                                                           extent=120.0,
                                                           height=2.0)),
            display_name="Terrain", position=(0.0, -14.0, -120.0),
            scale=(1.0, 0.6, 1.0), color=(0.45, 0.5, 0.4)),
        ModelInstance(
            model_path=_procedural_obj("icosphere2.obj",
                                       assets.make_icosphere(2, 3.0)),
            display_name="Sun", position=(30.0, 60.0, 20.0),
            scale=(4.0, 4.0, 4.0), color=(5.0, 4.8, 4.5),
            material_type=3.0),
    ])
    cam = Camera(origin=(-14.0, 4.0, 42.0), look_at=(0.0, -4.0, 0.0),
                 vfov_deg=30.0, aspect_ratio=width / height)
    return Preset("car_showcase", scene, cam,
                  RenderConfig(width=width, height=height), exposure=0.5)


def reference_default_scene() -> Scene:
    """``scene.default_scene`` (a grey ground plane and a metal car) with
    the presets' fallbacks: ``car.obj``, else ``white_mesh.obj``, else the
    ``car_showcase`` icosphere."""
    try:
        car = assets.asset_path("car.obj")
    except FileNotFoundError:
        car = _asset_or("white_mesh.obj",
                        lambda: assets.make_icosphere(4, 6.0))
    return Scene([
        _ground(),
        ModelInstance(model_path=car, display_name="Car",
                      position=(0.0, -8.0, 0.0), scale=(2.0, 2.0, 2.0),
                      color=(0.6, 0.7, 0.1), material_type=1.0),
    ])


ALL_PRESETS = {
    "cube_plane": config1_cube_plane,
    "sphere_light": config2_sphere_light,
    "moon_emissive": config3_moon,
    "two_humans": config4_two_humans,
    "car_showcase": config5_car_showcase,
}


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


# Chain levels of ``stack_limit_scene`` at each wide width: the deepest
# chain node's depth (levels - 1) gives a stack need of 253 at width 8
# and 256 at width 16.
CHAIN_LEVELS = {8: 36, 16: 17}


def _wide_child(row, slot, zoff, meta):
    """Child ``slot`` of a wide row: the box [-20, 20]^2 x [zoff - 20,
    zoff + 20] and its meta."""
    row[16 * slot:16 * slot + 6] = (-20, -20, zoff - 20, 20, 20, zoff + 20)
    row[16 * slot + 6] = meta


def stack_limit_scene(n_rays: int, device="cuda", seed: int = 0,
                      width: int = 8):
    """A hand-built ``width``-wide tree (8 or 16) that drives the walk's
    stack to its limit -> (FastScene, rays f32[6, n_rays]).

    At width 8, levels 0-34 of a chain each hold 8 internal children whose
    boxes contain every ray that is meant to hit: the next chain node,
    whose box centre has the smallest key ``(min + max) . d`` for the
    rays' +z directions (so it is pushed last and popped first), and 7
    small nodes, each with two leaf children over a 2-cluster table. Each
    level leaves 7 entries on the stack, so a walk reaches 7 * 34 + 8 =
    246 slots; level 35 holds the two leaves. Depth 35 gives a stack need
    of 253 (``bvh4.nodes4_stack_need``). At width 16 the chain has levels
    0-16 of 16 children each (15 small nodes a level): a walk reaches 15
    * 15 + 16 = 241 slots, and depth 16 gives a need of 256, the whole
    stack. One ray in eight starts beside the boxes and misses them
    all."""
    leaf = lambda cid, count: -((cid | ((count - 1) << LEAF_CID_BITS)) + 1)
    rows = []

    def node():
        rows.append(np.zeros(width * 16, np.float32))
        return len(rows) - 1

    chain = [node() for _ in range(CHAIN_LEVELS[width])]
    for lvl, nid in enumerate(chain[:-1]):
        chain_slot = lvl % width
        rank = 1
        for slot in range(width):
            if slot == chain_slot:
                _wide_child(rows[nid], slot, 0.0, chain[lvl + 1] + 1)
                continue
            small = node()
            _wide_child(rows[small], 0, 0.0, leaf(0, 1))
            _wide_child(rows[small], 1, 0.0, leaf(1, 6))
            _wide_child(rows[nid], slot, float(rank), small + 1)
            rank += 1
    _wide_child(rows[chain[-1]], 0, 0.0, leaf(1, 6))
    _wide_child(rows[chain[-1]], 1, 0.0, leaf(0, 1))
    nodes4 = np.stack(rows).reshape(-1, CLUSTER_ROW)

    # Cluster 0: one triangle across the boxes at z = 15. Cluster 1: six
    # triangles; the closest (z = 12) sits in the second half, beside a
    # degenerate one and two far ones.
    def tri(v0, v1, v2, albedo, mtype):
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        e1, e2 = v1 - v0, v2 - v0
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else n
        return np.concatenate([v0, e1, e2, albedo, [mtype], n])

    big = lambda z: ((-40, -40, z), (80, -40, z), (-40, 80, z))
    clusters = np.zeros((2, CLUSTER_ROW), np.float32)
    clusters[0, 0:16] = tri(*big(15.0), (0.9, 0.2, 0.2), 0.0)
    recs = [tri(*big(18.0), (0.2, 0.9, 0.2), 1.0),
            tri((0, 0, 14), (1, 1, 14), (2, 2, 14), (0.5, 0.5, 0.5), 0.0),
            tri(*big(19.0), (0.2, 0.2, 0.9), 2.0),
            tri((30, 30, 13), (31, 30, 13), (30, 31, 13), (1, 1, 1), 3.0),
            tri(*big(16.0), (0.7, 0.7, 0.1), 1.0),
            tri(*big(12.0), (0.6, 0.3, 0.9), 2.0)]
    for k, rec in enumerate(recs):
        clusters[1, 16 * k:16 * k + 16] = rec

    need = nodes4_stack_need(nodes4, width)
    assert need == {8: 253, 16: 256}[width] and need <= STACK_CAP, need
    nodes8 = np.zeros((64, 8), np.float32)      # the all-miss binary table
    nodes8[:, 0:3], nodes8[:, 3:6] = 1e30, -1e30
    nodes8[:, 6] = np.full((), 1, np.int32).view(np.float32)

    r = np.random.default_rng(seed)
    o = np.empty((3, n_rays), np.float32)
    o[0:2] = r.uniform(-5.0, 5.0, (2, n_rays))
    o[2] = -60.0
    o[0, ::8] = 100.0
    d = np.empty((3, n_rays), np.float32)
    d[0:2] = r.uniform(-0.05, 0.05, (2, n_rays))
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    scene = FastScene(nodes8=put(nodes8), clusters=put(clusters),
                      nodes4=put(nodes4), num_nodes=1, num_triangles=7,
                      num_nodes4=len(rows), wide_width=width)
    return scene, put(np.concatenate([o, d]).astype(np.float32))

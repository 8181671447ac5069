"""Ready-made scenes."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from raytracer_tpu_torch.bvh.bvh4 import STACK_CAP, nodes4_stack_need
from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, LEAF_CID_BITS,
                                                 WIDE_WIDTH, FastScene)
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


# The chain of ``stack_limit_scene``: 36 levels, the deepest tree whose
# need (7 * 36 + 1 = 253) stays under STACK_CAP.
CHAIN_LEVELS = 36


def _wide_child(row, slot, zoff, meta):
    """Child ``slot`` of a wide row: the box [-20, 20]^2 x [zoff - 20,
    zoff + 20] and its meta."""
    row[16 * slot:16 * slot + 6] = (-20, -20, zoff - 20, 20, 20, zoff + 20)
    row[16 * slot + 6] = meta


def stack_limit_scene(n_rays: int, device="cuda", seed: int = 0):
    """A hand-built wide tree that drives the walk's stack to its limit ->
    (FastScene, rays f32[6, n_rays]).

    Levels 0-34 of a chain each hold 8 internal children whose boxes
    contain every ray that is meant to hit: the next chain node, whose box
    centre has the smallest key ``(min + max) . d`` for the rays' +z
    directions (so it is pushed last and popped first), and 7 small
    nodes, each with two leaf children over a 2-cluster table. Each level
    leaves 7 entries on the stack, so a walk reaches 7 * 34 + 8 = 246
    slots; level 35 holds the two leaves. Depth 35 gives a stack need of
    253 (``bvh4.nodes4_stack_need``). One ray in eight starts beside the
    boxes and misses them all."""
    leaf = lambda cid, count: -((cid | ((count - 1) << LEAF_CID_BITS)) + 1)
    rows = []

    def node():
        rows.append(np.zeros(WIDE_WIDTH * 16, np.float32))
        return len(rows) - 1

    chain = [node() for _ in range(CHAIN_LEVELS)]
    for lvl, nid in enumerate(chain[:-1]):
        chain_slot = lvl % WIDE_WIDTH
        rank = 1
        for slot in range(WIDE_WIDTH):
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
    nodes4 = np.stack(rows)

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

    need = nodes4_stack_need(nodes4)
    assert need == 253 and need <= STACK_CAP, need
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
                      num_nodes4=nodes4.shape[0])
    return scene, put(np.concatenate([o, d]).astype(np.float32))

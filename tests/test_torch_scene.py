"""The port's scene tables against the JAX package's, byte for byte.

Both packages build from the same triangle soup with the same native
builder; every FastScene leaf must match exactly (compared as i32 bits,
so the bitcast link columns and the count-encoded wide metas count too).
The JAX builder computes nothing through XLA, so it runs in-process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               fast_scene_from_numpy,
                                               pack_tri_records)
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

TABLES = ("nodes8", "clusters", "nodes4")
COUNTS = ("num_nodes", "num_triangles", "num_nodes4")


def _cube_plane():
    cube = assets.make_cube() * 4.0 + np.array([0.0, -6.0, 0.0], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0.0, -10.0, 0.0], np.float32))
    verts = np.concatenate([plane, cube]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:2, 0:3] = (0.5, 0.5, 0.5)
    mats[2:, 0:3] = (1.0, 0.2, 0.2)
    mats[2:, 3] = 1.0
    return verts, mats


def _terrain():
    verts = assets.make_terrain(n=40)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = (0.55, 0.5, 0.45)
    mats[::7, 3] = 2.0
    return verts, mats


def _empty():
    return np.zeros((0, 3, 3), np.float32), np.zeros((0, 4), np.float32)


def _jax_leaves(verts, mats):
    from raytracer_tpu.scene.builder import \
        build_fast_scene_from_arrays as jax_build

    fs = jax_build(verts, mats)
    return {name: np.asarray(getattr(fs, name)) for name in TABLES + COUNTS}


@pytest.mark.parametrize("make", [_cube_plane, _terrain, _empty],
                         ids=["cube_plane", "terrain40", "empty"])
def test_tables_equal_jax_bytes(make):
    verts, mats = make()
    ref = _jax_leaves(verts, mats)
    got = build_fast_scene_from_arrays(verts, mats, device="cpu")
    for name in TABLES:
        t = getattr(got, name).numpy()
        assert t.shape == ref[name].shape, name
        np.testing.assert_array_equal(t.view(np.int32),
                                      ref[name].view(np.int32), err_msg=name)
    for name in COUNTS:
        assert getattr(got, name) == int(ref[name]), name


def test_fast_scene_from_numpy_round_trip():
    ref = _jax_leaves(*_terrain())
    fs = fast_scene_from_numpy(ref, device="cpu")
    for name in TABLES:
        assert getattr(fs, name).numpy().tobytes() == ref[name].tobytes()
    assert [getattr(fs, n) for n in COUNTS] == [int(ref[n]) for n in COUNTS]


def test_pack_tri_records_matches_jax():
    from raytracer_tpu.scene.builder import pack_tri_records as jax_pack

    verts, mats = _terrain()
    got = pack_tri_records(verts.reshape(-1, 9), mats)
    np.testing.assert_array_equal(got.view(np.int32),
                                  jax_pack(verts.reshape(-1, 9),
                                           mats).view(np.int32))


def test_cluster_rows_are_packed_records():
    """Each used cluster slot holds pack_tri_records of one input
    triangle (the native packer's layout)."""
    verts, mats = _cube_plane()
    fs = build_fast_scene_from_arrays(verts, mats, device="cpu")
    recs = pack_tri_records(verts.reshape(-1, 9), mats)
    slots = fs.clusters.numpy().reshape(-1, 16)
    used = slots[np.abs(slots).sum(1) > 0]
    assert used.shape[0] == verts.shape[0]
    for row in used:
        assert (recs == row).all(1).any()


@pytest.mark.parametrize("make", [_cube_plane, _terrain, _empty],
                         ids=["cube_plane", "terrain40", "empty"])
def test_cluster_counts_are_the_builders_leaf_sizes(make):
    """FastScene.cluster_counts, derived from the cluster rows, is the
    triangle count the BVH builder gave each leaf (cluster ids in leaf
    order), 0 on padding rows and on the empty scene's all-zero row; a
    scene made from the JAX package's leaves derives the same counts."""
    from raytracer_tpu_torch.bvh.build import build_bvh
    from raytracer_tpu_torch.core.fast_types import DEFAULT_LAYOUT

    verts, mats = make()
    fs = build_fast_scene_from_arrays(verts, mats, device="cpu")
    want = np.zeros(fs.clusters.shape[0], np.int32)
    if verts.shape[0]:
        bvh = build_bvh(verts, leaf_size=DEFAULT_LAYOUT[0])
        ntri = bvh.node_ntri[bvh.node_tri >= 0]
        want[:ntri.size] = ntri
        assert want.sum() == verts.shape[0]
    got = fs.cluster_counts
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    leaves = {n: getattr(fs, n).numpy() for n in TABLES}
    leaves.update({n: getattr(fs, n) for n in COUNTS})
    np.testing.assert_array_equal(
        fast_scene_from_numpy(leaves, device="cpu").cluster_counts.numpy(),
        want)


def test_import_pulls_in_no_jax():
    """Every module of the port imports without JAX, the JAX package or
    Triton (the new scene, utils and per-ray modules among them)."""
    code = ("import importlib, pkgutil, sys\n"
            "import raytracer_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, 'raytracer_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "for name in ('scene.scene', 'scene.builder', 'scene.presets',\n"
            "             'kernels.tracer', 'utils.config', 'utils.log',\n"
            "             'utils.profiler', 'utils.assets',\n"
            "             'apps.headless'):\n"
            "    assert 'raytracer_tpu_torch.' + name in names, name\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'raytracer_tpu' not in sys.modules\n"
            "assert 'triton' not in sys.modules\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)

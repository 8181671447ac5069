"""The host BVH builders and the knobs that pick them: ``RAYTPU_BVH``
(``sah``, ``median``, ``sbvh``, ``ploc``), ``RAYTPU_NATIVE=0`` (NumPy
builds, NumPy cluster packing, the Python ``.obj`` parser) and
``RAYTPU_LEAF_COUNTS=0`` (full counts in the wide leaf metas).

On a soup of 600 long thin random triangles (the JAX package's SBVH test
soup: plenty of straddlers, so spatial splits fire), each configuration's
host tree (``bvh/build.build_bvh`` at leaf size 8, ``order`` included) and packed
tables (``build_fast_scene_from_arrays``) equal the JAX package's under
the same knobs: 0 differing bytes in ``nodes8``, ``nodes4`` and the
cluster records, the unit normals within 2 ulp (``assert_scene_tables``).
The JAX references come from one child process (no Pallas). Port-only:
the NumPy median tree has the native one's boxes, skip links and leaves
(on a soup without centroid ties, where the two partitions agree, as the
JAX package's own test holds them) and the NumPy PLOC tree is the native
one, NumPy packing equals native packing, the Python ``.obj`` parser
equals the native one, and a native failure raises (the JAX package
would fall back)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_jax_refs import assert_scene_tables, run_jobs

from raytracer_tpu_torch import knobs, native_bridge
from raytracer_tpu_torch.bvh.build import HostBVH, build_bvh
from raytracer_tpu_torch.core.fast_types import DEFAULT_LAYOUT
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.scene.objloader import load_obj
from raytracer_tpu_torch.utils import assets

CLUSTER_SIZE, WIDE_WIDTH = DEFAULT_LAYOUT

torch.set_num_threads(2)

CONFIGS = {
    "sah": {"RAYTPU_BVH": "sah"},
    "median": {"RAYTPU_BVH": "median"},
    "sbvh": {"RAYTPU_BVH": "sbvh"},
    "ploc": {"RAYTPU_BVH": "ploc"},
    "numpy": {"RAYTPU_NATIVE": "0"},
    "numpy_ploc": {"RAYTPU_NATIVE": "0", "RAYTPU_BVH": "ploc"},
    "full_counts": {"RAYTPU_LEAF_COUNTS": "0"},
}


def _soup(n: int = 600, seed: int = 7):
    """n long thin random triangles (stretched along x) and materials of
    every type."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 1, 3)).astype(np.float32)
    span = rng.normal(size=(n, 3, 3)).astype(np.float32)
    span[:, :, 0] *= 8.0
    mats = rng.uniform(0.2, 0.9, (n, 4)).astype(np.float32)
    mats[:, 3] = rng.integers(0, 4, n)
    return (base + span * 0.5).astype(np.float32), mats


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    verts, mats = _soup()
    out = run_jobs([("host_bvh", dict(verts=verts, mats=mats), env)
                    for env in CONFIGS.values()],
                   tmp_path_factory.mktemp("host_bvh"))
    return dict(zip(CONFIGS, out))


def _host(bvh: HostBVH) -> dict:
    return {f.name: getattr(bvh, f.name) for f in dataclasses.fields(bvh)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tables_match_jax(refs, monkeypatch, name):
    ref = refs[name]
    for k, v in CONFIGS[name].items():
        monkeypatch.setenv(k, v)
    verts, mats = _soup()
    bvh = build_bvh(verts, leaf_size=CLUSTER_SIZE)
    for k, v in _host(bvh).items():
        np.testing.assert_array_equal(v, ref[f"bvh_{k}"], err_msg=k)
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    assert_scene_tables(scene, ref, "scene_")
    counts = -scene.nodes4.view(-1, WIDE_WIDTH, 16)[:, :, 6] - 1
    leaf_counts = (counts[counts >= 0].to(torch.int64) >> 20) + 1
    if name == "full_counts":
        assert (leaf_counts == CLUSTER_SIZE).all()
    else:
        assert (leaf_counts < CLUSTER_SIZE).any()
    if name == "sbvh":
        # Spatial splits reference a straddling triangle from several
        # leaves: order repeats ids and is longer than the soup.
        assert len(bvh.order) > verts.shape[0]
        assert len(np.unique(bvh.order)) == verts.shape[0]


def test_numpy_median_tree_equals_native(monkeypatch):
    rng = np.random.default_rng(3)
    tris = (rng.uniform(-10, 10, (500, 1, 3))
            + rng.uniform(-0.5, 0.5, (500, 3, 3))).astype(np.float32)
    native = build_bvh(tris, leaf_size=CLUSTER_SIZE, method="median")
    monkeypatch.setenv("RAYTPU_NATIVE", "0")
    numpy_ = build_bvh(tris, leaf_size=CLUSTER_SIZE, method="median")
    for k in ("node_min", "node_max", "node_tri", "node_ntri", "node_skip"):
        np.testing.assert_array_equal(getattr(numpy_, k), getattr(native, k),
                                      err_msg=k)
    # Each leaf holds the same triangles (in either partition order).
    for start, cnt in zip(native.node_tri, native.node_ntri):
        if start >= 0:
            assert (sorted(numpy_.order[start:start + cnt])
                    == sorted(native.order[start:start + cnt]))


def test_numpy_ploc_tree_equals_native(monkeypatch):
    for tris in (_soup()[0], assets.make_terrain(n=20).astype(np.float32)):
        native = _host(build_bvh(tris, leaf_size=CLUSTER_SIZE,
                                 method="ploc"))
        with monkeypatch.context() as mp:
            mp.setenv("RAYTPU_NATIVE", "0")
            numpy_ = _host(build_bvh(tris, leaf_size=CLUSTER_SIZE,
                                     method="ploc"))
        for k in native:
            np.testing.assert_array_equal(numpy_[k], native[k], err_msg=k)


def test_numpy_packing_equals_native(monkeypatch):
    """Under the PLOC tree (the same in both), NumPy cluster packing gives
    the native packer's tables."""
    monkeypatch.setenv("RAYTPU_BVH", "ploc")
    verts, mats = _soup()
    native = build_fast_scene_from_arrays(verts, mats, device="cpu")
    monkeypatch.setenv("RAYTPU_NATIVE", "0")
    numpy_ = build_fast_scene_from_arrays(verts, mats, device="cpu")
    leaves = {k: getattr(native, k).numpy()
              for k in ("nodes8", "nodes4", "clusters")}
    leaves.update(num_nodes=native.num_nodes,
                  num_triangles=native.num_triangles,
                  num_nodes4=native.num_nodes4)
    assert_scene_tables(numpy_, leaves)


def test_python_obj_parser_equals_native(tmp_path, monkeypatch):
    path = tmp_path / "forms.obj"
    path.write_text(
        "# every face form\n"
        "o thing\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1.5\n"
        "vt 0 0\nvt 1 0\nvn 0 0 1\n"
        "f 1 2 3\nf 1/1 3/2 4/1\nf 1//1 2//1 5//1\n"
        "f 2/1/1 3/2/1 5/1/1\ns off\nf -5 -4 -3 -2\nf -1 -2 -3\n")
    native = load_obj(str(path))
    monkeypatch.setenv("RAYTPU_NATIVE", "0")
    python = load_obj(str(path))
    assert native.shape == (7, 3, 3) and native.dtype == np.float32
    np.testing.assert_array_equal(python, native)
    with pytest.raises(FileNotFoundError):
        load_obj(str(tmp_path / "missing.obj"))


def test_native_failure_raises(monkeypatch):
    """With the native library on, a failed build raises: no fallback
    tree (the JAX package logs it and builds the NumPy median tree)."""
    lib = native_bridge._load()

    class Failing:
        """The library with every build returning -1."""

        def __getattr__(self, name):
            if name.startswith("rt_build_bvh"):
                return lambda *args: -1
            return getattr(lib, name)

    monkeypatch.setattr(native_bridge, "_load", lambda: Failing())
    verts, _ = _soup()
    for method in knobs.BVH_METHODS:
        with pytest.raises(RuntimeError, match="native"):
            build_bvh(verts, leaf_size=CLUSTER_SIZE, method=method)


def test_unknown_method_raises(monkeypatch):
    monkeypatch.setenv("RAYTPU_BVH", "octree")
    with pytest.raises(NotImplementedError, match="RAYTPU_BVH"):
        build_bvh(_soup()[0], leaf_size=CLUSTER_SIZE)

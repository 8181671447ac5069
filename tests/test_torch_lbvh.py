"""The port's on-device LBVH (``bvh/lbvh.py``) against the JAX package's.

One JAX child process (``torch_jax_refs.run_jobs``, eager XLA, no Pallas)
computes every reference from inputs made here from a numpy seed. Integer
outputs must match exactly; the scene tables to 0 differing bytes except
the normal columns (2 ulp).
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.bvh import lbvh
from raytracer_tpu_torch.utils import assets
from torch_jax_refs import assert_scene_tables, run_jobs

torch.set_num_threads(2)

CODE_SETS = ("random", "duplicate", "two")


def _soup():
    """Plane, cube and icosphere with varied materials, padded to a
    cluster-row multiple (336 triangles)."""
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    sphere = assets.make_icosphere(2, 3.0) + np.array([6, -3, 2], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube, sphere]).astype(np.float32)
    r = np.random.default_rng(11)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = r.uniform(0.1, 0.9, (verts.shape[0], 3))
    mats[:, 3] = r.integers(0, 4, verts.shape[0])
    return lbvh.pad_to_cluster_multiple(verts, mats)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = np.random.default_rng(7)
    clz_in = np.concatenate([
        np.array([0, 1, 2, 3, 255, 1 << 20, 2**31 - 1, 2**31, 2**31 + 5,
                  2**32 - 1], np.uint32),
        r.integers(0, 2**32, 64, dtype=np.uint32)])
    unit = r.random((3, 512), dtype=np.float32)
    unit[:, :4] = [-0.25, 0.0, 0.9999, 1.5]
    codes = {"random": np.sort(r.integers(0, 2**30, 100, dtype=np.uint32)),
             "duplicate": np.array([5, 5, 5, 5, 9, 9, 1000, 1000],
                                   np.uint32),
             "two": np.array([1, 2], np.uint32)}
    codes["random"][40:48] = codes["random"][40]   # a run of duplicates
    leaf_lo = r.uniform(-10, 10, 100).astype(np.float32)
    leaf_hi = leaf_lo + r.uniform(0, 5, 100).astype(np.float32)
    all_lo = r.uniform(-10, 10, (199, 3)).astype(np.float32)
    all_hi = all_lo + r.uniform(0, 5, (199, 3)).astype(np.float32)
    verts, mats = _soup()
    inp = dict(clz_in=clz_in, unit=unit, code_sets=np.array(CODE_SETS),
               leaf_lo=leaf_lo, leaf_hi=leaf_hi, all_lo=all_lo,
               all_hi=all_hi, verts=verts, mats=mats,
               **{f"codes_{k}": v for k, v in codes.items()})
    (out,) = run_jobs([("lbvh", inp, None)],
                      tmp_path_factory.mktemp("lbvh"))
    return inp, out


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_clz32_matches_jax(ref):
    inp, out = ref
    got = lbvh._clz32(_t(inp["clz_in"])).numpy()
    np.testing.assert_array_equal(got, out["clz"])
    assert got[0] == 32 and got[7] == 0 and got[-66] == 0


def test_morton30_matches_jax(ref):
    inp, out = ref
    got = lbvh.morton30(*(torch.from_numpy(u) for u in inp["unit"]))
    np.testing.assert_array_equal(got.numpy(), out["morton"])


@pytest.mark.parametrize("name", CODE_SETS)
def test_karras_tables_match_jax(ref, name):
    """Fixed-count searches (no host read per step) give the JAX while
    loops' tables, duplicates and the two-leaf tree included."""
    inp, out = ref
    got = lbvh.build_lbvh_tables(_t(inp[f"codes_{name}"]))
    for key, t in zip(("left", "right", "first", "last", "parent"), got):
        np.testing.assert_array_equal(t.numpy(), out[f"{name}_{key}"],
                                      err_msg=key)


def test_range_minmax_matches_jax(ref):
    inp, out = ref
    first, last = (_t(out[f"random_{k}"]) for k in ("first", "last"))
    mn, mx = lbvh._range_minmax(torch.from_numpy(inp["leaf_lo"]),
                                torch.from_numpy(inp["leaf_hi"]), first,
                                last)
    assert mn.numpy().tobytes() == out["range_min"].tobytes()
    assert mx.numpy().tobytes() == out["range_max"].tobytes()


def test_emit_wide_device_matches_jax(ref):
    inp, out = ref
    left, right, parent = (_t(out[f"random_{k}"])
                           for k in ("left", "right", "parent"))
    table, n_wide, depth = lbvh.emit_wide_device(
        left, right, parent, torch.from_numpy(inp["all_lo"]),
        torch.from_numpy(inp["all_hi"]), len(inp["codes_random"]),
        cluster_size=8)
    assert table.numpy().tobytes() == out["wide_table"].tobytes()
    assert int(n_wide) == int(out["wide_n"])
    assert int(depth[0]) == 0 and int(depth.max()) < 128


@pytest.mark.parametrize("tag,n", [("soup", None), ("one", 8)],
                         ids=["soup336", "one_cluster"])
def test_build_fast_scene_device_matches_jax(ref, tag, n):
    inp, out = ref
    fs = lbvh.build_fast_scene_device(torch.from_numpy(inp["verts"][:n]),
                                      torch.from_numpy(inp["mats"][:n]))
    assert_scene_tables(fs, out, f"{tag}_")


def test_lbvh_refuses_a_tree_past_the_stack(ref, monkeypatch):
    inp, _ = ref
    monkeypatch.setattr(lbvh, "STACK_CAP", 8)
    with pytest.raises(ValueError, match="STACK_CAP"):
        lbvh.build_fast_scene_device(torch.from_numpy(inp["verts"]),
                                     torch.from_numpy(inp["mats"]))


def test_device_tables_need_a_row_multiple():
    verts, mats = _soup()
    with pytest.raises(ValueError, match="cluster-row"):
        lbvh.device_tables(torch.from_numpy(verts[:9]),
                           torch.from_numpy(mats[:9]), 8)
    v, m = lbvh.pad_to_cluster_multiple(verts[:9], mats[:9])
    assert v.shape[0] == 16 and not v[9:].any() and not m[9:].any()

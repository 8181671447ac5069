"""The port's captured-topology refit (``scene/refit.py``) against the
JAX package's.

One JAX child process (``torch_jax_refs.run_jobs``, XLA, no Pallas)
captures two terrain instances (one mirrored in y) with the ``sah`` and
``ploc`` host trees and refits them at the capture pose and after an
edit. The port must capture the same tables and, from the JAX package's
capture (``refit_scene_from_numpy``) and from its own, refit to the same
scene tables: 0 differing bytes except the normal columns (2 ulp).
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.scene import refit
from raytracer_tpu_torch.utils import assets
from torch_jax_refs import assert_scene_tables, run_jobs

torch.set_num_threads(2)

METHODS = ("sah", "ploc")


def _meshes():
    tris = assets.make_terrain(n=24)
    return [tris, tris[: tris.shape[0] // 2]]


PARAMS = np.array([[1, 1, 1, 0, 0, 0, 0.7, 0.6, 0.5, 0],
                   [2, -1.5, 1, 5, 1, -3, 0.5, 0.6, 0.7, 1]], np.float32)
MOVED = PARAMS.copy()
MOVED[1, 3:6] = (8.5, 2.0, -1.0)


def _tuples(p):
    return [(r[0:3], r[3:6], r[6:9], r[9]) for r in p]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    meshes = _meshes()
    inp = dict(n_meshes=len(meshes), methods=np.array(METHODS),
               params=PARAMS, moved=MOVED,
               **{f"mesh_{i}": m for i, m in enumerate(meshes)})
    (out,) = run_jobs([("refit", inp, None)],
                      tmp_path_factory.mktemp("refit"))
    return out


@pytest.mark.parametrize("method", METHODS)
def test_capture_matches_jax(ref, method):
    got = refit.capture_tables(_meshes(), _tuples(PARAMS), method=method)
    for name in refit.TABLES:
        want = ref[f"{method}_cap_{name}"]
        assert got[name].shape == want.shape, name
        assert got[name].tobytes() == want.tobytes(), name
    for name in refit.COUNTS:
        assert got[name] == int(ref[f"{method}_cap_{name}"]), name


@pytest.mark.parametrize("pose", ["params", "moved"])
@pytest.mark.parametrize("source", ["jax_capture", "port_capture"])
@pytest.mark.parametrize("method", METHODS)
def test_refit_matches_jax(ref, method, source, pose):
    if source == "jax_capture":
        leaves = {name: ref[f"{method}_cap_{name}"]
                  for name in refit.TABLES + refit.COUNTS}
        leaves["n_instances"] = 2
        rs = refit.refit_scene_from_numpy(leaves, "cpu")
    else:
        rs = refit.capture_refit(_meshes(), _tuples(PARAMS), method=method,
                                 device="cpu")
    p = PARAMS if pose == "params" else MOVED
    fs = rs.refit(torch.from_numpy(p) if source == "jax_capture"
                  else _tuples(p))
    assert_scene_tables(fs, ref, f"{method}_{pose}_")
    assert rs.edits == 1


def test_refit_default_topology_is_ploc(ref, monkeypatch):
    monkeypatch.delenv("RAYTPU_REFIT_TOPO", raising=False)
    got = refit.capture_tables(_meshes(), _tuples(PARAMS))
    assert got["num_nodes"] == int(ref["ploc_cap_num_nodes"])
    monkeypatch.setenv("RAYTPU_REFIT_TOPO", "sbvh")
    with pytest.raises(NotImplementedError, match="RAYTPU_REFIT_TOPO"):
        refit.capture_tables(_meshes(), _tuples(PARAMS))


def test_refit_checks_the_instance_count():
    rs = refit.capture_refit(_meshes(), _tuples(PARAMS), device="cpu")
    with pytest.raises(ValueError, match="captured 2"):
        rs.refit(_tuples(PARAMS[:1]))


def test_capture_needs_two_leaves():
    plane = assets.make_ground_plane()
    with pytest.raises(ValueError, match="2 leaves"):
        refit.capture_tables([plane], _tuples(PARAMS[:1]))
    with pytest.raises(ValueError, match="non-empty"):
        refit.capture_tables([plane[:0]], _tuples(PARAMS[:1]))

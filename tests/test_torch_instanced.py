"""The port's instanced TLAS build (``scene/instanced.py``) against the
JAX package's.

One JAX child process (``torch_jax_refs.run_jobs``, XLA, no Pallas)
builds each mesh's BLAS and combines k = 1, 2 and 9 instances (9: two
TLAS levels), the first with a negative x scale. The port must build the
same BLAS and, from the JAX package's own BLAS (``mesh_blas_from_numpy``)
and from its own, the same tables: 0 differing bytes except the normal
columns (2 ulp).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.scene import instanced
from raytracer_tpu_torch.utils import assets
from torch_jax_refs import assert_scene_tables, run_jobs

torch.set_num_threads(2)

MESHES = {"cube": lambda: assets.make_cube(),
          "sphere": lambda: assets.make_icosphere(2, 3.0),
          "terrain": lambda: assets.make_terrain(n=12)}
KS = (1, 2, 9)


def _params(k, r):
    p = np.zeros((k, 10), np.float32)
    p[:, 0:3] = r.uniform(0.5, 3.0, (k, 3))
    p[0, 0] = -p[0, 0]                      # a mirrored instance
    p[:, 3:6] = r.uniform(-20, 20, (k, 3))
    p[:, 6:9] = r.uniform(0.1, 1.0, (k, 3))
    p[:, 9] = np.arange(k) % 4
    return p


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = np.random.default_rng(3)
    meshes = [make() for make in MESHES.values()]
    inp = dict(n_meshes=len(meshes), ks=np.array(KS),
               **{f"mesh_{i}": m for i, m in enumerate(meshes)})
    for k in KS:
        inp[f"k_{k}"] = np.arange(k) % len(meshes)
        inp[f"params_{k}"] = _params(k, r)
    (out,) = run_jobs([("instanced", inp, None)],
                      tmp_path_factory.mktemp("instanced"))
    return inp, out


def _jax_blas(out, i):
    return instanced.mesh_blas_from_numpy(
        {k[len(f"blas{i}_"):]: v for k, v in out.items()
         if k.startswith(f"blas{i}_")}, "cpu")


@pytest.mark.parametrize("i,name", list(enumerate(MESHES)))
def test_prep_mesh_blas_matches_jax(ref, i, name):
    inp, out = ref
    got = instanced.prep_mesh_blas(inp[f"mesh_{i}"], device="cpu")
    for f in instanced.MeshBLAS.TENSORS:
        want = out[f"blas{i}_{f}"]
        t = getattr(got, f).numpy()
        assert t.shape == want.shape and t.tobytes() == want.tobytes(), f
    for f in instanced.MeshBLAS.COUNTS:
        assert getattr(got, f) == int(out[f"blas{i}_{f}"]), f


@pytest.mark.parametrize("source", ["jax_blas", "port_blas"])
@pytest.mark.parametrize("k", KS)
def test_combine_matches_jax(ref, k, source):
    inp, out = ref
    if source == "jax_blas":
        blases = [_jax_blas(out, i) for i in range(len(MESHES))]
    else:
        blases = [instanced.prep_mesh_blas(inp[f"mesh_{i}"], device="cpu")
                  for i in range(len(MESHES))]
    fs = instanced.combine_instanced(
        [blases[i] for i in inp[f"k_{k}"]],
        torch.from_numpy(inp[f"params_{k}"]))
    assert_scene_tables(fs, out, f"k{k}_")
    nodes = fs.nodes8[:fs.num_nodes].numpy()
    assert (nodes[:, 0:3] <= nodes[:, 3:6]).all()  # mirrored boxes too


def test_combine_refuses_a_tree_past_the_stack(ref):
    """The TLAS adds one wide level: a BLAS of wide depth 35 fits (need
    7 * 36 + 1 = 253 <= 256), one of depth 36 does not."""
    _, out = ref
    blas = _jax_blas(out, 0)
    params = torch.from_numpy(_params(1, np.random.default_rng(0)))
    ok = dataclasses.replace(blas, wide_depth=35)
    assert instanced.combine_instanced([ok], params).num_nodes4 == 2
    deep = dataclasses.replace(blas, wide_depth=36)
    with pytest.raises(ValueError, match="STACK_CAP"):
        instanced.combine_instanced([deep], params)


def test_combine_takes_1_to_64_instances(ref):
    _, out = ref
    blas = _jax_blas(out, 0)
    r = np.random.default_rng(1)
    fs = instanced.combine_instanced(
        [blas] * instanced.MAX_INSTANCES,
        torch.from_numpy(_params(instanced.MAX_INSTANCES, r)))
    assert fs.num_triangles == 12 * instanced.MAX_INSTANCES
    assert fs.num_nodes4 == 1 + 8 + instanced.MAX_INSTANCES
    with pytest.raises(ValueError, match="instances"):
        instanced.combine_instanced(
            [blas] * 65, torch.from_numpy(_params(65, r)))
    with pytest.raises(ValueError, match="instances"):
        instanced.combine_instanced([], torch.zeros((0, 10)))


def test_pack_params_layout():
    p = instanced.pack_params([((1, 2, 3), (4, 5, 6), (0.5, 0.25, 1), 3.0)])
    assert p.dtype == np.float32 and p.tolist() == [
        [1, 2, 3, 4, 5, 6, 0.5, 0.25, 1, 3]]

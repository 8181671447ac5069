"""The port's per-ray GLSL-parity path against the JAX package and the
scalar GLSL oracle.

One JAX child process (``jax_ref_jobs.job_per_ray``) builds the
GpuScene of a plane and two cubes (every triangle its own albedo, so an
exact material is an exact triangle id), walks 2048 random rays with
``tracer.traverse`` under both shadings, renders a 32x16 progressive
frame with ``tracer.render_linear`` and runs ``testing/cpu_reference.py``
at 8x8 with the reference RNG and emissive materials absorbing, sky on
and off. The port must build the same tables; its ``traverse`` must give
the same hit mask and materials (triangle ids) exactly and t and normals
to 2e-5; its ``render_linear`` must match the JAX one to 2e-5 with the
same ray count, and the oracle to 2e-5 (the ``tests/test_parity.py``
bar). Also: the empty GpuScene renders sky, and the Renderer routes a
GpuScene (or ``kernel="wavefront"``) through this path.
"""

import numpy as np
import pytest
import torch

from torch_jax_refs import run_job

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.kernels import launches, tracer
from raytracer_tpu_torch.scene.builder import (build_gpu_scene_from_arrays,
                                               camera_uniforms_from_numpy,
                                               gpu_scene_from_numpy)
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

CFG = dict(width=32, height=16, max_bounces=4)
FIELDS = ("node_min", "node_max", "node_tri", "node_skip", "node_data",
          "node_count")


def _scene_arrays():
    """Plane (Lambertian), a fuzzy-metal cube and an emissive cube; each
    triangle's red channel is its index / 100."""
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    lamp = assets.make_cube() * 3.0 + np.array([9, -7, 2], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube, lamp]).astype(np.float32)
    n = verts.shape[0]
    mats = np.zeros((n, 4), np.float32)
    mats[:, 0] = np.arange(n, dtype=np.float32) / 100.0
    mats[:, 1:3] = (0.6, 0.5)
    mats[2:14, 3] = 2.0
    mats[14:, 3] = 3.0
    return verts, mats


def _rays(n=2048, seed=5):
    r = np.random.default_rng(seed)
    o = r.uniform(-30, 30, (3, n)).astype(np.float32)
    o[1] = r.uniform(-8, 20, n)
    d = r.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, :64] = np.array([[0.0], [-1.0], [0.0]], np.float32)  # axis rays
    return np.concatenate([o, d]).astype(np.float32), r.random(n) < 0.9


def _sub(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    verts, mats = _scene_arrays()
    rays, active = _rays()
    inp = dict(verts=verts, mats=mats, rays=rays, active=active, fc=3,
               cam_origin=np.array([-10.0, 6.0, 30.0]),
               cam_look=np.array([0.0, -6.0, 0.0]), cam_vfov=40.0,
               oracle_w=8, oracle_h=8,
               **{f"cfg_{k}": v for k, v in CFG.items()})
    ref = run_job("per_ray", inp, tmp_path_factory.mktemp("per_ray"))
    return inp, ref, gpu_scene_from_numpy(_sub(ref, "scene_"), device="cpu")


def test_gpu_scene_tables_equal_jax(case):
    inp, ref, _ = case
    got = build_gpu_scene_from_arrays(inp["verts"], inp["mats"],
                                      device="cpu")
    for k in FIELDS:
        want = ref["scene_" + k]
        assert getattr(got.bvh, k).numpy().tobytes() == want.tobytes(), k
    for k in ("tri_verts", "materials"):
        assert getattr(got, k).numpy().tobytes() == ref["scene_" + k] \
            .tobytes(), k
    assert got.num_triangles == int(ref["scene_num_triangles"]) == 26
    assert got.num_nodes == int(ref["scene_num_nodes"])


@pytest.mark.parametrize("shading", ["path", "fixed_light"])
def test_traverse_matches_jax(case, shading):
    inp, ref, scene = case
    rays = torch.from_numpy(inp["rays"])
    active = torch.from_numpy(inp["active"])
    cfg = RenderConfig(**CFG, shading=shading)
    res = tracer.traverse(scene, tuple(rays[0:3]), tuple(rays[3:6]), active,
                          cfg)
    want = ref[f"{shading}_out"]
    np.testing.assert_array_equal(res.hit.numpy(), ref[f"{shading}_hit"])
    assert res.hit.sum() > 500 and (~res.hit & active).sum() > 100
    # Albedo and type identify the triangle.
    got_mat = torch.stack([*res.mat_albedo, res.mat_type]).numpy()
    np.testing.assert_array_equal(got_mat, want[4:8])
    np.testing.assert_allclose(res.closest_t.numpy(), want[0], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(torch.stack(res.normal).numpy(), want[1:4],
                               rtol=0, atol=2e-5)


def test_render_linear_matches_jax(case):
    _, ref, scene = case
    uni = camera_uniforms_from_numpy(_sub(ref, "cam_"), device="cpu")
    cfg = RenderConfig(**CFG)
    color, rays = tracer.render_linear(scene, uni, cfg, sample_index=1)
    got = color.T.reshape(CFG["height"], CFG["width"], 3).numpy()
    np.testing.assert_allclose(got, ref["linear"], rtol=0, atol=2e-5)
    assert int(rays) == int(ref["rays"])
    assert got.max() > 0 and np.isfinite(got).all()


@pytest.mark.parametrize("sky", [1, 0])
def test_render_linear_matches_glsl_oracle(case, sky):
    _, ref, scene = case
    uni = camera_uniforms_from_numpy(_sub(ref, f"ocam{sky}_"), device="cpu")
    cfg = RenderConfig(width=8, height=8, max_bounces=10,
                       rng_mode="reference", emissive_emits=False)
    color, _ = tracer.render_linear(scene, uni, cfg)
    got = color.T.reshape(8, 8, 3).numpy()
    want = ref[f"oracle_sky{sky}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert (want.max() > 0) == bool(sky)


def test_empty_gpu_scene_renders_sky():
    empty = np.zeros((0, 3, 3), np.float32)
    scene = build_gpu_scene_from_arrays(empty, np.zeros((0, 4), np.float32),
                                        device="cpu")
    assert scene.num_nodes == 1 and scene.capacity == 64
    from raytracer_tpu_torch.core.camera import default_camera

    cfg = RenderConfig(width=16, height=8, kernel="wavefront")
    uni = default_camera(16, 8).uniforms(device="cpu")
    color, rays = tracer.render_linear(scene, uni, cfg)
    i = torch.arange(16 * 8)
    seed = tracer.initial_seed(uni, cfg, i, 0)
    _, _, d = tracer.make_primary_rays(uni, cfg, seed, i % 16, i // 16, 8)
    assert torch.equal(color, torch.stack(tracer.sky_color(d)))
    assert int(rays) == 16 * 8


@pytest.mark.parametrize("kernel", ["packet", "wavefront"])
def test_renderer_routes_gpu_scenes_per_ray(case, kernel):
    """A GpuScene renders through the per-ray path whatever the kernel
    field says (no packet kernel runs; each bounce's shade books as the
    shade kernel's plain version), with the band split: two bands equal
    one."""
    _, ref, scene = case
    uni = camera_uniforms_from_numpy(_sub(ref, "cam_"), device="cpu")
    images = []
    for band_rays in (0, 256):
        launches.reset()
        accum, image, stats = Renderer(RenderConfig(
            **CFG, kernel=kernel, band_rays=band_rays)).render(scene, uni)
        assert set(launches.plain) == {"shade", "tonemap"}
        images.append((accum.numpy().tobytes(), int(stats["rays_traced"])))
    assert images[0] == images[1]

"""``Renderer.render_chain`` against k ``render`` calls and against the
JAX package's ``render_chain``.

On the CPU at 32x16 (the two-cube scene of tests/test_torch_renderer.py):
a chain of 3 frames on the packet path leaves the accumulator and the u8
image bit-equal to 3 sequential frames (whose frames
tests/test_torch_renderer.py holds to the JAX package), and its stats
follow the JAX rule (``rays_traced`` averaged per frame, ``samples`` =
end frame count * spp). One JAX child process renders ``render_chain``
of 3 frames from frame count 2 at 32x16 with 4 bounces on the per-ray
path (a GpuScene: XLA loops, so the reference takes ~1 s of CPU time
where a packet one takes ~17 s of Pallas interpret lowering): the port's
chain on
the same tables and uniforms holds its accumulator to 2e-5 and its image
exactly, with equal stats.
"""

import numpy as np
import pytest
import torch

from test_torch_renderer import _sub, _two_cubes
from torch_jax_refs import run_job

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               camera_uniforms_from_numpy,
                                               gpu_scene_from_numpy)

torch.set_num_threads(2)

CAM = dict(cam_origin=np.array([-10.0, 6.0, 30.0]),
           cam_look=np.array([0.0, -6.0, 0.0]), cam_vfov=40.0)


def _camera(w, h):
    return Camera(origin=CAM["cam_origin"], look_at=CAM["cam_look"],
                  vfov_deg=CAM["cam_vfov"], aspect_ratio=w / h)


@pytest.fixture(scope="module")
def scene():
    return build_fast_scene_from_arrays(*_two_cubes(), device="cpu")


@pytest.mark.parametrize("spp, fc0", [(1, 0), (2, 5)])
def test_chain_equals_sequential_frames(scene, spp, fc0):
    cfg = RenderConfig(width=32, height=16, max_bounces=4,
                       samples_per_pixel=spp)
    cam = _camera(32, 16)
    r = Renderer(cfg)
    accum, rays = None, []
    for fc in range(fc0, fc0 + 3):
        cam.frame_count = fc
        accum, image, stats = r.render(scene, cam.uniforms(device="cpu"),
                                       accum)
        rays.append(int(stats["rays_traced"]))
    cam.frame_count = fc0
    c_accum, c_image, c_stats = r.render_chain(
        scene, cam.uniforms(device="cpu"), None, 3)
    assert c_accum.numpy().tobytes() == accum.numpy().tobytes()
    assert torch.equal(c_image, image)
    # The JAX rule: rays averaged per frame, samples at the end count.
    assert float(c_stats["rays_traced"]) == pytest.approx(sum(rays) / 3,
                                                          rel=1e-7)
    assert c_stats["samples"] == (fc0 + 3) * spp == stats["samples"]
    assert accum.max() > 0


def test_chain_of_one_is_a_frame(scene):
    cfg = RenderConfig(width=32, height=16, max_bounces=2)
    uni = _camera(32, 16).uniforms(device="cpu")
    a1, i1, s1 = Renderer(cfg).render(scene, uni)
    a2, i2, s2 = Renderer(cfg).render_chain(scene, uni, None, 1)
    assert a1.numpy().tobytes() == a2.numpy().tobytes()
    assert torch.equal(i1, i2) and s1["samples"] == s2["samples"]
    with pytest.raises(ValueError):
        Renderer(cfg).render_chain(scene, uni, None, 0)


def chain_inputs() -> dict:
    """The JAX reference's inputs: ``render_chain`` of 3 frames from frame
    count 2 at 32x16, 4 bounces, on the per-ray path."""
    return dict(**dict(zip(("verts", "mats"), _two_cubes())), **CAM, fc=2,
                k=3, cfg_width=32, cfg_height=16, cfg_max_bounces=4,
                cfg_kernel="wavefront")


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    return run_job("chain", chain_inputs(), tmp_path_factory.mktemp("chain"))


def test_chain_matches_jax(jax_chain):
    ref = jax_chain
    scene = gpu_scene_from_numpy(_sub(ref, "scene_"), device="cpu")
    uni = camera_uniforms_from_numpy(_sub(ref, "cam_"), device="cpu")
    assert uni.fc_host == 2
    cfg = RenderConfig(width=32, height=16, max_bounces=4,
                       kernel="wavefront")
    accum, image, stats = Renderer(cfg).render_chain(scene, uni, None, 3)
    np.testing.assert_allclose(accum.numpy(), ref["accum"], rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(image.numpy(), ref["image"])
    assert float(stats["rays_traced"]) == pytest.approx(float(ref["rays"]),
                                                        rel=1e-7)
    assert float(stats["rays_traced"]) > 32 * 16
    assert float(stats["samples"]) == float(ref["samples"]) == 5.0

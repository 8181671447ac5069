"""The fixed-light (C12) tier against the JAX package.

* Kernel A with the normal flip off: ``trace4_plain`` under
  ``shading="fixed_light"`` against ``pallas_traverse`` (interpret mode),
  which calls ``_trace4_call(flip_normals=False)``, on random rays: ``t``
  bit-equal everywhere, all 8 outputs bit-equal outside lanes whose
  closest hit is an equal-t tie (where the TPU's tile walk may pick
  another winner).
* A 64x48 C12 frame through the port's ``Renderer`` against the JAX
  ``Renderer`` (the ``c12_cube`` scene and camera of ``bench.py``, as
  ``scene/presets.py`` copies them, ``max_bounces=1``,
  ``shading="fixed_light"``), walking the 8-wide table and, under
  ``RAYTPU_TRAVERSE=binary``, the binary one: u8 images equal, linear
  accumulators within 2e-5.

The three JAX references come from one child process (``run_jobs``).
"""

import numpy as np
import pytest
import torch

from test_torch_trace2 import random_rays, scene_arrays
from torch_jax_refs import run_jobs, tie_lanes

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.kernels import launches
from raytracer_tpu_torch.kernels.trace import trace4_plain
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               camera_uniforms_from_numpy,
                                               fast_scene_from_numpy)
from raytracer_tpu_torch.scene.presets import c12_arrays

torch.set_num_threads(2)

C12 = dict(width=64, height=48, max_bounces=1, shading="fixed_light")


def c12_inputs():
    verts, mats = c12_arrays()
    return dict(verts=verts, mats=mats, frames=1,
                cam_origin=np.array([-10.0, 6.0, 30.0]),
                cam_look=np.array([0.0, -6.0, 0.0]), cam_vfov=40.0,
                **{f"cfg_{k}": v for k, v in C12.items()})


def _sub(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


TRAVERSALS = ("bvh4", "binary")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Kernel A's fixed-light outputs on random rays and the C12 frame
    under each traversal, from one JAX child process."""
    verts, mats = scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    rays, active = random_rays(scene, n=1024, seed=23)
    inp = dict(verts=verts, mats=mats, rays=rays, active=active,
               shadings=np.array(["fixed_light"]))
    out = run_jobs([("trace_shadings", inp, {})]
                   + [("frames", c12_inputs(), {"RAYTPU_TRAVERSE": t})
                      for t in TRAVERSALS], tmp_path_factory.mktemp("fl"))
    return (scene, inp, out[0]), dict(zip(TRAVERSALS, out[1:]))


def test_trace4_plain_without_flip_matches_pallas(refs):
    scene, inp, ref = refs[0]
    cfg = RenderConfig(shading="fixed_light")
    rays = torch.from_numpy(inp["rays"]).contiguous()
    active = torch.from_numpy(inp["active"])
    got = trace4_plain(scene, rays, active, cfg).numpy()
    want = ref["fixed_light_out"]
    assert got[0].tobytes() == want[0].tobytes()
    differ = torch.from_numpy((got != want).any(0))
    ties = tie_lanes(scene, rays[0:3], rays[3:6], active, cfg)
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)
    # Raw normals: some winners face away from their ray.
    hit = got[0] < cfg.t_max
    assert ((rays[3:6].numpy() * got[1:4]).sum(0)[hit] > 0).any()


@pytest.mark.parametrize("traverse", TRAVERSALS)
def test_c12_frame_matches_jax(refs, monkeypatch, traverse):
    ref = refs[1][traverse]
    scene = fast_scene_from_numpy(_sub(ref, "scene_"), device="cpu")
    uni = camera_uniforms_from_numpy(_sub(ref, "cam0_"), device="cpu")
    monkeypatch.setenv("RAYTPU_TRAVERSE", traverse)
    launches.reset()
    accum, image, stats = Renderer(RenderConfig(**C12)).render(scene, uni)
    walk = "trace4" if traverse == "bvh4" else "trace2"
    assert dict(launches.plain) == {"raygen": 1, walk: 1, "tonemap": 1}
    np.testing.assert_allclose(accum.numpy(), ref["accum_0"], rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(image.numpy(), ref["image_0"])
    assert int(stats["rays_traced"]) == int(ref["rays_0"]) == 64 * 48
    # The cube and the plane are lit differently; the sky is black.
    assert len(np.unique(image.numpy().reshape(-1, 3), axis=0)) >= 3

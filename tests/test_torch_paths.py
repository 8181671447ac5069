"""The bounce paths behind the knobs, through the port's Renderer.

``test_path_matches_jax``: one 64x32 two-band frame (``band_rays=1024``,
``max_bounces=4``, the two-cube scene of ``tests/test_torch_renderer.py``)
through the port's ``Renderer`` and the JAX ``Renderer`` with the same
knobs, for ``RAYTPU_BOUNCE=pmega``, ``RAYTPU_WAVE=fused``,
``RAYTPU_WAVE=fused_packed``, ``RAYTPU_WAVE=split`` with
``RAYTPU_TRAVERSE=binary``, and the XLA render path: ``RAYTPU_BOUNCE=mega``
(kernel A, then the megakernel), ``RAYTPU_B0=pwave`` (the sorted rounds
from bounce 0), ``RAYTPU_B0=mega``, ``RAYTPU_B0=packet`` and the
fixed-light tier (one bounce) with ``RAYTPU_B0=mega``. The tolerance is
the main path's frame test's: linear accumulator within 2e-5, u8 image
equal except on pixels whose bounce-0 hit is an equal-t tie (at most
0.5%), ``rays_traced`` equal. The JAX references come from one child
process (``run_jobs``); the XLA arms' own functions are held to JAX in
``tests/test_torch_mega.py``.

``test_engines_render_the_default_frame``: the port alone, at 128x64 with
two bands of 4096 rays, where the cross-band tail merge is live (the JAX
side is too slow there in interpret mode): every path whose rounds use
the kernels' two-step u32 -> f32 draw renders the default path's frame bit
for bit, since each ray's path depends only on its pixel's seed.

``test_xla_path_renders``: the XLA render path at the same size, each
knob through its own kernels, against a path that must give its frame:
``RAYTPU_B0=mega`` renders the ``RAYTPU_B0=packet`` frame bit for bit
(both walk the binary table per ray in pre-order), ``RAYTPU_BOUNCE=mega``
the ``RAYTPU_B0=mega`` frame except on bounce-0 tie pixels (kernel A walks
the 8-wide table), and ``RAYTPU_B0=pwave`` on the ``fused12`` engine the
``fused`` engine's frame bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_renderer import _bounce0_tie_pixels, _sub, _two_cubes
from torch_jax_refs import run_jobs

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer, _num_bands
from raytracer_tpu_torch.kernels import launches, wavefront
from raytracer_tpu_torch.kernels.packet import tail_merge_widths
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               camera_uniforms_from_numpy,
                                               fast_scene_from_numpy)

torch.set_num_threads(2)

CFG = dict(width=64, height=32, max_bounces=4, band_rays=1024)
C12 = dict(max_bounces=1, shading="fixed_light")
# The tile-major ray-gen and the shade of bounce 0 (and of every split
# round), booked by the default B0 arm.
FRONT = {"raygen", "shade"}
# Path -> (knobs, plain versions booked, config over CFG).
PATHS = {
    "pmega": ({"RAYTPU_BOUNCE": "pmega"}, {"trace4", "bounce15"} | FRONT,
              {}),
    "fused": ({"RAYTPU_WAVE": "fused"}, {"trace4", "bounce15"} | FRONT, {}),
    "fused_packed": ({"RAYTPU_WAVE": "fused_packed"},
                     {"trace4", "bounce_packed"} | FRONT, {}),
    "split_binary": ({"RAYTPU_WAVE": "split", "RAYTPU_TRAVERSE": "binary"},
                     {"trace2"} | FRONT, {}),
    "bounce_mega": ({"RAYTPU_BOUNCE": "mega"}, {"trace4", "mega"} | FRONT,
                    {}),
    "b0_pwave": ({"RAYTPU_B0": "pwave"}, {"raygen", "bounce12"}, {}),
    "b0_mega": ({"RAYTPU_B0": "mega"}, {"mega"}, {}),
    "b0_packet": ({"RAYTPU_B0": "packet"}, {"trace2_warp", "shade", "mega"},
                  {}),
    "c12_b0_mega": ({"RAYTPU_B0": "mega"}, {"trace2"}, C12),
}
CAM = dict(cam_origin=np.array([-10.0, 6.0, 30.0]),
           cam_look=np.array([0.0, -6.0, 0.0]), cam_vfov=40.0)


@pytest.fixture(scope="module")
def path_refs(tmp_path_factory):
    """The JAX frame of every path, one child process for all."""
    verts, mats = _two_cubes()
    jobs = [("frames", dict(verts=verts, mats=mats, frames=1, **CAM,
                            **{f"cfg_{k}": v
                               for k, v in dict(CFG, **extra).items()}),
             env) for env, _, extra in PATHS.values()]
    refs = run_jobs(jobs, tmp_path_factory.mktemp("paths"))
    return dict(zip(PATHS, refs))


@pytest.mark.parametrize("path", list(PATHS))
def test_path_matches_jax(path_refs, monkeypatch, path):
    env, kernels, extra = PATHS[path]
    ref = path_refs[path]
    scene = fast_scene_from_numpy(_sub(ref, "scene_"), device="cpu")
    uni = camera_uniforms_from_numpy(_sub(ref, "cam0_"), device="cpu")
    cfg = RenderConfig(**dict(CFG, **extra))
    assert _num_bands(cfg) == 2
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    launches.reset()
    accum, image, stats = Renderer(cfg).render(scene, uni)
    assert set(launches.plain) == kernels | {"tonemap"}
    np.testing.assert_allclose(accum.numpy(), ref["accum_0"], rtol=0,
                               atol=2e-5)
    differ = (image.numpy() != ref["image_0"]).any(-1)
    ties = _bounce0_tie_pixels(scene, cfg, uni)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert differ.mean() <= 0.005
    assert int(stats["rays_traced"]) == int(ref["rays_0"])
    assert np.isfinite(accum.numpy()).all() and accum.max() > 0


@pytest.fixture(scope="module")
def default_frame():
    verts, mats = _two_cubes()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    cfg = RenderConfig(width=128, height=64, max_bounces=4, band_rays=4096)
    uni = Camera(origin=CAM["cam_origin"], look_at=CAM["cam_look"],
                 vfov_deg=CAM["cam_vfov"], aspect_ratio=2.0).uniforms(
        device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(wavefront, "MIN_WIDTH", 2048)
    accum, _, stats = Renderer(cfg).render(scene, uni)
    nb = _num_bands(cfg)
    assert tail_merge_widths(cfg, cfg.height // nb, nb) == (2048, 4096)
    mp.undo()
    return scene, cfg, uni, accum, int(stats["rays_traced"])


@pytest.mark.parametrize("env", [
    {"RAYTPU_BOUNCE": "pmega"}, {"RAYTPU_WAVE": "fused"},
    {"RAYTPU_WAVE": "fused_packed"}, {"RAYTPU_TRAVERSE": "binary"},
    {"RAYTPU_NODE_SRC": "extract", "RAYTPU_BOUNCE": "pmega"}])
def test_engines_render_the_default_frame(default_frame, monkeypatch, env):
    scene, cfg, uni, want, rays = default_frame
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    launches.reset()
    accum, _, stats = Renderer(cfg).render(scene, uni)
    assert accum.numpy().tobytes() == want.numpy().tobytes()
    assert int(stats["rays_traced"]) == rays
    # The colour-carrying tail ran where the merge applies.
    merged = knobs.tail_merge_active(cfg)
    assert merged == (env.get("RAYTPU_BOUNCE") != "pmega")
    if env.get("RAYTPU_WAVE", "").startswith("fused"):
        assert launches.plain["bounce15"] > 0


# Knobs -> (its kernels, the knobs of a path with its frame, whether the
# two may differ on bounce-0 tie pixels).
XLA_PAIRS = {
    "RAYTPU_BOUNCE=mega": ({"RAYTPU_BOUNCE": "mega"},
                           {"trace4", "mega"} | FRONT,
                           {"RAYTPU_B0": "mega"}, True),
    "RAYTPU_B0=pwave": ({"RAYTPU_B0": "pwave"}, {"raygen", "bounce12"},
                        {"RAYTPU_B0": "pwave", "RAYTPU_WAVE": "fused"},
                        False),
    "RAYTPU_B0=mega": ({"RAYTPU_B0": "mega"}, {"mega"},
                       {"RAYTPU_B0": "packet"}, False),
}


@pytest.mark.parametrize("name", list(XLA_PAIRS))
def test_xla_path_renders(default_frame, monkeypatch, name):
    scene, cfg, uni, _, _ = default_frame
    env, kernels, twin, ties_allowed = XLA_PAIRS[name]
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    runs = []
    for knobs_ in (env, twin):
        with monkeypatch.context() as mp:
            for k, v in knobs_.items():
                mp.setenv(k, v)
            assert not knobs.tail_merge_active(cfg)
            launches.reset()
            accum, _, stats = Renderer(cfg).render(scene, uni)
            runs.append((accum.numpy(), int(stats["rays_traced"]),
                         set(launches.plain)))
    (got, rays, booked), (want, want_rays, _) = runs
    assert booked == kernels | {"tonemap"}
    assert np.isfinite(got).all() and got.max() > 0
    differ = (got != want).any(-1)
    if ties_allowed:
        ties = _bounce0_tie_pixels(scene, cfg, uni)
        assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
        assert rays == want_rays or ties.any()
    else:
        assert not differ.any() and rays == want_rays


@pytest.mark.parametrize("knob, value", [
    ("RAYTPU_WAVE", "fused16"), ("RAYTPU_NODE_SRC", "smem")])
def test_unported_knob_values_raise(default_frame, monkeypatch, knob, value):
    scene, cfg, uni, _, _ = default_frame
    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match=knob):
        Renderer(cfg).render(scene, uni)

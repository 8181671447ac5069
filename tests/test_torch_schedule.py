"""The level schedule of the sorted rounds and the unordered walk against
the JAX package, and the result-free knobs against the port's own frame.

The JAX package reads the schedule knobs when ``kernels/wavefront`` is
imported, so each set runs in a JAX child of its own, set for the whole
child (``run_children``, the children at once); the port reads them at
call time.

* ``test_schedule_frame_matches_jax``: the 128x64 two-band frame
  (``band_rays=4096``, four bounces) of ``tests/test_torch_paths.py``'s
  ``default_frame``, where the cross-band tail merge is live (handoff
  2048, merged 4096), through the port's ``Renderer`` and the JAX one:
  under ``RAYTPU_ORDER_MINW`` above every width (every band and tail level
  walks unordered), ``RAYTPU_WAVE_BCAP=2`` and ``RAYTPU_TAIL_BCAP=3``
  together; under ``RAYTPU_TAIL_MERGE=0``; and under
  ``RAYTPU_DEEP_SUB=32`` (widths floor to 4096 rays: one level, no
  merge). Linear accumulator within 2e-5, u8 image equal except
  on bounce-0 tie pixels, ``rays_traced`` equal.
* ``test_unordered_walk_matches_pallas``: ``bounce12_plain(ordered=False)``
  against ``bounce_megakernel12(ordered=False)`` in interpret mode on one
  2048-ray tile, a quarter of the rays aimed at terrain vertices: every
  lane agrees, equal-t tie lanes included (``tie_lanes`` counts them),
  the scattered direction within 2 ulp (XLA:CPU's normalisation).
* ``test_result_free_knob_keeps_the_frame``: port only, the default
  128x64 frame under each knob that moves state but no result
  (``RAYTPU_GLUE``, ``RAYTPU_DEPOSIT``, ``RAYTPU_PACK_GATHER``,
  ``RAYTPU_WAVE_MINW``, ``RAYTPU_DEEP_MAXW``, and the sort keys), byte for
  byte: each ray's path depends only on its own seed, and the port walks
  every ray near-first by its own direction whatever the order.
"""

import numpy as np
import pytest
import torch

from test_torch_paths import CAM
from test_torch_renderer import _bounce0_tie_pixels, _sub, _two_cubes
from test_torch_sort_keys import _state_inputs, run_build
from test_torch_trace2 import scene_arrays
from torch_jax_refs import run_children, tie_lanes

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer, _num_bands
from raytracer_tpu_torch.kernels import launches, wavefront
from raytracer_tpu_torch.kernels.packet import tail_merge_widths
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               camera_uniforms_from_numpy,
                                               fast_scene_from_numpy)

torch.set_num_threads(2)

W = 2048
CFG = dict(width=128, height=64, max_bounces=4, band_rays=4096)
UNORDERED = {"RAYTPU_ORDER_MINW": str(1 << 30), "RAYTPU_WAVE_BCAP": "2",
             "RAYTPU_TAIL_BCAP": "3"}
DEEP = {"RAYTPU_DEEP_SUB": "32"}
# The tile-major ray-gen, the bounce-0 shade and the sorted rounds' entry
# keys, booked on every frame.
FRONT = {"raygen", "shade", "sort_key"}
# Frame -> (knobs, plain versions booked, the tail-merge widths).
FRAMES = {
    "unordered_bcaps": (UNORDERED, {"trace4", "bounce12_unordered"} | FRONT,
                        (2048, 4096)),
    "no_merge": ({"RAYTPU_TAIL_MERGE": "0"}, {"trace4", "bounce12"} | FRONT,
                 None),
    "deep_sub": (DEEP, {"trace4", "bounce12"} | FRONT, None),
}


def _vertex_rays(f, verts, r):
    """Aim the first quarter of the tile's rays at terrain vertices, where
    neighbouring triangles may tie."""
    n = W // 4
    v = verts.reshape(-1, 3)[r.integers(0, 1200, n)]
    o = v + r.uniform([-5, 5, -5], [5, 15, 5], (n, 3)).astype(np.float32)
    d = (v - o) / np.linalg.norm(v - o, axis=1, keepdims=True)
    f[0:3, :n], f[3:6, :n] = o.T, d.T
    f[12, :n] = 1.0


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    fverts, fmats = _two_cubes()
    frame = dict(verts=fverts, mats=fmats, frames=1, **CAM,
                 **{f"cfg_{k}": v for k, v in CFG.items()})
    verts, mats = scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    f, i = _state_inputs(scene)
    _vertex_rays(f, verts, np.random.default_rng(5))
    tile = dict(verts=verts, mats=mats, f=f, i=i, sky=1, bcap=1,
                builds=np.array(["b12:cid:0"]))
    (merged, unordered), (unmerged,), (deep,) = run_children([
        ([("frames", frame, None), ("bounce_builds", tile, None)],
         UNORDERED),
        ([("frames", frame, {"RAYTPU_TAIL_MERGE": "0"})], None),
        ([("frames", frame, None)], DEEP)], tmp_path_factory.mktemp("sch"))
    return dict(frames={"unordered_bcaps": merged, "no_merge": unmerged,
                        "deep_sub": deep},
                scene=scene, f=f, i=i, tile=unordered)


@pytest.mark.parametrize("name", list(FRAMES))
def test_schedule_frame_matches_jax(refs, monkeypatch, name):
    env, kernels, merge = FRAMES[name]
    ref = refs["frames"][name]
    scene = fast_scene_from_numpy(_sub(ref, "scene_"), device="cpu")
    uni = camera_uniforms_from_numpy(_sub(ref, "cam0_"), device="cpu")
    cfg = RenderConfig(**CFG)
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    nb = _num_bands(cfg)
    assert tail_merge_widths(cfg, cfg.height // nb, nb) == merge
    launches.reset()
    accum, image, stats = Renderer(cfg).render(scene, uni)
    assert set(launches.plain) == kernels | {"tonemap"}
    np.testing.assert_allclose(accum.numpy(), ref["accum_0"], rtol=0,
                               atol=2e-5)
    differ = (image.numpy() != ref["image_0"]).any(-1)
    ties = _bounce0_tie_pixels(scene, cfg, uni)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert int(stats["rays_traced"]) == int(ref["rays_0"])


def test_unordered_walk_matches_pallas(refs):
    scene, f, i = refs["scene"], refs["f"], refs["i"]
    cfg = RenderConfig()
    build = "b12:cid:0"
    launches.reset()
    got_f, got_i, counts = run_build(scene, f, i, build, cfg)
    assert dict(launches.plain) == {"bounce12_unordered": 1}
    ref = refs["tile"]
    want_f, want_i = ref[f"{build}_f"], ref[f"{build}_i"]
    ulps = np.abs(got_f.view(np.int32).astype(np.int64)
                  - want_f.view(np.int32))
    ulps[3:6] = np.maximum(ulps[3:6] - 2, 0)
    differ = (ulps != 0).any(0) | (got_i != want_i).any(0)
    ties = tie_lanes(scene, [torch.from_numpy(f[j]) for j in range(3)],
                     [torch.from_numpy(f[j]) for j in range(3, 6)],
                     torch.from_numpy(f[12] > 0.5), cfg).numpy()
    assert not differ.any(), (np.nonzero(differ)[0][:10], ties.sum())
    assert int(counts[0]) == ref[f"{build}_rays"]
    assert int(counts[1]) == ref[f"{build}_live"]
    assert 0 < int(counts[1]) < int(counts[0])


@pytest.fixture(scope="module")
def default_frame():
    verts, mats = _two_cubes()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    cfg = RenderConfig(**CFG)
    uni = Camera(origin=CAM["cam_origin"], look_at=CAM["cam_look"],
                 vfov_deg=CAM["cam_vfov"], aspect_ratio=2.0).uniforms(
        device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wavefront, "MIN_WIDTH", 2048)
        accum, _, stats = Renderer(cfg).render(scene, uni)
    return scene, cfg, uni, accum, int(stats["rays_traced"])


# Knob values -> the plain versions the frame books (besides the ray-gen,
# trace4, the bounce-0 shade, the entry keys and the tonemap).
RESULT_FREE = {
    "RAYTPU_GLUE=perfield,RAYTPU_WAVE=fused": {"bounce15"},
    "RAYTPU_GLUE=packT,RAYTPU_WAVE=fused": {"bounce15"},
    "RAYTPU_GLUE=pack": {"bounce12"},
    "RAYTPU_DEPOSIT=ch": {"bounce12"},
    "RAYTPU_DEPOSIT=rows": {"bounce12"},
    "RAYTPU_PACK_GATHER=row,RAYTPU_WAVE=fused_packed": {"bounce_packed",
                                                        "bounce15"},
    "RAYTPU_WAVE_MINW=4096": {"bounce12"},
    "RAYTPU_DEEP_MAXW=100000": {"bounce12"},
    "RAYTPU_SORT_KEY=pd5": {"bounce12_pd5"},
    "RAYTPU_SORT_KEY=om9,RAYTPU_WAVE=fused": {"bounce15_om9"},
    "RAYTPU_SORT_KEY=pos": {"bounce12"},
}


@pytest.mark.parametrize("knobs_", list(RESULT_FREE))
def test_result_free_knob_keeps_the_frame(default_frame, monkeypatch,
                                          knobs_):
    scene, cfg, uni, want, rays = default_frame
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    for kv in knobs_.split(","):
        monkeypatch.setenv(*kv.split("="))
    launches.reset()
    accum, _, stats = Renderer(cfg).render(scene, uni)
    assert set(launches.plain) == RESULT_FREE[knobs_] | FRONT | {
        "trace4", "tonemap"}
    assert accum.numpy().tobytes() == want.numpy().tobytes()
    assert int(stats["rays_traced"]) == rays

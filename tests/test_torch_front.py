"""The front of a band on the CPU: the ray-gen and shade wrappers
(``packet.primary_rays``, ``tracer.shade``) run their plain versions on
CPU tensors and book them as plain calls, the fused ray-gen's plain
version is the composition the default path made before (tile-major ids,
pad mask, ``pix_local``, seed, rays stacked in the walks' [6, P] layout)
bit for bit, and each path books the front it runs. The plain ops are
held to the JAX package elsewhere (``test_torch_rng_tracer.py``,
``test_torch_renderer.py``); these tests start no JAX child. The kernels
themselves are compared with these plain versions on the card
(``test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import Camera, default_camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.kernels import launches, packet, tracer, wavefront
from raytracer_tpu_torch.kernels.trace import BBLOCK, BLOCK
from raytracer_tpu_torch.kernels.tracer import TraversalResult
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays

torch.set_num_threads(2)

FC_BIG = 2 ** 20 + 7
# Band -> (frame config, band rows, band, frame counter, sample index):
# 8x128 pixel tiles with a pad tail, raster order (no tile divides
# 120x200) with a pad tail, the reference RNG, a second sample, and the
# unjittered fixed-light tier in both orders.
BANDS = {
    "tiles_pad": (dict(width=128, height=80), 40, 1, FC_BIG, 0),
    "tiles_pad_fc0": (dict(width=128, height=80), 40, 0, 0, 0),
    "raster_pad": (dict(width=200, height=120), 120, 0, 9, 0),
    "reference": (dict(width=128, height=80, rng_mode="reference"), 40, 1,
                  5, 0),
    "spp2_sample1": (dict(width=128, height=80, samples_per_pixel=2), 40,
                     1, 7, 1),
    "fixed_light_tiles": (dict(width=128, height=80, max_bounces=1,
                               shading="fixed_light"), 40, 1, 3, 0),
    "fixed_light_raster": (dict(width=200, height=120, max_bounces=1,
                                shading="fixed_light"), 120, 0, 3, 0),
}


def _band(name):
    over, band_h, band, fc, si = BANDS[name]
    cfg = RenderConfig(**over)
    cam = default_camera(cfg.width, cfg.height)
    cam.frame_count = fc
    grain = max(BLOCK, BBLOCK)
    p_pad = -(-band_h * cfg.width // grain) * grain
    return (cam.uniforms(device="cpu"), dataclasses.replace(
        cfg, height=band_h), p_pad, band * band_h, cfg.height, si, "cpu")


def _composition(cam, cfg, p_pad, y_offset, gh, sample_index):
    """The default path's ray-gen before the fused version, op for op."""
    h, w = cfg.height, cfg.width
    p = h * w
    xx, yy_local, alive = packet._tile_major_pixels(h, w, p_pad, "cpu")
    yy = yy_local + y_offset
    pix_local = torch.where(alive, yy_local * w + xx, p).to(torch.int32)
    if cfg.shading == "fixed_light":
        _, ray_o, ray_d = tracer.make_primary_rays(cam, cfg, None, xx, yy,
                                                   gh, jitter=False)
        seed = None
    else:
        seed = tracer.initial_seed(cam, cfg, yy * w + xx, sample_index)
        seed, ray_o, ray_d = tracer.make_primary_rays(cam, cfg, seed, xx,
                                                      yy, gh)
    return torch.stack([*ray_o, *ray_d]), seed, alive, pix_local


@pytest.mark.parametrize("band", list(BANDS))
def test_primary_rays_equals_the_composition(band):
    args = _band(band)
    cam, cfg, p_pad = args[:3]
    launches.reset()
    got = packet.primary_rays(*args)
    assert dict(launches.plain) == {"raygen": 1} and not launches.kernel
    want = _composition(*args[:-1])
    rays, seed, alive, pix = got
    assert rays.dtype == torch.float32 and rays.shape == (6, p_pad)
    assert rays.is_contiguous()
    assert torch.equal(rays.view(torch.int32), want[0].view(torch.int32))
    if cfg.shading == "fixed_light":
        assert seed is None and want[1] is None
    else:
        assert seed.dtype == torch.int64 and torch.equal(seed, want[1])
        assert int(seed.min()) >= 0 and int(seed.max()) < 2 ** 32
    assert alive.dtype == torch.bool and torch.equal(alive, want[2])
    assert pix.dtype == torch.int32 and torch.equal(pix, want[3])
    # A pad tail: dead rays with the pad id p; live ids each once.
    p = cfg.height * cfg.width
    assert p < p_pad and int(alive.sum()) == p
    assert bool((pix[~alive] == p).all())
    assert torch.equal(torch.sort(pix[alive]).values,
                       torch.arange(p, dtype=torch.int32))


def _shade_inputs(n=4096, seed=3):
    """A hit record of every material type, misses, 25% dead rays and
    colours, atten and seeds of any value."""
    r = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        r.uniform(-1, 1, shape).astype(np.float32))
    t = torch.from_numpy(np.where(r.random(n) < 0.7, r.uniform(0.1, 50, n),
                                  1e4).astype(np.float32))
    nrm = f(3, n)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=0)
    d = f(3, n)
    d = d / torch.linalg.vector_norm(d, dim=0)
    mt = torch.from_numpy(r.integers(0, 4, n).astype(np.float32))
    res = TraversalResult(t, t < 1e4, tuple(nrm), tuple(f(3, n).abs()), mt)
    alive = torch.from_numpy(r.random(n) < 0.75)
    seeds = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.int64))
    return (res, tuple(f(3, n) * 20), tuple(d), tuple(f(3, n).abs()),
            tuple(f(3, n).abs()), seeds, alive)


@pytest.mark.parametrize("sky_on", [True, False])
@pytest.mark.parametrize("emits", [True, False])
def test_shade_wrapper_runs_the_plain_version(sky_on, emits):
    cfg = RenderConfig(emissive_emits=emits)
    args = (*_shade_inputs(), sky_on, cfg)
    launches.reset()
    got = tracer.shade(*args)
    assert dict(launches.plain) == {"shade": 1} and not launches.kernel
    want = tracer.shade_plain(*args)
    flat = lambda xs: [y for x in xs for y in (x if isinstance(x, tuple)
                                               else (x,))]
    for g, w in zip(flat(got), flat(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    res, alive, scattered = args[0], args[6], got[5]
    assert not bool((scattered & ~(alive & res.hit)).any())
    # Dead rays keep their ray, atten and seed.
    for g, w in zip(flat(got[:2]) + flat(got[3:4]) + [got[4]],
                    flat(args[1:3]) + flat(args[4:5]) + [args[5]]):
        assert torch.equal(g[~alive], w[~alive])


def test_rows_copies_strided_views_and_refuses_the_rest():
    """The shade kernel's argument check: strided or broadcast [P] views
    become contiguous copies of the same values; another dtype, length or
    device raises."""
    rec = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    wide = torch.tensor(2.5).expand(8)
    rows = tracer._rows((rec[:, 1], wide), torch.float32, 8,
                        torch.device("cpu"), "x")
    assert all(r.is_contiguous() for r in rows)
    assert torch.equal(rows[0], rec[:, 1]) and torch.equal(rows[1], wide)
    for bad in (rec[:, 1].double(), rec[:7, 1], rec[:, 1].to(torch.int32)):
        with pytest.raises(ValueError):
            tracer._rows((bad,), torch.float32, 8, torch.device("cpu"), "x")


def test_raygen_kernel_refuses_a_camera_off_the_card():
    cam = default_camera(64, 32).uniforms(device="cpu")
    with pytest.raises(ValueError):
        packet._camera_rows(cam, torch.device("cuda"))


@pytest.fixture(scope="module")
def cube():
    verts, mats = presets.c12_arrays()
    mats[:4, 3] = 1.0                       # a metal patch of the ground
    return build_fast_scene_from_arrays(verts, mats, device="cpu")


# Path knobs -> (config over the 64x32 frame, raygen and shade calls
# booked a frame: one a band where the arm runs them, and a shade a split
# round).
FRAMES = {
    "default": ({}, {}, 2, 2),
    "pmega": ({"RAYTPU_BOUNCE": "pmega"}, {}, 2, 2),
    "bounce_mega": ({"RAYTPU_BOUNCE": "mega"}, {}, 2, 2),
    "b0_pwave": ({"RAYTPU_B0": "pwave"}, {}, 2, 0),
    "b0_mega": ({"RAYTPU_B0": "mega"}, {}, 0, 0),
    "b0_packet": ({"RAYTPU_B0": "packet"}, {}, 0, 2),
    "fixed_light": ({}, dict(max_bounces=1, shading="fixed_light"), 2, 0),
    "fixed_light_b0_mega": ({"RAYTPU_B0": "mega"},
                            dict(max_bounces=1, shading="fixed_light"), 0,
                            0),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_each_path_books_the_front_it_runs(cube, monkeypatch, name):
    env, over, raygen, shade = FRAMES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 1024)
    cfg = RenderConfig(**dict(dict(width=64, height=32, max_bounces=3,
                                   band_rays=1024), **over))
    cam = Camera(origin=(-10.0, 6.0, 30.0), look_at=(0.0, -6.0, 0.0),
                 vfov_deg=40.0, aspect_ratio=2.0)
    launches.reset()
    accum, _, stats = Renderer(cfg).render(scene=cube, cam=cam.uniforms(
        device="cpu"))
    assert launches.plain["raygen"] == raygen
    assert launches.plain["shade"] == shade
    assert not launches.kernel
    assert bool(torch.isfinite(accum).all()) and float(accum.max()) > 0


def test_split_rounds_shade_through_the_wrapper(cube, monkeypatch):
    """The split engine shades each sorted round through ``tracer.shade``
    (one call a round after bounce 0's)."""
    monkeypatch.setenv("RAYTPU_WAVE", "split")
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 1024)
    cfg = RenderConfig(width=64, height=32, max_bounces=3, band_rays=1024)
    cam = Camera(origin=(-10.0, 6.0, 30.0), look_at=(0.0, -6.0, 0.0),
                 vfov_deg=40.0, aspect_ratio=2.0)
    launches.reset()
    Renderer(cfg).render(cube, cam.uniforms(device="cpu"))
    assert launches.plain["raygen"] == 2
    assert launches.plain["shade"] > 2

"""The port's Renderer against the JAX Renderer on the main path.

128x64, ``band_rays=4096`` (two bands of 32 rows), ``max_bounces=4``, the
two-cube scene of tests/test_wavefront.py, frames 0 and 1. The JAX side
runs with the production knobs (Pallas kernels in interpret mode,
sorted wavefront rounds, tail merge) and ``MIN_WIDTH`` 2048 on both sides,
so the cross-band tail merge is live. Both sides get the same tables and
uniforms. The linear accumulator must agree within 2e-5 and the u8 image
exactly, except on pixels whose bounce-0 hit is an equal-t tie (at most
0.5% of pixels); ``rays_traced`` must be equal.
"""

import numpy as np
import pytest
import torch

from torch_jax_refs import run_job, tie_lanes

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer, _num_bands
from raytracer_tpu_torch.kernels import launches, wavefront
from raytracer_tpu_torch.kernels.packet import (_tile_major_pixels,
                                                tail_merge_widths)
from raytracer_tpu_torch.kernels.tracer import (initial_seed,
                                                make_primary_rays)
from raytracer_tpu_torch.scene.builder import (camera_uniforms_from_numpy,
                                               fast_scene_from_numpy)
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

CFG = dict(width=128, height=64, max_bounces=4, band_rays=4096)
FRAMES = 2


def _two_cubes():
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    metal = assets.make_cube() * 3.0 + np.array([9, -7, 2], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube, metal]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = (0.7, 0.5, 0.4)
    mats[2 + cube.shape[0]:, 3] = 1.0  # metal cube
    return verts, mats


def _sub(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    verts, mats = _two_cubes()
    inp = dict(verts=verts, mats=mats, frames=FRAMES,
               cam_origin=np.array([-10.0, 6.0, 30.0]),
               cam_look=np.array([0.0, -6.0, 0.0]), cam_vfov=40.0,
               **{f"cfg_{k}": v for k, v in CFG.items()})
    ref = run_job("renderer", inp, tmp_path_factory.mktemp("render"))
    scene = fast_scene_from_numpy(_sub(ref, "scene_"), device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(wavefront, "MIN_WIDTH", 2048)
    cfg = RenderConfig(**CFG)
    r = Renderer(cfg)
    frames, accum = [], None
    launches.reset()
    for fc in range(FRAMES):
        uni = camera_uniforms_from_numpy(_sub(ref, f"cam{fc}_"),
                                         device="cpu")
        accum, image, stats = r.render(scene, uni, accum)
        frames.append((accum.clone(), image, stats, uni))
    counts = dict(launches.plain)
    widths = tail_merge_widths(cfg, cfg.height // _num_bands(cfg),
                               _num_bands(cfg))
    mp.undo()
    return scene, cfg, ref, frames, counts, widths


def _bounce0_tie_pixels(scene, cfg, uni):
    """bool[H*W]: pixels whose primary ray's closest hit is an equal-t
    tie, with the rays made exactly as the renderer makes them (jittered,
    or unjittered in the fixed-light tier)."""
    nb = _num_bands(cfg)
    bh = cfg.height // nb
    ties = torch.zeros(cfg.height * cfg.width, dtype=torch.bool)
    for b in range(nb):
        p = bh * cfg.width
        xx, yy_local, alive = _tile_major_pixels(bh, cfg.width, p, "cpu")
        yy = yy_local + b * bh
        seed = initial_seed(uni, cfg, yy * cfg.width + xx, 0)
        _, o, d = make_primary_rays(uni, cfg, seed, xx, yy, cfg.height,
                                    jitter=cfg.shading != "fixed_light")
        t = tie_lanes(scene, o, d, alive, cfg)
        ties[(yy * cfg.width + xx)[t]] = True
    return ties.reshape(cfg.height, cfg.width).numpy()


def test_tail_merge_widths_match_jax(case):
    _, _, ref, _, counts, widths = case
    assert widths == (2048, 4096)
    assert tuple(ref["tail_merge_widths"]) == widths
    # The frames went through every plain version (CPU tensors).
    assert set(counts) == {"raygen", "trace4", "shade", "bounce12",
                           "tonemap"}


@pytest.mark.parametrize("fc", range(FRAMES))
def test_frame_matches_jax(case, fc):
    scene, cfg, ref, frames, _, _ = case
    accum, image, stats, uni = frames[fc]
    np.testing.assert_allclose(accum.numpy(), ref[f"accum_{fc}"], rtol=0,
                               atol=2e-5)
    differ = (image.numpy() != ref[f"image_{fc}"]).any(-1)
    ties = _bounce0_tie_pixels(scene, cfg, uni)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert differ.mean() <= 0.005
    assert int(stats["rays_traced"]) == int(ref[f"rays_{fc}"])
    assert stats["samples"] == fc + 1


@pytest.mark.parametrize("bounces", [4, 1])
def test_band_layouts_render_identically(case, bounces):
    """Each ray's path depends only on its pixel's seed, so one band, two
    bands with the tail merge and four bands too small for a handoff (no
    merge) render the same image bit for bit (also at one bounce, where
    no round runs)."""
    scene, _, ref, _, _, _ = case
    uni = camera_uniforms_from_numpy(_sub(ref, "cam0_"), device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(wavefront, "MIN_WIDTH", 2048)
    images = []
    for band_rays in (0, 4096, 2048):
        cfg = RenderConfig(**{**CFG, "band_rays": band_rays,
                              "max_bounces": bounces})
        nb = _num_bands(cfg)
        merged = tail_merge_widths(cfg, cfg.height // nb, nb)
        assert (merged is not None) == (band_rays == 4096 and bounces > 1)
        accum, image, stats = Renderer(cfg).render(scene, uni)
        images.append((accum.numpy(), int(stats["rays_traced"])))
    mp.undo()
    for accum, rays in images[1:]:
        assert accum.tobytes() == images[0][0].tobytes()
        assert rays == images[0][1]
    assert np.isfinite(images[0][0]).all() and images[0][0].max() > 0

"""One band of a frame: tile-major ray-gen, traversal (kernel A or 5),
bounce-0 shade, and the bounce engine.

The port of ``raytracer_tpu/kernels/packet.py`` ``render_linear_fast`` on
its ``RAYTPU_B0=pallas`` arms: path shading with ``RAYTPU_BOUNCE=wave``
(sorted rounds, ``kernels/wavefront.py``) or ``RAYTPU_BOUNCE=pmega`` (one
sort, then the whole bounce chain in one ``bounce15`` call), and the
fixed-light (C12) tier. Plus ``tail_merge_widths``; the knob half of the
JAX ``tail_merge_active`` is ``knobs.tail_merge_active`` (the wide table
is always built).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import CameraUniforms, RenderConfig
from raytracer_tpu_torch.kernels import wavefront
from raytracer_tpu_torch.kernels.bounce import (UNIFORM_BUDGET, bounce15,
                                                pack_state)
from raytracer_tpu_torch.kernels.trace import (BBLOCK, BLOCK, pick_tile,
                                               traverse)
from raytracer_tpu_torch.kernels.tracer import (fixed_light_color,
                                                initial_seed,
                                                make_primary_rays, shade)


def tail_merge_widths(cfg: RenderConfig, band_h: int, nb: int):
    """(handoff_width, merged_width) for the cross-band deep-round merge,
    or None when it cannot apply (one band, one bounce, fixed light, or a
    band too small to have deep levels). The handoff is the band ladder
    width nearest band rays / 4 (>= MIN_WIDTH)."""
    knobs.fixed("RAYTPU_TAIL_MERGE")
    if nb <= 1 or cfg.max_bounces <= 1 or cfg.shading == "fixed_light":
        return None
    p = band_h * cfg.width
    grain = max(BLOCK, BBLOCK)
    p_pad = -(-p // grain) * grain
    widths = wavefront.round_widths(p_pad)
    target = max(wavefront.MIN_WIDTH, p_pad // 4)
    cands = [w for w in widths[1:] if w <= target]
    if not cands:
        return None
    return cands[0], nb * cands[0]


def _tile_major_pixels(h: int, w: int, p_pad: int, device):
    """Ray i -> (xx, yy_local, alive) in tile-major order: consecutive
    BLOCK rays form one compact pixel tile; the pad tail wraps to valid
    pixels as dead rays."""
    p = h * w
    i = torch.arange(p_pad, dtype=torch.int64, device=device)
    i_mod = i % p
    tile = pick_tile(h, w)
    if tile is not None:
        th, tw = tile
        per = th * tw
        t_id, off = i_mod // per, i_mod % per
        tiles_x = w // tw
        xx = (t_id % tiles_x) * tw + off % tw
        yy_local = (t_id // tiles_x) * th + off // tw
    else:
        xx = i_mod % w
        yy_local = i_mod // w
    return xx, yy_local, i < p


def _pmega(scene: FastScene, ray_o, ray_d, color, atten, seed, alive,
           sky_on: bool, cfg: RenderConfig, pix):
    """``RAYTPU_BOUNCE=pmega``: one stable sort by the host key (the
    ``om9`` form of the cid key, dead bit 31), one gather, then every
    bounce in ONE ``bounce15`` call (bcap = max_bounces - 1, budget never
    gating); colours deposit at the sorted pixel ids. The kernel's key is
    not used. Returns (color f32[3, P + 1], rays traced in the call)."""
    knobs.fixed("RAYTPU_SORT_KEY")
    smin, smax = scene.bounds()
    key = wavefront.sort_key(ray_o, ray_d, alive, smin, smax)
    state = pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET, pix,
                       color=color)
    state = state.index_select(1, torch.argsort(key, stable=True))
    state, _, counts = bounce15(scene, state, cfg.max_bounces - 1, sky_on,
                                cfg)
    out = torch.zeros((3, alive.shape[0] + 1), dtype=torch.float32,
                      device=alive.device)
    wavefront._deposit(out, state)
    return out, counts[0]


def render_linear_fast(scene: FastScene, cam: CameraUniforms,
                       cfg: RenderConfig, sample_index: int = 0,
                       y_offset: int = 0, global_height: int | None = None,
                       tail_handoff: int | None = None):
    """One band (cfg.height rows starting at global row ``y_offset``) ->
    (color f32[3, h*w] in raster order, rays traced (int64 tensor),
    survivors). With ``tail_handoff``, the wavefront stops at that width
    and ``survivors`` is the band's live tail (round state with global
    pixel ids, pads at global_height * w) for ``wavefront_tail``;
    otherwise it is None."""
    if cfg.height % 8 or cfg.width % 8:
        raise ValueError("fast path needs resolution divisible by 8")
    knobs.bounce0()
    knobs.fixed("RAYTPU_COMPACT_FLOOR", "RAYTPU_COMPACT_RATIO")
    h, w = cfg.height, cfg.width
    gh = global_height or h
    p = h * w
    dev = scene.device
    grain = max(BLOCK, BBLOCK)
    p_pad = -(-p // grain) * grain
    xx, yy_local, alive = _tile_major_pixels(h, w, p_pad, dev)
    yy = yy_local + y_offset
    # Pad rays carry an out-of-range pixel id (p); their deposits drop.
    pix_local = torch.where(alive, yy_local * w + xx, p).to(torch.int32)

    def by_pixel(color):
        out = torch.zeros((3, p + 1), dtype=torch.float32, device=dev)
        out.index_copy_(1, pix_local.to(torch.int64), torch.stack(color))
        return out[:, :p], torch.tensor(p, device=dev), None

    if cfg.shading == "fixed_light":
        # C12 tier: unjittered primaries, raw normals, Lambert + ambient.
        _, ray_o, ray_d = make_primary_rays(cam, cfg, None, xx, yy, gh,
                                            jitter=False)
        return by_pixel(fixed_light_color(
            traverse(scene, ray_o, ray_d, alive, cfg, coherent=True)))

    seed = initial_seed(cam, cfg, yy * w + xx, sample_index)
    seed, ray_o, ray_d = make_primary_rays(cam, cfg, seed, xx, yy, gh)
    zero = torch.zeros(p_pad, dtype=torch.float32, device=dev)
    one = torch.ones(p_pad, dtype=torch.float32, device=dev)
    sky_on = cam.sky_host

    res = traverse(scene, ray_o, ray_d, alive, cfg, coherent=True)
    ray_o, ray_d, color, atten, seed, alive = shade(
        res, ray_o, ray_d, (zero, zero, zero), (one, one, one), seed, alive,
        sky_on, cfg)
    if cfg.max_bounces == 1:
        return by_pixel(color)
    if knobs.bounce_path() == "pmega":
        col, rays = _pmega(scene, ray_o, ray_d, color, atten, seed, alive,
                           sky_on, cfg, pix_local)
        return col[:, :p], rays + p, None

    col, rays, surv = wavefront.wavefront_bounces(
        scene, ray_o, ray_d, color, atten, seed, alive, sky_on, cfg,
        pix_local, handoff_width=tail_handoff)
    if surv is not None:
        # Survivor pixel ids go global for the cross-band merge; the pad
        # sentinel (p) maps to gh * w so merged deposits still drop it.
        pixl = surv[wavefront.ROW_PIX]
        surv[wavefront.ROW_PIX] = torch.where(pixl >= p, gh * w,
                                              pixl + y_offset * w)
    return col[:, :p], rays + p, surv

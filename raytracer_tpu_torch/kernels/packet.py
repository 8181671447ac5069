"""One band of a frame: ray-gen, bounce 0 and the bounce engine, on every
path of the JAX package's ``render_linear_fast``
(``raytracer_tpu/kernels/packet.py:517``), picked by the knobs
(``raytracer_tpu_torch/knobs.py``):

* ``RAYTPU_B0=pallas`` (default): tile-major ray-gen, kernel A or 5
  (``trace.traverse``), the bounce-0 shade, then ``RAYTPU_BOUNCE``:
  ``wave`` (sorted rounds, ``kernels/wavefront.py``), ``pmega`` (one sort,
  then the whole chain in one ``bounce15`` call) or ``mega`` (the
  megakernel from bounce 1, deposited by pixel id);
* ``RAYTPU_B0=pwave``: tile-major ray-gen, then the sorted rounds from
  bounce 0 (kernel B traces and shades the primaries);
* ``RAYTPU_B0=mega``: raster ray-gen, then the megakernel from bounce 0;
* ``RAYTPU_B0=packet``: the primaries in 8x8-tile groups through the
  group walk, the bounce-0 shade, then the megakernel from bounce 1;
* the fixed-light (C12) tier: kernel A or 5 on tile-major primaries under
  ``RAYTPU_B0=pallas``, else the per-ray XLA walk on raster primaries.

The tile-major ray-gen is ``primary_rays``: on the card one launch of the
ray-gen kernel (``csrc/front.cu``), which writes the rays straight into
the walks' [6, P] layout; its plain version ``primary_rays_plain`` is the
JAX composition (``_tile_major_pixels``, ``tracer.initial_seed``,
``tracer.make_primary_rays``). The bounce-0 shade is ``tracer.shade``,
one launch of the shade kernel on the card. The raster ray-gen of the
other ``RAYTPU_B0`` arms stays plain ops.

The JAX package's XLA walks and megakernel are here as plain PyTorch under
their JAX names: ``_cluster_mt`` (the Moller-Trumbore over a leaf's
``cluster_size`` slots, argmin to the lowest slot on a tie, the winner
selected by a one-hot sum),
``ray_traverse_fast``, ``packet_traverse`` and ``megakernel_bounces`` /
``_mega_level`` (width levels, cumsum compaction, the clone-slot kill,
deposits at each level boundary). They are the plain versions of kernels:
on CUDA tensors the frame runs ``trace2`` for ``ray_traverse_fast``,
``trace2_warp`` for ``packet_traverse`` (the same pre-order walk with
strict ``t < closest``, so the same closest hit and winner, ties
included) and the ``mega`` kernel (``kernels/mega.py``) for
``megakernel_bounces``. Python loops replace ``lax.while_loop``; the loop
condition is read on the host every ``TRAVERSE_UNROLL`` steps, as the JAX
loop tests it.

A scene without a wide table (the device LBVH under ``RAYTPU_WIDE=16``)
takes the JAX package's routes for it (``packet.py:509``, ``:650``,
``:677``): bounce 0 walks the binary table, ``RAYTPU_BOUNCE=pmega`` runs
the sorted rounds instead, ``RAYTPU_B0=pwave`` the bounce-0 kernel and
then the rounds, which are ``split`` (``kernels/wavefront.py``), and the
tail merge is off.

Plus ``tail_merge_widths``; ``tail_merge_active`` is the JAX rule: the
knobs (``knobs.tail_merge_active``) and a wide table.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.core.fast_types import FastScene, TRI_STRIDE
from raytracer_tpu_torch.core.types import CameraUniforms, RenderConfig
from raytracer_tpu_torch.kernels import (cuda_build, launches, mega, trace,
                                         wavefront)
from raytracer_tpu_torch.kernels.bounce import (UNIFORM_BUDGET, bounce15,
                                                pack_state)
from raytracer_tpu_torch.kernels.trace import BBLOCK, BLOCK, pick_tile
from raytracer_tpu_torch.kernels.tracer import (TraversalResult,
                                                fixed_light_color,
                                                initial_seed,
                                                make_primary_rays, shade,
                                                shade_plain)

TILE_H = 8
TILE_W = 8
TILE = TILE_H * TILE_W      # primary group of RAYTPU_B0=packet: 8x8 pixels
# Steps between loop tests: the JAX package's RAYTPU_TRAVERSE_UNROLL
# default (a tile-shape knob the port does not read; it changes no result).
TRAVERSE_UNROLL = 2


def tail_merge_widths(cfg: RenderConfig, band_h: int, nb: int):
    """(handoff_width, merged_width) for the cross-band deep-round merge,
    or None when it cannot apply (one band, one bounce, fixed light, or a
    band too small to have deep levels, or ``RAYTPU_TAIL_MERGE=0``). The
    handoff is the band ladder width nearest band rays / 4 (>= the
    narrowest level)."""
    if (nb <= 1 or cfg.max_bounces <= 1 or cfg.shading == "fixed_light"
            or not knobs.tail_merge()):
        return None
    p = band_h * cfg.width
    grain = max(BLOCK, BBLOCK)
    p_pad = -(-p // grain) * grain
    widths = wavefront.round_widths(p_pad)
    target = max(wavefront.min_width(), p_pad // 4)
    cands = [w for w in widths[1:] if w <= target]
    if not cands:
        return None
    return cands[0], nb * cands[0]


def tail_merge_active(scene: FastScene, cfg: RenderConfig) -> bool:
    """The JAX ``packet.tail_merge_active``: the knobs' rule and a wide
    table (a scene without one runs the split rounds, which hand off no
    tail)."""
    return scene.nodes4 is not None and knobs.tail_merge_active(cfg)


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


def primary_rays_plain(cam: CameraUniforms, cfg: RenderConfig, p_pad: int,
                       y_offset: int, gh: int, sample_index: int, device):
    """A band's tile-major primaries (cfg.height rows from global row
    ``y_offset`` of a ``gh``-row frame, ``p_pad`` rays) -> (rays f32[6,
    p_pad] (origin xyz, direction xyz: kernel A's input), seed (u32 values
    in int64; None in the fixed-light tier, whose rays are unjittered),
    alive bool[p_pad], pix_local i32[p_pad] (the band-local pixel id; p for
    a pad ray, so its deposits drop))."""
    h, w = cfg.height, cfg.width
    p = h * w
    xx, yy_local, alive = _tile_major_pixels(h, w, p_pad, device)
    yy = yy_local + y_offset
    pix_local = torch.where(alive, yy_local * w + xx, p).to(torch.int32)
    if cfg.shading == "fixed_light":
        # C12 tier: unjittered primaries, no seed.
        seed = None
        _, ray_o, ray_d = make_primary_rays(cam, cfg, None, xx, yy, gh,
                                            jitter=False)
    else:
        seed = initial_seed(cam, cfg, yy * w + xx, sample_index)
        seed, ray_o, ray_d = make_primary_rays(cam, cfg, seed, xx, yy, gh)
    return torch.stack([*ray_o, *ray_d]), seed, alive, pix_local


def _camera_rows(cam: CameraUniforms, device: torch.device) -> tuple:
    """The ray-gen kernel's camera rows and frame count, checked to lie
    on ``device`` (a CUDA device)."""
    rows = (cam.origin, cam.lower_left_corner, cam.horizontal, cam.vertical,
            cam.frame_count)
    dev = cam.origin.device
    if (dev.type != "cuda" or device.index not in (None, dev.index)
            or any(r.device != dev for r in rows)
            or any(r.dtype != torch.float32 or r.shape != (3,)
                   or r.stride() != (1,) for r in rows[:4])
            or cam.frame_count.dtype != torch.int32
            or cam.frame_count.numel() != 1):
        raise ValueError("the camera uniforms must be contiguous f32[3] and "
                         f"the frame count an i32 on {device}")
    return rows


def primary_rays(cam: CameraUniforms, cfg: RenderConfig, p_pad: int,
                 y_offset: int, gh: int, sample_index: int, device):
    """``primary_rays_plain`` as one launch of the ray-gen kernel
    (``csrc/front.cu``, its unjittered build in the fixed-light tier) on
    a CUDA device, reading the camera and the frame count where they lie
    on the card; ``primary_rays_plain`` itself on the CPU. The same
    arguments and results, bit for bit."""
    device = torch.device(device)
    if not launches.on_card("raygen", device):
        return primary_rays_plain(cam, cfg, p_pad, y_offset, gh,
                                  sample_index, device)
    h, w = cfg.height, cfg.width
    if not 0 < h * w <= p_pad:
        raise ValueError(f"p_pad {p_pad} must hold the band's {h * w} rays")
    th, tw = pick_tile(h, w) or (1, w)    # (1, w): raster order
    jitter = cfg.shading != "fixed_light"
    cams = _camera_rows(cam, device)
    dev = cams[0].device
    rays = torch.empty((6, p_pad), dtype=torch.float32, device=dev)
    seed = (torch.empty(p_pad, dtype=torch.int64, device=dev)
            if jitter else None)
    alive = torch.empty(p_pad, dtype=torch.bool, device=dev)
    pix = torch.empty(p_pad, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(cuda_build.library().rt_raygen(
        *(c.data_ptr() for c in cams), rays.data_ptr(),
        seed.data_ptr() if jitter else None, alive.data_ptr(),
        pix.data_ptr(), p_pad, h * w, w, th, tw, y_offset, gh, int(jitter),
        int(cfg.rng_mode == "reference"), cfg.samples_per_pixel,
        sample_index, stream), "rt_raygen")
    launches.launched("raygen")
    return rays, seed, alive, pix


def _cluster_mt(crow, ray_o, ray_d, closest_t, gate, state,
                cfg: RenderConfig):
    """Dense Moller-Trumbore of rays against one leaf each (the JAX
    ``_cluster_mt``): crow f32[N, cs * 16] (rows of
    ``FastScene.leaf_rows``); ray comps and ``closest_t`` /
    ``gate`` shaped [..., N] (flat [P] with N = P, or grouped [G, NG] with
    N = NG); ``state`` = (nx, ny, nz, ar, ag, ab, mt) shaped like the rays.
    The closest of the cs slots by argmin (the lowest slot on a tie), its
    normal, albedo and type selected by a one-hot sum; the normal faces the
    ray except in the fixed-light tier. -> (closest_t, state)."""
    tris = crow.view(crow.shape[0], -1, TRI_STRIDE)
    c = lambda j: tris[..., j]                              # [N, cs]
    rox, roy, roz = (a.unsqueeze(-1) for a in ray_o)       # [..., N, 1]
    rdx, rdy, rdz = (a.unsqueeze(-1) for a in ray_d)
    v0x, v0y, v0z = c(0), c(1), c(2)
    e1x, e1y, e1z = c(3), c(4), c(5)
    e2x, e2y, e2z = c(6), c(7), c(8)
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = ~((det > -cfg.det_eps) & (det < cfg.det_eps))
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = rox - v0x, roy - v0y, roz - v0z
    u = inv_det * (sx * pvx + sy * pvy + sz * pvz)
    ok &= (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv_det * (rdx * qx + rdy * qy + rdz * qz)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    ok &= ((t > cfg.t_min) & (t < closest_t.unsqueeze(-1))
           & gate.unsqueeze(-1))

    t_masked = torch.where(ok, t, torch.inf)
    best = t_masked.argmin(-1, keepdim=True)
    best_t = t_masked.gather(-1, best).squeeze(-1)
    upd = torch.isfinite(best_t)
    onehot = torch.arange(tris.shape[1], device=crow.device) == best

    def sel(j):
        return torch.where(onehot, c(j), 0.0).sum(-1)

    nx, ny, nz = sel(13), sel(14), sel(15)  # unit length (pack time)
    if cfg.shading != "fixed_light":
        # C14 flips toward the ray; C12 keeps the raw winding normal.
        flip = (ray_d[0] * nx + ray_d[1] * ny + ray_d[2] * nz) > 0.0
        nx, ny, nz = (torch.where(flip, -n, n) for n in (nx, ny, nz))
    new = (nx, ny, nz, sel(9), sel(10), sel(11), sel(12))
    closest_t = torch.where(upd, best_t, closest_t)
    return closest_t, tuple(torch.where(upd, a, b)
                            for a, b in zip(new, state))


def _slab(rows, ray_o, inv_d, closest_t, t_min: float):
    """Slab test of rays against nodes8 rows (broadcast: rows [..., 8]
    beside ray comps [...]) -> bool hit. min / max propagate NaN as
    jnp.minimum / jnp.max do."""
    t_en = t_ex = None
    for ax in range(3):
        t0 = (rows[..., ax] - ray_o[ax]) * inv_d[ax]
        t1 = (rows[..., 3 + ax] - ray_o[ax]) * inv_d[ax]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_en = lo if t_en is None else torch.maximum(t_en, lo)
        t_ex = hi if t_ex is None else torch.minimum(t_ex, hi)
    return (t_ex > t_en) & (t_ex > t_min) & (t_en < closest_t)


def _links(scene: FastScene):
    """nodes8 columns 6-7 as i32 bits: (skip link, col7)."""
    return scene.nodes8[:, 6:8].contiguous().view(torch.int32)


def _zeros7(shape, device):
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z,) * 7


def _result(closest_t, state, cfg: RenderConfig) -> TraversalResult:
    nx, ny, nz, ar, ag, ab, mt = state
    return TraversalResult(closest_t, closest_t < cfg.t_max, (nx, ny, nz),
                           (ar, ag, ab), mt)


def packet_traverse(scene: FastScene, ray_o, ray_d, active,
                    cfg: RenderConfig) -> TraversalResult:
    """Closest hit of grouped rays (the JAX ``packet_traverse``), plain
    torch: comps and ``active`` shaped [G, NG]; each group (a column)
    walks the skip-link tree with one node pointer, descending into any
    node one of its rays hits; fully inactive groups start at the end.
    Returns flat [G * NG] results. On the card the frame runs
    ``trace2_warp`` instead (one node id a warp)."""
    g, ng = active.shape
    num_nodes = scene.num_nodes
    dev = active.device
    links = _links(scene)
    inv_d = tuple(1.0 / c for c in ray_d)
    node = torch.where(active.any(0), 0, num_nodes)
    closest_t = torch.full((g, ng), cfg.t_max, device=dev)
    state = _zeros7((g, ng), dev)
    while bool((node < num_nodes).any()):
        for _ in range(TRAVERSE_UNROLL):
            in_flight = node < num_nodes
            safe = torch.where(in_flight, node, 0)
            rows = scene.nodes8.index_select(0, safe)       # [NG, 8]
            skip, col7 = links[safe, 0], links[safe, 1]
            launches.work["visits2"] += int(in_flight.sum())
            ray_hit = _slab(rows, ray_o, inv_d, closest_t,
                            cfg.t_min) & active
            group_hit = ray_hit.any(0) & in_flight
            is_leaf = col7 >= 0
            do_leaf = group_hit & is_leaf
            cid = torch.where(do_leaf, col7, 0)
            launches.work["tris"] += int(
                (scene.cluster_counts[cid] * do_leaf).sum())
            crow = scene.leaf_rows.index_select(0, cid)
            closest_t, state = _cluster_mt(crow, ray_o, ray_d, closest_t,
                                           do_leaf & active, state, cfg)
            descend = group_hit & ~is_leaf
            node = torch.where(in_flight,
                               torch.where(descend, -col7 - 1, skip), node)
    return _result(closest_t.reshape(g * ng),
                   tuple(x.reshape(g * ng) for x in state), cfg)


def ray_traverse_fast(scene: FastScene, ray_o, ray_d, active,
                      cfg: RenderConfig) -> TraversalResult:
    """Per-ray closest hit over the packed tables (the JAX
    ``ray_traverse_fast``), plain torch: flat f32[P] comps, every ray one
    node a step. On the card the frame runs ``trace2`` instead."""
    p = active.shape[0]
    num_nodes = scene.num_nodes
    dev = active.device
    links = _links(scene)
    inv_d = tuple(1.0 / c for c in ray_d)
    node = torch.where(active, 0, num_nodes)
    closest_t = torch.full((p,), cfg.t_max, device=dev)
    state = _zeros7((p,), dev)
    while bool((node < num_nodes).any()):
        for _ in range(TRAVERSE_UNROLL):
            node, closest_t, state = _walk_step(scene, links, node,
                                                closest_t, state, ray_o,
                                                ray_d, inv_d, cfg,
                                                active)
    return _result(closest_t, state, cfg)


def _walk_step(scene: FastScene, links, node, closest_t, state, ray_o,
               ray_d, inv_d, cfg: RenderConfig, active=None):
    """One node visit of every ray whose node is < num_nodes (the
    traversal step of ``ray_traverse_fast`` and ``_mega_level``)."""
    in_flight = node < scene.num_nodes
    safe = torch.where(in_flight, node, 0)
    rows = scene.nodes8.index_select(0, safe)               # [P, 8]
    skip, col7 = links[safe, 0], links[safe, 1]
    launches.work["visits2"] += int(in_flight.sum())
    ray_hit = _slab(rows, ray_o, inv_d, closest_t, cfg.t_min) & in_flight
    if active is not None:
        ray_hit &= active
    is_leaf = col7 >= 0
    do_leaf = ray_hit & is_leaf
    cid = torch.where(do_leaf, col7, 0)
    launches.work["tris"] += int((scene.cluster_counts[cid] * do_leaf).sum())
    crow = scene.leaf_rows.index_select(0, cid)
    closest_t, state = _cluster_mt(crow, ray_o, ray_d, closest_t, do_leaf,
                                   state, cfg)
    descend = ray_hit & ~is_leaf
    node = torch.where(in_flight, torch.where(descend, -col7 - 1, skip),
                       node)
    return node, closest_t, state


def megakernel_bounces(scene: FastScene, ray_o, ray_d, color, atten, seed,
                       alive, sky_on: bool, cfg: RenderConfig,
                       start_bounce: int = 1, pix=None,
                       n_out: int | None = None, walks: bool = False):
    """Every bounce as ONE fused per-ray loop with live-ray width
    compaction (the JAX ``megakernel_bounces``), plain torch: the plain
    version of the ``mega`` kernel (``kernels/mega.py``).

    A ray whose walk ends is shaded and, when it scattered and
    ``bounce + 1 < max_bounces``, respawns into its next bounce in the
    same step. The loop runs at widths P, P/r, P/r^2, ... (r and the
    floor from ``knobs.compact_levels``, read here as the JAX package
    reads them): when the live rays fit the next width they are
    cumsum-compacted into its prefix, finished rays deposit their colour
    at ``pix`` at each level boundary, and the slots past the live count
    (clones of ray 0's state) are killed: done, dropped pixel id, zero
    colour. Node pointer: < num_nodes walking, == num_nodes shading,
    > num_nodes done. Shading runs on the shading rays only, which leaves
    every other ray's state as the JAX masked shade does.

    ``pix``: each ray's deposit cell (default its index); cells >=
    ``n_out`` (default P) are dropped. Returns (color f32[3, n_out], rays
    traced: the live rays plus every respawn, int64 tensor), and with
    ``walks`` also i64[P], each ray's walks (its bounces run)."""
    p = alive.shape[0]
    dev = alive.device
    n_out = p if n_out is None else n_out
    num_nodes = scene.num_nodes
    done = num_nodes + 1
    if pix is None:
        pix = torch.arange(p, device=dev)
    st = dict(node=torch.where(alive, 0, done),
              closest_t=torch.full((p,), cfg.t_max, device=dev),
              hitstate=_zeros7((p,), dev), ray_o=tuple(ray_o),
              ray_d=tuple(ray_d), color=tuple(color), atten=tuple(atten),
              seed=seed, bounce=torch.full((p,), start_bounce, device=dev),
              pix=pix.to(torch.int64), rid=torch.arange(p, device=dev))
    rays = alive.sum()
    floor, ratio = knobs.compact_levels()
    levels = [p]
    while levels[-1] // ratio >= min(floor, p):
        levels.append(levels[-1] // ratio)

    out = torch.zeros((3, n_out + 1), dtype=torch.float32, device=dev)
    n_walks = torch.zeros(p + 1, dtype=torch.int64, device=dev)
    for li, width in enumerate(levels):
        is_last = li == len(levels) - 1
        next_width = None if is_last else levels[li + 1]
        st, rays = _mega_level(scene, st, rays, sky_on, cfg, done,
                               next_width)
        # Deposit finished rays' colours; compact live rays for the next
        # level.
        live = st["node"] <= num_nodes
        deposit = ~live if not is_last else torch.ones_like(live)
        didx = torch.where(deposit, st["pix"], n_out).clamp(max=n_out)
        out.index_add_(1, didx, torch.stack(st["color"]))
        n_walks.index_add_(0, torch.where(deposit, st["rid"], p),
                           st["bounce"] - start_bounce)
        if is_last:
            break
        pos = torch.cumsum(live.to(torch.int64), 0) - 1
        live_count = live.sum()
        slots = torch.where(live, pos, next_width)
        order = torch.zeros(next_width + 1, dtype=torch.int64, device=dev)
        order[slots] = torch.arange(width, device=dev)    # p -> dropped
        order = order[:next_width]
        # Exactly the first live_count slots are filled (the compaction is
        # dense); the slots past them are clones of ray 0's state and are
        # killed thoroughly: done node, dropped pixel id, zero colour.
        valid = torch.arange(next_width, device=dev) < live_count
        take = lambda x: x.index_select(0, order)
        takes = lambda xs: tuple(take(x) for x in xs)
        st = dict(node=torch.where(valid, take(st["node"]), done),
                  closest_t=take(st["closest_t"]),
                  hitstate=takes(st["hitstate"]),
                  ray_o=takes(st["ray_o"]), ray_d=takes(st["ray_d"]),
                  color=tuple(torch.where(valid, take(c), 0.0)
                              for c in st["color"]),
                  atten=takes(st["atten"]), seed=take(st["seed"]),
                  bounce=take(st["bounce"]),
                  pix=torch.where(valid, take(st["pix"]), n_out),
                  rid=torch.where(valid, take(st["rid"]), p))
    res = (out[:, :n_out], rays)
    return res + (n_walks[:p],) if walks else res


def _mega_level(scene: FastScene, st: dict, rays, sky_on: bool,
                cfg: RenderConfig, done: int, exit_width):
    """Run the fused walk + shade loop at one width until every ray is
    done or, with ``exit_width``, until the live rays fit in it."""
    num_nodes = scene.num_nodes
    links = _links(scene)
    live_count = st["node"].shape[0]
    while True:
        if not bool((st["node"] <= num_nodes).any()):
            break
        if exit_width is not None and not live_count > exit_width:
            break
        for _ in range(TRAVERSE_UNROLL):
            st, rays, live_count = _mega_step(scene, links, st, rays,
                                              sky_on, cfg, done)
        live_count = int(live_count)
    return st, rays


def _mega_step(scene: FastScene, links, st: dict, rays, sky_on: bool,
               cfg: RenderConfig, done: int):
    """One step of the JAX ``_mega_level`` body: a node visit of every
    walking ray, then the shade of every ray whose walk just ended."""
    num_nodes = scene.num_nodes
    inv_d = tuple(1.0 / c for c in st["ray_d"])
    node, closest_t, hitstate = _walk_step(
        scene, links, st["node"], st["closest_t"], st["hitstate"],
        st["ray_o"], st["ray_d"], inv_d, cfg)
    st = dict(st, node=node, closest_t=closest_t, hitstate=hitstate)

    shading = node == num_nodes
    idx = torch.nonzero(shading).squeeze(1)
    if idx.numel():
        launches.work["shades"] += idx.numel()
        sub = lambda xs: tuple(x[idx] for x in xs)
        nx, ny, nz, ar, ag, ab, mt = sub(hitstate)
        t = closest_t[idx]
        res = TraversalResult(t, t < cfg.t_max, (nx, ny, nz), (ar, ag, ab),
                              mt)
        draws = []
        o, d, c, a, s, scattered = shade_plain(
            res, sub(st["ray_o"]), sub(st["ray_d"]), sub(st["color"]),
            sub(st["atten"]), st["seed"][idx],
            torch.ones(idx.numel(), dtype=torch.bool, device=idx.device),
            sky_on, cfg, draws)
        launches.work["draws"] += int(sum(draws))

        def put(xs, ys):
            out = tuple(x.clone() for x in xs)
            for x, y in zip(out, ys):
                x[idx] = y
            return out

        seed = st["seed"].clone()
        seed[idx] = s
        respawn = torch.zeros_like(shading)
        respawn[idx] = scattered & (st["bounce"][idx] + 1 < cfg.max_bounces)
        st = dict(st, ray_o=put(st["ray_o"], o), ray_d=put(st["ray_d"], d),
                  color=put(st["color"], c), atten=put(st["atten"], a),
                  seed=seed)
    else:
        respawn = shading
    rays = rays + respawn.sum()
    bounce = torch.where(shading, st["bounce"] + 1, st["bounce"])
    node = torch.where(shading, torch.where(respawn, 0, done), node)
    # Reset per-bounce hit state for respawned rays (the hit state itself
    # stays stale: a shade reads it only under a hit).
    closest_t = torch.where(respawn, cfg.t_max, closest_t)
    live_count = (node <= num_nodes).sum()
    return dict(st, node=node, closest_t=closest_t, bounce=bounce), rays, \
        live_count


def _pmega(scene: FastScene, ray_o, ray_d, color, atten, seed, alive,
           sky_on: bool, cfg: RenderConfig, pix):
    """``RAYTPU_BOUNCE=pmega``: one stable sort by the host key of
    ``RAYTPU_SORT_KEY`` (u32, dead bit 31; ``cid`` in its ``om9`` form),
    one gather, then every bounce in ONE ``bounce15`` call (bcap =
    max_bounces - 1, budget never gating, the cid build with the ordered
    walk); colours deposit at the sorted pixel ids, a channel at a time.
    The kernel's key is not used. Returns (color f32[3, P], rays traced in
    the call)."""
    smin, smax = scene.bounds()
    key = wavefront.sort_key(ray_o, ray_d, alive, smin, smax,
                             knobs.sort_key_mode())
    state = pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET, pix,
                       color=color)
    state = state.index_select(1, torch.argsort(key, stable=True))
    state, _, counts = bounce15(scene, state, cfg.max_bounces - 1, sky_on,
                                cfg)
    deposits = wavefront._Deposits(alive.shape[0], alive.device, "ch")
    deposits.add_state(state)
    return deposits.colors(), counts[0]


def _traverse_fast(scene: FastScene, ray_o, ray_d, active,
                   cfg: RenderConfig) -> TraversalResult:
    """``ray_traverse_fast``: kernel 5's per-ray design (``trace2``) on
    CUDA tensors, the plain version on CPU tensors."""
    if not launches.on_card(cuda_build.leaf_kernel_name("trace2",
                                                         scene.layout),
                            active.device):
        return ray_traverse_fast(scene, ray_o, ray_d, active, cfg)
    out = trace.trace2(scene, torch.stack([*ray_o, *ray_d]), active, cfg)
    return trace.hit_result(out, cfg)


def _traverse_groups(scene: FastScene, ray_o, ray_d, active,
                     cfg: RenderConfig) -> TraversalResult:
    """``packet_traverse`` of [G, NG] groups: kernel 5's warp design
    (``trace2_warp``, each group's G rays consecutive) on CUDA tensors,
    the plain version on CPU tensors. Flat [G * NG] results either way."""
    if not launches.on_card(cuda_build.leaf_kernel_name("trace2_warp",
                                                         scene.layout),
                            active.device):
        return packet_traverse(scene, ray_o, ray_d, active, cfg)
    g, ng = active.shape
    rays = torch.stack([*ray_o, *ray_d]).transpose(1, 2).reshape(6, ng * g)
    out = trace.trace2(scene, rays, active.T.reshape(ng * g), cfg,
                       coherent=True)
    out = out.view(8, ng, g).transpose(1, 2).reshape(8, g * ng)
    return trace.hit_result(out, cfg)


def _render_raster(scene: FastScene, cam: CameraUniforms,
                   cfg: RenderConfig, b0: str, sample_index: int,
                   y_offset: int, gh: int):
    """The JAX arms on raster-order rays with no pad: the fixed-light
    tier through ``ray_traverse_fast``, ``RAYTPU_B0=mega`` (the
    megakernel from bounce 0) and ``RAYTPU_B0=packet`` (the group walk,
    the bounce-0 shade, the megakernel from bounce 1) -> (color f32[3,
    h*w], rays traced)."""
    h, w = cfg.height, cfg.width
    p = h * w
    dev = scene.device
    i = torch.arange(p, dtype=torch.int64, device=dev)
    xx, yy = i % w, i // w + y_offset
    alive = torch.ones(p, dtype=torch.bool, device=dev)
    if cfg.shading == "fixed_light":
        _, ray_o, ray_d = make_primary_rays(cam, cfg, None, xx, yy, gh,
                                            jitter=False)
        color = fixed_light_color(_traverse_fast(scene, ray_o, ray_d, alive,
                                                 cfg))
        return torch.stack(color), torch.tensor(p, device=dev)

    seed = initial_seed(cam, cfg, yy * w + xx, sample_index)
    seed, ray_o, ray_d = make_primary_rays(cam, cfg, seed, xx, yy, gh)
    zero = torch.zeros(p, dtype=torch.float32, device=dev)
    one = torch.ones(p, dtype=torch.float32, device=dev)
    color, atten = (zero, zero, zero), (one, one, one)
    sky_on = cam.sky_host
    if b0 == "mega":
        return mega.mega(scene, ray_o, ray_d, color, atten, seed, alive,
                         sky_on, cfg, start_bounce=0)

    # RAYTPU_B0=packet: [H, W] -> [TILE, NT], one 8x8 tile a column.
    def to_groups(a):
        return (a.reshape(h // TILE_H, TILE_H, w // TILE_W, TILE_W)
                .permute(1, 3, 0, 2).reshape(TILE, p // TILE))

    def from_groups(a):
        return (a.reshape(TILE_H, TILE_W, h // TILE_H, w // TILE_W)
                .permute(2, 0, 3, 1).reshape(p))

    res = _traverse_groups(scene, tuple(map(to_groups, ray_o)),
                           tuple(map(to_groups, ray_d)), to_groups(alive),
                           cfg)
    res = TraversalResult(
        from_groups(res.closest_t), from_groups(res.hit),
        tuple(map(from_groups, res.normal)),
        tuple(map(from_groups, res.mat_albedo)), from_groups(res.mat_type))
    ray_o, ray_d, color, atten, seed, alive = shade(
        res, ray_o, ray_d, color, atten, seed, alive, sky_on, cfg)
    if cfg.max_bounces == 1:
        # Exhausted-at-cap rays stay black.
        return torch.stack(color), torch.tensor(p, device=dev)
    cx, rays = mega.mega(scene, ray_o, ray_d, color, atten, seed, alive,
                         sky_on, cfg, start_bounce=1)
    # Rays that never entered the loop keep their bounce-0 colour.
    return torch.where(alive, cx, torch.stack(color)), rays + p


def render_linear_fast(scene: FastScene, cam: CameraUniforms,
                       cfg: RenderConfig, sample_index: int = 0,
                       y_offset: int = 0, global_height: int | None = None,
                       tail_handoff: int | None = None,
                       out: torch.Tensor | None = None,
                       survivors_out: torch.Tensor | None = None):
    """One band (cfg.height rows starting at global row ``y_offset``) ->
    (color f32[3, h*w] in raster order, rays traced (int64 tensor),
    survivors). With ``tail_handoff`` (the sorted rounds after
    ``RAYTPU_B0=pallas`` only: ``tail_merge_active``), the wavefront
    stops at that width and ``survivors`` is the band's live tail (round
    state with global pixel ids, pads at global_height * w) for
    ``wavefront_tail``, written into ``survivors_out`` when given;
    otherwise it is None. The sorted rounds write their colours into
    ``out`` (f32[3, h*w]) when given and return it as ``color``; the other
    paths return colours of their own."""
    if cfg.height % TILE_H or cfg.width % TILE_W:
        raise ValueError("fast path needs resolution divisible by 8")
    b0 = knobs.bounce0()
    h, w = cfg.height, cfg.width
    gh = global_height or h
    if (b0 in ("mega", "packet")
            or (cfg.shading == "fixed_light" and b0 != "pallas")):
        color, rays = _render_raster(scene, cam, cfg, b0, sample_index,
                                     y_offset, gh)
        return color, rays, None

    p = h * w
    dev = scene.device
    grain = max(BLOCK, BBLOCK)
    p_pad = -(-p // grain) * grain
    # Pad rays carry an out-of-range pixel id (p); their deposits drop.
    rays, seed, alive, pix_local = primary_rays(cam, cfg, p_pad, y_offset,
                                                gh, sample_index, dev)
    ray_o, ray_d = rays[0:3].unbind(0), rays[3:6].unbind(0)

    def by_pixel(color):
        out = torch.zeros((3, p + 1), dtype=torch.float32, device=dev)
        out.index_copy_(1, pix_local.to(torch.int64), torch.stack(color))
        return out[:, :p], torch.tensor(p, device=dev), None

    if cfg.shading == "fixed_light":
        # C12 tier: unjittered primaries, raw normals, Lambert + ambient.
        return by_pixel(fixed_light_color(
            trace.traverse_rays(scene, rays, alive, cfg, coherent=True)))

    zero = torch.zeros(p_pad, dtype=torch.float32, device=dev)
    one = torch.ones(p_pad, dtype=torch.float32, device=dev)
    sky_on = cam.sky_host

    if b0 == "pwave" and cfg.max_bounces > 1 and scene.nodes4 is not None:
        # Bounce 0 inside the sorted rounds: kernel B traces and shades
        # the primaries (the first round's key from the unshaded rays).
        col, rays, _ = wavefront.wavefront_bounces(
            scene, ray_o, ray_d, (zero, zero, zero), (one, one, one), seed,
            alive, sky_on, cfg, pix_local, start_bounce=0, dense_pix=True,
            out=out)
        return (col if out is not None else col[:, :p]), rays, None

    res = trace.traverse_rays(scene, rays, alive, cfg, coherent=True)
    ray_o, ray_d, color, atten, seed, alive = shade(
        res, ray_o, ray_d, (zero, zero, zero), (one, one, one), seed, alive,
        sky_on, cfg)
    if cfg.max_bounces == 1:
        return by_pixel(color)
    path = knobs.bounce_path()
    if path == "pmega" and scene.nodes4 is None:
        path = "wave"   # the pmega call walks the wide table
    if path == "pmega":
        col, rays = _pmega(scene, ray_o, ray_d, color, atten, seed, alive,
                           sky_on, cfg, pix_local)
        return col[:, :p], rays + p, None
    if path == "mega":
        col, rays = mega.mega(scene, ray_o, ray_d, color, atten, seed, alive,
                              sky_on, cfg, start_bounce=1, pix=pix_local,
                              n_out=p)
        return col, rays + p, None

    col, rays, surv = wavefront.wavefront_bounces(
        scene, ray_o, ray_d, color, atten, seed, alive, sky_on, cfg,
        pix_local, handoff_width=tail_handoff, dense_pix=True, out=out,
        survivors_out=survivors_out)
    if surv is not None:
        # Survivor pixel ids go global for the cross-band merge; the pad
        # sentinel (p) maps to gh * w so merged deposits still drop it.
        pixl = surv[wavefront.ROW_PIX]
        surv[wavefront.ROW_PIX] = torch.where(pixl >= p, gh * w,
                                              pixl + y_offset * w)
    return (col if out is not None else col[:, :p]), rays + p, surv

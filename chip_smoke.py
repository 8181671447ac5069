"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each (any failure raises and exits non-zero):

1. device: the card's name and its nvidia-smi name / power limit;
2. build: nvcc builds every kernel of ``raytracer_tpu_torch/csrc`` (one
   process per source, all at once) into ``raytracer_tpu_torch/_build``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, with both times and the least time the card
   could take for the same work (``bound_ms``): the tonemap on a 1280x720
   band sum at spp 1 and 2 (0 differing bytes in the accumulator and the
   image; its device time from the profiler and its call time); kernel A
   on the middle 720p band of flagship primaries (307,200 rays); the
   ray-gen and shade kernels (``csrc/front.cu``) on that band (ray-gen
   from the camera, the shade on kernel A's record of its primaries: 0
   differing bytes in every output row; device time from device memory and
   from L2, a call's time); kernel B on that band's sorted bounce-1 state
   and on a merged-tail-width state with mixed bounce budgets (0
   included); kernel 5 in its two designs, ``trace2_warp`` (one node id
   per warp) on the same primaries and ``trace2`` (one thread per ray) on
   the split engine's sorted bounce-1 round of that band, and both and
   kernel A with the normal flip off on the 640x480 C12 primaries (0
   differing lanes required); the colour-carrying kernel (``bounce15``) on
   the sorted bounce-1 band state at bcap 1 (a ``fused`` round) and on the
   same state sorted by the pmega host key at bcap 9 (the pmega call,
   persistent warps), with that call's lane occupancy under one ray per
   thread; the packed kernel on the bounce-1 state as the ``fused_packed``
   round sorts it, with its counting build's SIMD efficiency of the walk's
   visit and leaf loops and its blocks' timer spans (the round's drain and
   block-slot occupancy); kernel A and kernel B on a hand-built 36-level
   tree whose walk pushes 246 stack entries
   (``presets.stack_limit_scene``, need 253 of the 256-slot stack),
   bit-equal;
4. the main path at full size: the flagship scene, ``Renderer`` with
   ``RenderConfig()`` (1280x720, 10 bounces), one warm frame, then 16
   progressive frames with the launch counts of every kernel; writes
   ``out/chip_smoke.png``;
5. one 256x128 frame (2 bands, cross-band tail merge) through the
   kernels and through the plain versions, compared;
6. ``RAYTPU_BOUNCE=pmega`` against the default path in turns (default,
   pmega, pmega, default, twice), 8 720p frames each;
7. the other paths at full width through ``Renderer``: ``fused`` and
   ``fused_packed`` (4 720p frames each), ``split`` with
   ``RAYTPU_TRAVERSE=binary`` (2 frames), and the C12 tier (``c12_cube``,
   640x480, 16 frames) walking the 8-wide and the binary table; writes
   ``out/chip_smoke_c12.png``;
8. a 256x128 frame per new path through the kernels and the plain
   versions, compared;
9. the five presets (``scene/presets.ALL_PRESETS``) at their own widths,
   each built from its ``Scene`` by ``build_fast_scene`` on the card and
   rendered on the default path, one warm frame then
   ``Renderer.render_chain`` of 8 frames: triangles, build seconds, FPS,
   ms per frame, Mrays/s and each kernel's launches per frame; writes
   ``out/preset_<name>.png``;
10. chain against frames: ``render_chain(k=8)`` and 8 ``render`` calls
    on the flagship at 1280x720, 0 differing accumulator and image bytes;
11. the headless app: a preset's ``Scene`` saved as JSON, rendered 16
    frames twice by ``python -m raytracer_tpu_torch.apps.headless``
    with ``--checkpoint`` (the second run resumes), against one
    straight run of 32 frames: 0 differing accumulator bytes;
12. the per-ray path (``kernel="wavefront"``, ``rng_mode="reference"``,
    a ``GpuScene``) on ``cube_plane`` at 160x120, 2 frames, on the card
    and on the CPU in this process (at most ``TIE_FRACTION_MAX`` of the
    u8 pixels differ), and its frame time on the card at 1280x720
    (``cube_plane``, 1 bounce) and at 640x480 (``sphere_light``, 10
    bounces);
13. device builds of the two ``two_humans`` figures (98,596 triangles),
    each mode (``RAYTPU_DEVICE_BUILD`` ``instanced``, ``refit``,
    ``lbvh``, and ``lbvh_ploc``: ``lbvh`` with
    ``RAYTPU_DEVICE_TREE=ploc``): the builder's mode, the card build
    against the port's CPU build (0 differing link / meta words, floats
    within 2 ulp), kernels A, B, ``trace2`` and ``trace2_warp`` on the
    card-built tables against their plain versions (0 differing lanes),
    the per-edit rebuild ms (median of 16 synchronised drags), the device
    launches of one rebuild (profiler) and the host reads per rebuild;
14. ``bench.py``'s ``two_humans`` drag frame per mode at 1280x720, 10
    bounces: rebuild after a 0.05 x move, then render, 16 frames after
    a warm one: FPS, ms/frame, rebuild share, launches per frame;
15. ``RenderEngine`` at 1280x720: an async rebuild, 16 frames under the
    UI tick, a drag swapped in, a rebuild that raises (the old scene
    keeps rendering), ``stop()`` within 5 s, then a ladder session;
16. the viewer on 127.0.0.1 over HTTP: state, keypress -> frame
    latency, add / update / remove an instance (each a device rebuild),
    stop;
17. multi-GPU (``parallel/sharding.py``): the flagship at 1280x720, 10
    bounces, spp = sp, on meshes (dp, sp) = (2, 1), (1, 2), (2, 2) as
    four rank processes on cuda:0 over gloo (``launch``), each frame
    byte-equal to the single-device frame with equal ``rays_traced``,
    each rank's kernels launched and no plain version; three
    accumulated frames on (2, 1), accumulator equal; each mesh's
    ms/frame; the same checks one rank a card over NCCL, (2, 1) and
    (1, 2) where there are two cards, with (2, 2) where there are four
    (else said not run); the headless app's ``--devices 2`` PNG
    against its single-device PNG (two cards, else ``--device cpu`` at
    64x32);

18. the XLA render path: the ``mega`` kernel against the plain
    megakernel (width levels and all) on each 720p band (top, middle,
    bottom) from bounce 0 (``RAYTPU_B0=mega``'s raster primaries) and
    from bounce 1 (``RAYTPU_BOUNCE=mega``'s state after kernel A), 0
    differing colour bytes, with its device time, plain time, bound, the
    walk-level lane occupancy of one ray a thread and its counting
    build's visit and leaf SIMD efficiency under the kernel's schedule
    and under one ray a thread;
    ``RAYTPU_BOUNCE=mega``, ``RAYTPU_B0=mega``, ``RAYTPU_B0=packet`` and
    ``RAYTPU_B0=pwave`` at 1280x720, 10 bounces, in turns with the
    default (default, each path, each again in reverse, default; 4
    frames each): FPS, ms a frame, Mrays/s, kernel launches and device
    activities a frame; C12 with ``RAYTPU_B0=mega`` (640x480, 16 frames),
    its image equal to phase 7's; a 256x128 frame per path through the
    kernels and the plain versions (0 differing pixels, ``b0_pwave``
    kernel B's tie lanes);
19. the host builds (``RAYTPU_BVH=median|sbvh|ploc`` and
    ``RAYTPU_LEAF_COUNTS=0`` of the flagship soup, ``RAYTPU_NATIVE=0`` of
    the ``sphere_light`` preset): build seconds, node, wide and
    leaf-reference counts, kernels A, B, ``trace2`` and ``trace2_warp``
    on each table against their plain versions (0 differing lanes), one
    frame each (a table whose walk needs more than the kernels' 256 stack
    slots is refused, and the refusal is printed);
20. the sorted rounds' knobs: kernel B's ``pd5`` and ``om9`` builds of
    ``bounce12``, ``bounce15`` and ``bounce_packed`` and the unordered
    ``bounce12`` / ``bounce15`` against their plain versions on the
    middle 720p band's bounce-1 state sorted by the build's key (the
    unordered ones also on a merged-tail state with budgets 0-3): 0
    differing bytes, with their times, the plain versions' and the
    bounds; kernel B on that band's bounce-1 and bounce-2 rounds sorted
    by each of the five keys (``cid``, ``pd5``, ``om9``, ``pos``,
    ``oct_morton``), beside the bound; each knob's A/B value at 1280x720,
    10 bounces, 4 frames, with the default before, between and after:
    FPS, ms a frame, kernel launches and device activities a frame; a
    256x128 frame per group of knobs through the kernels and the plain
    versions (0 differing pixels);
21. the table layouts (``RAYTPU_CLUSTER=2|4``, ``RAYTPU_WIDE=16`` and the
    combined 2/16 and 4/16): the five layout libraries built at once
    (nvcc seconds, each kernel's registers, local bytes and blocks per
    SM); on the flagship built in each layout, every kernel of its
    library against its plain version at 0 differing bytes (kernel A on
    the middle band's primaries; ``trace2_warp`` / ``trace2`` and
    ``mega`` at the cluster layouts; kernel B's 15 builds, ``bounce12`` /
    ``bounce15`` / ``bounce_packed`` x ``cid`` / ``pd5`` / ``om9`` and the
    unordered ``bounce12`` / ``bounce15``, on the sorted bounce-1 state
    and on a merged-tail state with budgets 0-3), with their times, the
    plain versions' and the bounds; kernels A and B on the 16-wide stack
    limit tree (need 256); kernels A and B of ``CLUSTER=2``, ``CLUSTER=4``
    and ``WIDE=16`` in turns with the default layout's on the middle
    band; every layout's flagship at 1280x720, 10 bounces on the main
    path (4 frames for those three, 1 for the combined ones) and on the
    paths that run its other builds (1 frame each): FPS, ms a frame,
    Mrays/s, launches a frame; a 256x128 frame per layout, kernels
    against plain versions (0 differing pixels); the ``two_humans`` drag
    at ``WIDE=16`` under ``instanced`` (16-wide TLAS) and ``refit``
    (falls back to ``lbvh``, no wide table, the binary split path);

then a JSON line of per-kernel results (with each CUDA kernel's
registers, local and shared bytes and resident blocks per SM as the main
path launches it, and its launches per frame on the PLOC drag, on each
mesh, on each XLA path, on each knob path and on each layout path) and,
last, the JSON result line.
Each path run resets the launch counts just before it, reads them just
after and fails unless each of its kernels launched and no plain version
ran. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TIE_FRACTION_MAX = 0.005   # lanes / pixels explained by equal-t ties

# The card's peaks for bound_ms (NVIDIA H100 SXM data sheet): HBM bytes/s
# and fp32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# Operations per unit of work the plain versions count
# (``launches.work``: only the work the function needs), priced from the
# kernels' arithmetic: the slab test and centroid key of a live child slot
# of a wide node (pallas_trace.py:332-350), one run of the 19-comparator
# network of an 8-wide node or the 63-comparator network of a 16-wide one
# (a visit that pushes two children or more), a binary node visit (one
# slab test), a Moller-Trumbore test of a live triangle (:436-451), a PCG
# draw with its u32 -> f32 conversion, and the rest of one ray's shade
# (sky, Lambert / metal directions, carry).
OPS = {"slots4": 33, "nets4": 19, "nets16": 63, "visits2": 25, "tris": 54,
       "draws": 12, "shades": 70}


def _sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of fn() over reps runs (CUDA events, after one
    warm-up run unless the caller has just run fn: ``warm=False``)."""
    if warm:
        fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, match: str, cold: bool = False) -> float:
    """Mean device time of a kernel named ``*match*`` (fn() launches one),
    from the profiler's kernel durations over reps calls (after one
    warm-up call; the profiler may drop a few events, and now and then a
    whole window's: up to three windows are profiled until one holds at
    least half the kernels). ``cold``: a 256 MB memset before each call
    evicts the 50 MB L2, so the call reads its inputs from device
    memory."""
    from torch.profiler import ProfilerActivity, profile

    flush = (torch.empty(64 << 20, dtype=torch.int32, device="cuda")
             if cold else None)
    fn()
    _sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.zero_()
                fn()
            _sync()
        durs = [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and match in e.name]
        if len(durs) >= reps // 2:
            break
    assert reps // 2 <= len(durs) <= reps, (
        f"profiler saw {len(durs)} {match} kernels in {reps} calls")
    return sum(durs) / len(durs) / 1e3


def bound(nbytes: float, work=None) -> dict:
    """Least time for the work: the larger of the bytes over the memory
    rate and the operations (work counted by the plain version, priced by
    OPS) over the fp32 rate."""
    ops = sum(OPS[k] * v for k, v in (work or {}).items() if k in OPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def knob_env(env: dict):
    """Set path knobs (RAYTPU_*) for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plain_work(fn):
    """fn() with the plain versions' work counted -> (result, work)."""
    from raytracer_tpu_torch.kernels import launches

    launches.work.clear()
    out = fn()
    _sync()
    return out, dict(launches.work)


def check_tonemap(results):
    """The tonemap on a 1280x720 band sum: accumulator and image bit-equal
    to the plain version at spp 1 and 2; device and call time at spp 1
    (the main path's)."""
    from raytracer_tpu_torch.kernels.tonemap import (tonemap_accumulate,
                                                     tonemap_plain)

    g = torch.Generator(device="cuda").manual_seed(11)
    h, w = 720, 1280
    accum = torch.rand((h, w, 3), generator=g, device="cuda") * 1.5
    total = torch.rand((3, h * w), generator=g, device="cuda") * 3.0
    fc = torch.tensor(5, dtype=torch.int32, device="cuda")
    ex = torch.tensor(0.5, device="cuda")
    n_diff = 0
    for spp in (1, 2):
        acc_k, img_k = tonemap_accumulate(accum.clone(), total, spp, fc, ex)
        acc_p, img_p = tonemap_plain(accum.clone(), total, spp, fc, ex)
        _sync()
        n_diff += int((acc_k.view(torch.int32) != acc_p.view(torch.int32))
                      .sum()) + int((img_k != img_p).sum())
    scratch = accum.clone()

    def call():
        return tonemap_accumulate(scratch, total, 1, fc, ex)

    ms = device_ms(call, 50, "tonemap", cold=True)
    warm_ms = device_ms(call, 50, "tonemap")
    call_ms = time_ms(call, 50)
    plain_ms = time_ms(lambda: tonemap_plain(scratch, total, 1, fc, ex), 50)
    print(f"check tonemap 1280x720, spp 1 and 2: differing accumulator "
          f"words and image bytes {n_diff}; kernel on the device {ms:.4f} ms "
          f"from device memory, {warm_ms:.4f} ms with its 25 MB in L2; "
          f"{call_ms:.4f} ms a call; plain {plain_ms:.4f} ms")
    assert n_diff == 0
    # Reads the band sum and the accumulator, writes the accumulator and
    # the u8 frame.
    results["tonemap"] = dict(max_abs_err=0.0, ms=ms, warm_ms=warm_ms,
                              call_ms=call_ms, plain_ms=plain_ms,
                              **bound(nbytes(total, accum, acc_k, img_k)))


def band_primaries(scene, cfg, cam, band=None):
    """Band ``band`` of the frame (default the middle one, which sees the
    most of the scene): tile-major primaries exactly as
    kernels/packet.render_linear_fast makes them."""
    import dataclasses

    from raytracer_tpu_torch.engine.renderer import _num_bands
    from raytracer_tpu_torch.kernels.packet import _tile_major_pixels
    from raytracer_tpu_torch.kernels.trace import BBLOCK, BLOCK
    from raytracer_tpu_torch.kernels.tracer import (initial_seed,
                                                    make_primary_rays)

    nb = _num_bands(cfg)
    band_h = cfg.height // nb
    bcfg = dataclasses.replace(cfg, height=band_h)
    p = band_h * cfg.width
    grain = max(BLOCK, BBLOCK)
    p_pad = -(-p // grain) * grain
    xx, yy_local, alive = _tile_major_pixels(band_h, cfg.width, p_pad,
                                             "cuda")
    yy = yy_local + (nb // 2 if band is None else band) * band_h
    seed = initial_seed(cam, bcfg, yy * cfg.width + xx, 0)
    seed, ray_o, ray_d = make_primary_rays(cam, bcfg, seed, xx, yy,
                                           cfg.height,
                                           cfg.shading != "fixed_light")
    pix = torch.where(alive, yy_local * cfg.width + xx, p).to(torch.int32)
    return bcfg, seed, ray_o, ray_d, alive, pix


def trace_bytes(scene, rays, table: str) -> int:
    """Rays and active flags in, 8 output rows out, the tables once."""
    p = rays.shape[1]
    return (nbytes(rays) + p + 8 * 4 * p
            + nbytes(getattr(scene, table), scene.clusters))


def compare_trace(scene, rays, active, cfg, name="trace4"):
    """Kernel A (or ``trace2``, or ``trace2_warp``: ``trace2`` for coherent
    rays) vs plain on the same rays -> (kernel out, plain out, tie mask,
    max abs err outside ties, plain work)."""
    from raytracer_tpu_torch.kernels import trace

    if name == "trace2_warp":
        name = "trace2"
        out_k = trace.trace2(scene, rays, active, cfg, coherent=True)
    else:
        out_k = getattr(trace, name)(scene, rays, active, cfg)
    out_p, work = plain_work(
        lambda: getattr(trace, f"{name}_plain")(scene, rays, active, cfg))
    assert torch.equal(out_k[0], out_p[0]), f"{name} t differs from plain"
    ties = (out_k != out_p).any(0)
    err = (out_k - out_p)[:, ~ties].abs().max().item() if (~ties).any() \
        else 0.0
    return out_k, out_p, ties, err, work


def check_trace(scene, cfg, cam, results):
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain

    _, _, ray_o, ray_d, alive, _ = band_primaries(scene, cfg, cam)
    rays = torch.stack([*ray_o, *ray_d]).contiguous()
    _, _, ties, err, work = compare_trace(scene, rays, alive, cfg)
    n_tie = int(ties.sum())
    ms = time_ms(lambda: trace4(scene, rays, alive, cfg), 10)
    plain_ms = time_ms(lambda: trace4_plain(scene, rays, alive, cfg), 1,
                       warm=False)
    print(f"check kernel A, {rays.shape[1]} primaries: t bit-equal, tie "
          f"lanes {n_tie}, max abs err outside ties {err:.3g}; kernel "
          f"{ms:.4f} ms plain {plain_ms:.2f} ms; work {work}")
    assert n_tie <= TIE_FRACTION_MAX * rays.shape[1] and err == 0.0
    results["trace4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(trace_bytes(scene, rays, "nodes4"),
                                     work))


def check_trace2(scene, cfg, cam, c12, results):
    """Kernel 5 in its two designs, each at its path's shape: the warp
    walk (``trace2_warp``) on the flagship band primaries (flip on), the
    per-ray walk (``trace2``) on the split engine's sorted bounce-1 round;
    then both and kernel A on the C12 primaries (flip off): 0 differing
    lanes everywhere."""
    from raytracer_tpu_torch.kernels.trace import trace2, trace2_plain

    _, _, ray_o, ray_d, alive, _ = band_primaries(scene, cfg, cam)
    shapes = (("trace2_warp", "primaries",
               torch.stack([*ray_o, *ray_d]).contiguous(), alive, True),
              ("trace2", "split-round rays",
               *split_round1(scene, cfg, cam), False))
    for name, label, rays, active, coherent in shapes:
        _, _, ties, err, work = compare_trace(scene, rays, active, cfg,
                                              name)
        ms = time_ms(lambda: trace2(scene, rays, active, cfg, coherent), 10)
        plain_ms = time_ms(lambda: trace2_plain(scene, rays, active, cfg),
                           1, warm=False)
        print(f"check {name}, {rays.shape[1]} {label} ({int(active.sum())} "
              f"active, flip on): differing lanes {int(ties.sum())}; kernel "
              f"{ms:.4f} ms plain {plain_ms:.2f} ms; work {work}")
        assert not ties.any() and err == 0.0
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(trace_bytes(scene, rays, "nodes8"),
                                     work))

    scene12, cfg12, cam12 = c12
    _, _, ray_o, ray_d, alive, _ = band_primaries(scene12, cfg12, cam12)
    rays = torch.stack([*ray_o, *ray_d]).contiguous()
    for name in ("trace2_warp", "trace2", "trace4"):
        _, _, ties, err, _ = compare_trace(scene12, rays, alive, cfg12, name)
        print(f"check {name}, {rays.shape[1]} C12 primaries (flip off): "
              f"differing lanes {int(ties.sum())}")
        assert not ties.any() and err == 0.0


def band_bounce1(scene, cfg, cam, band=None):
    """A band (default the middle one) after bounce 0 (kernel A + shade):
    (ray_o, ray_d, color, atten, seed, alive, pix)."""
    from raytracer_tpu_torch.kernels.trace import traverse
    from raytracer_tpu_torch.kernels.tracer import shade

    _, seed, ray_o, ray_d, alive, pix = band_primaries(scene, cfg, cam,
                                                       band)
    p = alive.shape[0]
    zero = torch.zeros(p, device="cuda")
    one = torch.ones(p, device="cuda")
    res = traverse(scene, ray_o, ray_d, alive, cfg)
    o, d, color, atten, seed, alive = shade(
        res, ray_o, ray_d, (zero,) * 3, (one,) * 3, seed, alive, True, cfg)
    return o, d, color, atten, seed, alive, pix


def split_round1(scene, cfg, cam):
    """The split engine's first bounce round of the middle band, as
    ``trace2`` gets it under ``RAYTPU_WAVE=split RAYTPU_TRAVERSE=binary``:
    the bounce-1 state sorted by the host ``om9`` key (dead bit 31), dead
    rays inactive -> (rays f32[6, P], active bool[P])."""
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE,
                                                    UNIFORM_BUDGET,
                                                    pack_state)

    with knob_env({"RAYTPU_TRAVERSE": "binary"}):
        o, d, color, atten, seed, alive, pix = band_bounce1(scene, cfg, cam)
    state = pack_state(o, d, atten, seed, alive, UNIFORM_BUDGET, pix,
                       color=color)
    state, _ = wavefront._sorted(
        state, wavefront._state_key(state, scene, "split"))
    return state[0:6].view(torch.float32).contiguous(), state[ROW_ALIVE] != 0


def pmega_state(scene, cfg, cam, band=None):
    """The state the pmega call gets for a band (default the middle one):
    the colour-carrying bounce-1 state sorted by the host key."""
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import UNIFORM_BUDGET, pack_state

    o, d, color, atten, seed, alive, pix = band_bounce1(scene, cfg, cam,
                                                        band)
    flat = pack_state(o, d, atten, seed, alive, UNIFORM_BUDGET, pix,
                      color=color)
    order = torch.argsort(wavefront.sort_key(o, d, alive, *scene.bounds()),
                          stable=True)
    return flat.index_select(1, order)


def packed_state(scene, cfg, cam, band=None):
    """The state the ``fused_packed`` round gets for a band (default the
    middle one): the bounce-1 state packed and sorted as that engine does
    -> (sf f32[13, P], si i32[2, P])."""
    from raytracer_tpu_torch.kernels import wavefront

    o, d, color, atten, seed, alive, pix = band_bounce1(scene, cfg, cam,
                                                        band)
    sf = torch.stack([*o, *d, *color, *atten, alive.to(torch.float32)])
    si = torch.stack([seed.to(torch.int32), pix])
    key = wavefront._state_key((sf, si), scene)
    return wavefront._sorted((sf, si), key)[0]


def lane_occupancy(state_in, state_out, warp: int = 32) -> dict:
    """Iterations per ray of a bounce call (the budget it spent) and the
    lane occupancy of one ray per thread: the iterations run over 32 x
    the longest path of each warp of 32 consecutive rays."""
    from raytracer_tpu_torch.kernels.bounce import ROW_BUDGET

    iters = (state_in[ROW_BUDGET] - state_out[ROW_BUDGET]).to(torch.int64)
    it = torch.nn.functional.pad(iters, (0, -iters.numel() % warp))
    longest = int(it.view(-1, warp).amax(1).sum())
    return dict(occupancy=int(iters.sum()) / max(warp * longest, 1),
                mean_iterations=float(iters.float().mean()),
                max_iterations=int(iters.max()))


def compare_bounce(scene, state, cfg, label):
    """Kernel B vs plain on one state; lanes may differ only where kernel
    A's walk of the same rays is an equal-t tie."""
    from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, bounce12,
                                                    bounce12_plain)

    out_k, key_k, cnt_k = bounce12(scene, state, 1, True, cfg)
    (out_p, key_p, cnt_p), work = plain_work(
        lambda: bounce12_plain(scene, state, 1, True, cfg))
    fk, fp = out_k[0:9].view(torch.float32), out_p[0:9].view(torch.float32)
    diff = ((out_k[9:] != out_p[9:]).any(0) | (key_k != key_p)
            | ((fk - fp).abs() > 2e-5).any(0))
    rays = state[0:6].view(torch.float32).contiguous()
    _, _, ties, _, _ = compare_trace(scene, rays, state[ROW_ALIVE] != 0, cfg)
    assert not (diff & ~ties).any(), (
        f"kernel B differs from plain outside tie lanes ({label})")
    assert torch.equal(cnt_k, cnt_p) or bool(ties.any()), (cnt_k, cnt_p)
    keep = ~diff
    err = (fk - fp)[:, keep].abs().max().item() if keep.any() else 0.0
    return int(diff.sum()), int(ties.sum()), err, cnt_k.tolist(), work


def check_bounce(scene, cfg, cam, results):
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                    UNIFORM_BUDGET, bounce12,
                                                    bounce12_plain,
                                                    pack_state)
    from raytracer_tpu_torch.kernels.packet import tail_merge_widths

    o, d, color, atten, seed, alive, pix = band_bounce1(scene, cfg, cam)
    p = alive.shape[0]
    atten = tuple(torch.where(alive, a, c) for a, c in zip(atten, color))
    state = pack_state(o, d, atten, seed, alive, UNIFORM_BUDGET, pix)
    state, _ = wavefront._sorted(state, wavefront._state_key(state, scene))

    n_diff, n_tie, err, cnt, work = compare_bounce(scene, state, cfg,
                                                   "round")
    ms = time_ms(lambda: bounce12(scene, state, 1, True, cfg), 10)
    plain_ms = time_ms(lambda: bounce12_plain(scene, state, 1, True, cfg),
                       1, warm=False)
    print(f"check kernel B, sorted bounce-1 round of {p} rays: rays/live "
          f"{cnt}, differing lanes {n_diff} (walk tie lanes {n_tie}), max "
          f"abs err {err:.3g}; kernel {ms:.4f} ms plain {plain_ms:.2f} ms; "
          f"work {work}")
    # State in and out, the key, the tables once.
    b = bound(2 * nbytes(state) + 4 * p
              + nbytes(scene.nodes4, scene.clusters), work)

    # Tail round: the merged width, alive rays with budgets 0..3.
    bcfg = band_primaries(scene, cfg, cam)[0]
    out, key, _ = bounce12(scene, state, 1, True, cfg)
    out, _ = wavefront._sorted(out, key)
    merged = tail_merge_widths(cfg, bcfg.height, cfg.height // bcfg.height)
    w = merged[1] if merged[1] <= p else p
    tail = out[:, :w].contiguous()
    g = torch.Generator(device="cuda").manual_seed(5)
    tail[ROW_BUDGET] = torch.randint(0, 4, (w,), generator=g, device="cuda",
                                     dtype=torch.int32)
    n_diff2, n_tie2, err2, cnt2, _ = compare_bounce(scene, tail, cfg, "tail")
    n_zero = int(((tail[ROW_BUDGET] == 0) & (tail[ROW_ALIVE] != 0)).sum())
    print(f"check kernel B, tail round of {w} rays with budgets 0-3 "
          f"({n_zero} alive at budget 0): rays/live {cnt2}, differing lanes "
          f"{n_diff2} (walk tie lanes {n_tie2}), max abs err {err2:.3g}")
    results["bounce12"] = dict(max_abs_err=max(err, err2), ms=ms,
                               plain_ms=plain_ms, **b)


def check_stack_limit(width: int = 8):
    """Kernels A and B on a ``width``-wide tree at the deepest the stack
    takes (need 253 of 256 slots at width 8, 256 at width 16): bit-equal
    to the plain versions in every lane."""
    from raytracer_tpu_torch.bvh.bvh4 import nodes4_stack_need
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import (bounce12,
                                                    bounce12_plain,
                                                    pack_state)
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain
    from raytracer_tpu_torch.scene import presets

    n = 16384
    scene, rays = presets.stack_limit_scene(n, width=width)
    cfg = RenderConfig()
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    got = trace4(scene, rays, active, cfg)
    want, work = plain_work(lambda: trace4_plain(scene, rays, active, cfg))
    lanes = int((got.view(torch.int32) != want.view(torch.int32))
                .any(0).sum())
    g = torch.Generator(device="cuda").manual_seed(17)
    seed = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    state = pack_state(tuple(rays[0:3]), tuple(rays[3:6]),
                       (torch.ones(n, device="cuda"),) * 3, seed, active, 4,
                       torch.arange(n, device="cuda"))
    out_k = bounce12(scene, state, 1, True, cfg)
    out_p = bounce12_plain(scene, state, 1, True, cfg)
    lanes_b = int(((out_k[0] != out_p[0]).any(0)
                   | (out_k[1] != out_p[1])).sum())
    print(f"check stack limit ({scene.num_nodes4} {width}-wide nodes, need "
          f"{nodes4_stack_need(scene.nodes4.cpu().numpy(), width)}, plain "
          f"walk reached {work['stack4_max']}), "
          f"{n} rays: kernel A differing lanes {lanes}, kernel B differing "
          f"lanes {lanes_b}, counts {out_k[2].tolist()} vs "
          f"{out_p[2].tolist()}")
    assert lanes == 0 and torch.equal(got, want)
    assert lanes_b == 0 and torch.equal(out_k[2], out_p[2])


def compare_outputs(got, want, ties, label):
    """Kernel vs plain outputs (tuples of tensors, ray axis last): lanes
    differing in any output must be walk tie lanes -> (differing lanes,
    max abs err over the float outputs)."""
    diff = torch.zeros_like(ties)
    err = 0.0
    for g, w in zip(got, want):
        if g.dim() == 1:
            g, w = g[None], w[None]
        if g.dtype == torch.float32:
            err = max(err, (g - w).abs().nan_to_num(0.0).max().item())
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape[-1] == ties.shape[0]:
            diff |= (g != w).any(0)
        else:
            assert torch.equal(g, w), f"{label}: counts differ"
    assert not (diff & ~ties).any(), f"{label}: differs outside tie lanes"
    return int(diff.sum()), err


def check_color_kernels(scene, cfg, cam, results):
    """bounce15 at bcap 1 on the sorted bounce-1 band state (a fused
    round) and at bcap max_bounces - 1 on the same state sorted by the
    pmega host key (the pmega call); bounce_packed on the state as the
    fused_packed round sorts it."""
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import (UNIFORM_BUDGET, bounce15,
                                                    bounce15_plain,
                                                    bounce_packed,
                                                    bounce_packed_plain,
                                                    pack_state)

    o, d, color, atten, seed, alive, pix = band_bounce1(scene, cfg, cam)
    p = alive.shape[0]
    flat = pack_state(o, d, atten, seed, alive, UNIFORM_BUDGET, pix,
                      color=color)
    tables = nbytes(scene.nodes4, scene.clusters)

    def walk_ties(state):
        rays = state[0:6].view(torch.float32).contiguous()
        return compare_trace(scene, rays, state[-3] != 0, cfg)[2]

    fused, _ = wavefront._sorted(flat, wavefront._state_key(flat, scene))
    pmega = pmega_state(scene, cfg, cam)
    rows = {}
    for label, state, bcap in (("fused round", fused, 1),
                               ("pmega call", pmega, cfg.max_bounces - 1)):
        got = bounce15(scene, state, bcap, True, cfg)
        want, work = plain_work(
            lambda: bounce15_plain(scene, state, bcap, True, cfg))
        n_diff, err = compare_outputs(got, want, walk_ties(state), label)
        ms = time_ms(lambda: bounce15(scene, state, bcap, True, cfg), 10)
        plain_ms = time_ms(
            lambda: bounce15_plain(scene, state, bcap, True, cfg), 1,
            warm=False)
        print(f"check bounce15 bcap {bcap} ({label}, {p} rays): rays/live "
              f"{got[2].tolist()}, differing lanes {n_diff}, max abs err "
              f"{err:.3g}; kernel {ms:.4f} ms plain {plain_ms:.2f} ms; "
              f"work {work}")
        if bcap > 1:
            lanes = lane_occupancy(state, want[0])
            print(f"pmega call lanes: {lanes['mean_iterations']:.4f} "
                  f"iterations a ray (max {lanes['max_iterations']}); "
                  f"occupancy of one ray per thread "
                  f"{lanes['occupancy']:.4f} (iterations run / 32 x each "
                  f"warp's longest path)")
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           **bound(2 * nbytes(state) + 4 * p + tables,
                                   work))
    # The pmega call is the kernel's main use: its row goes in the table.
    results["bounce15"] = rows["pmega call"]
    results["bounce15_fused"] = rows["fused round"]

    sf, si = packed_state(scene, cfg, cam)
    got = bounce_packed(scene, sf, si, 1, True, cfg)
    want, work = plain_work(
        lambda: bounce_packed_plain(scene, sf, si, 1, True, cfg))
    rays = sf[0:6].contiguous()
    ties = compare_trace(scene, rays, sf[12] > 0.5, cfg)[2]
    n_diff, err = compare_outputs(got, want, ties, "packed round")
    ms = time_ms(lambda: bounce_packed(scene, sf, si, 1, True, cfg), 10)
    plain_ms = time_ms(
        lambda: bounce_packed_plain(scene, sf, si, 1, True, cfg), 1,
        warm=False)
    print(f"check bounce_packed bcap 1 (fused_packed round, {p} rays): "
          f"rays/live {got[3].tolist()}, differing lanes {n_diff}, max abs "
          f"err {err:.3g}; kernel {ms:.4f} ms plain {plain_ms:.2f} ms")
    eff = packed_round_profile(scene, sf, si, cfg, got)
    print(f"packed round walk: SIMD efficiency {eff['visit_efficiency']:.4f}"
          f" in the visit loop, {eff['leaf_efficiency']:.4f} in the leaf "
          f"loop; {eff['blocks']} blocks over {eff['resident_blocks']} "
          f"resident, span {eff['span_ms']:.4f} ms, last-wave share "
          f"{eff['last_wave_share']:.4f}, drain share "
          f"{eff['drain_share']:.4f}, block-slot occupancy "
          f"{eff['slot_occupancy']:.4f} (counting build)")
    results["bounce_packed"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(2 * nbytes(sf, si) + 4 * p + tables, work))


def packed_round_profile(scene, sf, si, cfg, want) -> dict:
    """The packed kernel's counting build on one round (results checked
    equal to ``want``, the kernel's): the SIMD efficiency of the walk's
    visit loop and of its leaf loop (active lanes per warp trip / 32);
    the launch's blocks, the resident blocks the card holds, the span
    from the first block's start to the last block's end, the share of
    the span after the last block started (the partial last wave of one
    ray per thread, where block slots go idle), the share after the first
    block ended (the drain) and the block-slot occupancy (block time
    summed over resident blocks x span)."""
    from raytracer_tpu_torch.kernels.bounce import bounce_packed_count
    from raytracer_tpu_torch.kernels.cuda_build import kernel_attrs

    *got, tallies, times = bounce_packed_count(scene, sf, si, 1, True, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w), "counting build differs from the kernel"
    vt, vl, lt, ll = (int(x) for x in tallies)
    t = times.double()
    span = float(t[:, 1].max() - t[:, 0].min())
    resident = (kernel_attrs("bounce_packed")["blocks_per_sm"]
                * torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(visit_efficiency=vl / (32 * max(vt, 1)),
                leaf_efficiency=ll / (32 * max(lt, 1)),
                visit_trips=vt, leaf_trips=lt, blocks=int(t.shape[0]),
                resident_blocks=resident, span_ms=span / 1e6,
                last_wave_share=float(t[:, 1].max() - t[:, 0].max()) / span,
                drain_share=float(t[:, 1].max() - t[:, 1].min()) / span,
                slot_occupancy=float((t[:, 1] - t[:, 0]).sum())
                / (resident * span))


@contextlib.contextmanager
def plain_versions():
    """Route the render modules to the plain versions."""
    from raytracer_tpu_torch.engine import renderer
    from raytracer_tpu_torch.kernels import (bounce, mega, packet, tonemap,
                                             trace, tracer, wavefront)

    slots = [(packet, "primary_rays", packet.primary_rays_plain),
             (packet, "shade", tracer.shade_plain),
             (wavefront, "shade", tracer.shade_plain),
             (tracer, "shade", tracer.shade_plain),
             (trace, "trace4", trace.trace4_plain),
             (trace, "trace2", trace.trace2_plain),
             (wavefront, "bounce12", bounce.bounce12_plain),
             (wavefront, "bounce15", bounce.bounce15_plain),
             (wavefront, "bounce_packed", bounce.bounce_packed_plain),
             (packet, "bounce15", bounce.bounce15_plain),
             (packet, "_traverse_fast", packet.ray_traverse_fast),
             (packet, "_traverse_groups", packet.packet_traverse),
             (mega, "mega", mega.mega_plain),
             (renderer, "tonemap_accumulate", tonemap.tonemap_plain)]
    saved = [getattr(m, n) for m, n, _ in slots]
    for m, n, f in slots:
        setattr(m, n, f)
    try:
        yield
    finally:
        for (m, n, _), f in zip(slots, saved):
            setattr(m, n, f)


def run_path(label, scene, cfg, cam, frames, env, kernels, warm=1):
    """``frames`` progressive frames through ``Renderer`` under the knobs
    ``env``, with the launch counts reset just before and read just after;
    fails unless each of ``kernels`` launched and no plain version ran.
    -> dict of FPS, frame times, Mrays/s, counts, last accum and image."""
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    with knob_env(env):
        r = Renderer(cfg)
        accum = None
        cam.frame_count = 0
        for _ in range(warm):
            accum, image, _ = r.render(scene, cam.uniforms(), accum)
        _sync()
        launches.reset()
        rays = 0
        frame_ms = []
        t0 = time.perf_counter()
        for fc in range(warm, warm + frames):
            t1 = time.perf_counter()
            cam.frame_count = fc
            accum, image, stats = r.render(scene, cam.uniforms(), accum)
            rays = rays + stats["rays_traced"]
            _sync()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
        dt = time.perf_counter() - t0
        counts, plain_counts = dict(launches.kernel), dict(launches.plain)
    img = image.cpu().numpy()
    assert bool(torch.isfinite(accum).all()), f"{label}: non-finite accum"
    assert img.min() != img.max(), f"{label}: image is one value"
    run = dict(fps=frames / dt, ms=dt / frames * 1e3,
               median_ms=float(np.median(frame_ms)), max_ms=max(frame_ms),
               mrays=float(rays) / dt / 1e6, counts=counts, frames=frames,
               image=img)
    print(f"{label} {cfg.width}x{cfg.height}, {cfg.max_bounces} bounces, "
          f"{frames} frames: {run['fps']:.3f} FPS, {run['ms']:.2f} ms/frame "
          f"(median {run['median_ms']:.2f}, max {run['max_ms']:.2f}), "
          f"{run['mrays']:.2f} Mrays/s; kernel launches {counts}, plain "
          f"calls {plain_counts}; image mean {img.mean():.3f}")
    for k in kernels:
        assert counts.get(k, 0) > 0, f"{k} never launched on {label}"
    assert not plain_counts, f"plain versions ran on {label}"
    return run


def small_frame(label, scene, cfg, cam, env, kernels, max_px: int):
    """One frame through the kernels and through the plain versions under
    the knobs ``env``: at most ``max_px`` differing u8 pixels."""
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    with knob_env(env):
        acc_k, img_k, st_k = Renderer(cfg).render(scene, cam)
        launches.reset()
        with plain_versions():
            acc_p, img_p, st_p = Renderer(cfg).render(scene, cam)
        _sync()
    assert not launches.kernel, launches.kernel
    for k in kernels:
        assert launches.plain[k] > 0, f"{label}: plain {k} never ran"
    n_px = int((img_k != img_p).any(-1).sum())
    lin_err = (acc_k - acc_p).abs().max().item()
    print(f"end to end {cfg.width}x{cfg.height} {label}: u8 differing "
          f"pixels {n_px}, linear max abs diff {lin_err:.3g}, rays "
          f"{int(st_k['rays_traced'])} vs {int(st_p['rays_traced'])}")
    assert n_px <= max_px, (label, n_px)
    return n_px


def run_preset(name: str, make, k: int = 8) -> dict:
    """One preset at its own config: its Scene built on the card, one
    warm frame, then ``render_chain`` of k frames with the launch counts
    reset just before and read just after; fails unless each kernel of
    its path launched and no plain version ran."""
    from raytracer_tpu_torch.engine.renderer import Renderer, _num_bands
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.scene.builder import build_fast_scene
    from raytracer_tpu_torch.utils.png import write_png

    p = make()
    cfg = p.config
    t0 = time.perf_counter()
    scene = build_fast_scene(p.scene.create_snapshot())
    _sync()
    build_s = time.perf_counter() - t0

    def uniforms(fc):
        p.camera.frame_count = fc
        return p.camera.uniforms(sky_enabled=p.sky_enabled,
                                 exposure=p.exposure)

    r = Renderer(cfg)
    accum, _, _ = r.render(scene, uniforms(0))
    uni = uniforms(1)
    _sync()
    launches.reset()
    t0 = time.perf_counter()
    accum, image, stats = r.render_chain(scene, uni, accum, k)
    _sync()
    dt = time.perf_counter() - t0
    counts, plain_counts = dict(launches.kernel), dict(launches.plain)
    img = image.cpu().numpy()
    kernels = ("trace4", "tonemap") + (
        ("bounce12",) if cfg.max_bounces > 1 else ())
    for kn in kernels:
        assert counts.get(kn, 0) > 0, f"{kn} never launched on {name}"
    assert not plain_counts, f"plain versions ran on {name}"
    assert bool(torch.isfinite(accum).all()), f"{name}: non-finite accum"
    assert img.min() != img.max(), f"{name}: image is one value"
    assert float(stats["samples"]) == k + 1
    write_png(os.path.join(REPO, "out", f"preset_{name}.png"), img)
    rays = float(stats["rays_traced"]) * k
    run = dict(triangles=scene.num_triangles, build_s=build_s,
               width=cfg.width, height=cfg.height, bounces=cfg.max_bounces,
               bands=_num_bands(cfg), frames=k, fps=k / dt, ms=dt / k * 1e3,
               mrays=rays / dt / 1e6,
               launches_per_frame={n: c / k for n, c in counts.items()},
               image_mean=float(img.mean()))
    print(f"preset {name} {cfg.width}x{cfg.height}, {cfg.max_bounces} "
          f"bounces, {run['bands']} bands: {run['triangles']} triangles, "
          f"built in {build_s:.3f} s; render_chain of {k}: "
          f"{run['fps']:.3f} FPS, {run['ms']:.2f} ms/frame, "
          f"{run['mrays']:.2f} Mrays/s; launches per frame "
          f"{run['launches_per_frame']}; image mean {run['image_mean']:.3f}")
    return run


def check_chain(scene, cfg, cam, k: int = 8) -> dict:
    """render_chain(k) against k render calls: 0 differing accumulator
    and image bytes."""
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    r = Renderer(cfg)
    accum = None
    for fc in range(k):
        cam.frame_count = fc
        accum, image, _ = r.render(scene, cam.uniforms(), accum)
    cam.frame_count = 0
    launches.reset()
    c_accum, c_image, stats = r.render_chain(scene, cam.uniforms(), None, k)
    _sync()
    counts = dict(launches.kernel)
    n_acc = int((c_accum.view(torch.int32) != accum.view(torch.int32))
                .sum())
    n_img = int((c_image != image).sum())
    print(f"chain against frames {cfg.width}x{cfg.height}, k {k}: "
          f"differing accumulator words {n_acc}, image bytes {n_img}; "
          f"chain launches {counts}; samples {stats['samples']}")
    assert n_acc == 0 and n_img == 0
    for kn in ("trace4", "bounce12", "tonemap"):
        assert counts.get(kn, 0) > 0, f"{kn} never launched in the chain"
    assert counts["tonemap"] == k and not launches.plain
    return dict(k=k, differing_accum_words=n_acc, differing_image_bytes=n_img,
                launches=counts)


def check_headless(frames: int = 16) -> dict:
    """A preset's Scene as JSON through the headless app: two runs of
    ``frames`` with one checkpoint (the second resumes) against one
    straight run of 2 * frames, 0 differing accumulator bytes."""
    from raytracer_tpu_torch.apps import headless
    from raytracer_tpu_torch.scene import presets

    d = os.path.join(REPO, "out", "headless")
    os.makedirs(d, exist_ok=True)
    scene_json = os.path.join(d, "sphere_light.json")
    presets.config2_sphere_light().scene.save_json(scene_json)
    ck, straight = os.path.join(d, "ck.npz"), os.path.join(d, "straight.npz")
    for f in (ck, straight):
        if os.path.exists(f):
            os.remove(f)
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.apps.headless",
           "--scene", scene_json, "--frames", str(frames), "--chain", "0",
           "--checkpoint", ck, "--stats-json", "-o",
           os.path.join(d, "resumed.png")]
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            raise RuntimeError(f"headless failed:\n{proc.stderr[-4000:]}")
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        stats["command_s"] = time.perf_counter() - t0
        runs.append(stats)
        print(f"headless --scene sphere_light.json --frames {frames} "
              f"--chain 0 --checkpoint: {stats}")
    headless.main(["--scene", scene_json, "--frames", str(2 * frames),
                   "--chain", "0", "--checkpoint", straight, "-o",
                   os.path.join(d, "straight.png")])
    with np.load(ck) as a, np.load(straight) as b:
        n_diff = int((a["accum"].view(np.int32)
                      != b["accum"].view(np.int32)).sum())
        fcs = (int(a["frame_count"]), int(b["frame_count"]))
    print(f"headless resume against a straight run of {2 * frames} frames: "
          f"frame counts {fcs}, differing accumulator words {n_diff}")
    assert n_diff == 0 and fcs == (2 * frames, 2 * frames)
    assert runs[1]["samples"] == 2 * frames
    return dict(runs=runs, differing_accum_words=n_diff)


def check_per_ray() -> dict:
    """The per-ray path on a GpuScene: cube_plane at 160x120, 2 frames,
    card against CPU (at most TIE_FRACTION_MAX of the u8 pixels differ);
    then its frame times on the card at 1280x720 (cube_plane) and at
    640x480 (sphere_light, 10 bounces)."""
    import dataclasses

    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene.builder import build_gpu_scene

    def frames(p, scene, device, n):
        cfg = dataclasses.replace(p.config, kernel="wavefront",
                                  rng_mode="reference")
        r = Renderer(cfg)
        accum, ms = None, []
        for fc in range(n):
            p.camera.frame_count = fc
            uni = p.camera.uniforms(p.sky_enabled, p.exposure, device=device)
            t0 = time.perf_counter()
            accum, image, stats = r.render(scene, uni, accum)
            if device == "cuda":
                _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return image.cpu().numpy(), ms, int(stats["rays_traced"])

    p = presets.config1_cube_plane(160, 120)
    snap = p.scene.create_snapshot()
    launches.reset()
    img_k, ms_k, rays_k = frames(p, build_gpu_scene(snap), "cuda", 2)
    counts = dict(launches.kernel)
    img_c, ms_c, rays_c = frames(p, build_gpu_scene(snap, device="cpu"),
                                 "cpu", 2)
    n_px = int((img_k != img_c).any(-1).sum())
    print(f"per-ray path cube_plane 160x120, 2 frames: u8 differing pixels "
          f"card vs CPU {n_px}, rays {rays_k} vs {rays_c}; card "
          f"{ms_k[-1]:.2f} ms/frame, CPU {ms_c[-1]:.2f}; card launches "
          f"{counts}")
    assert n_px <= TIE_FRACTION_MAX * 160 * 120
    assert counts.get("tonemap") == 2 and img_k.min() != img_k.max()
    out = dict(differing_pixels=n_px, ms_160x120=ms_k, cpu_ms=ms_c)
    for label, p, n in (("cube_plane_1280x720",
                         presets.config1_cube_plane(1280, 720), 3),
                        ("sphere_light_640x480",
                         presets.config2_sphere_light(), 2)):
        img, ms, rays = frames(p, build_gpu_scene(
            p.scene.create_snapshot()), "cuda", n)
        out[label] = dict(ms=ms, rays=rays)
        print(f"per-ray path {label}, {p.config.max_bounces} bounces: "
              f"{', '.join(f'{m:.2f}' for m in ms)} ms/frame (first "
              f"warm), {rays} rays/frame, image mean {img.mean():.3f}")
    return out


# Device build modes: each one's path knobs. ``lbvh_ploc`` is the LBVH
# route with the device PLOC tree; its builder reports mode "lbvh".
MODES = {"instanced": {"RAYTPU_DEVICE_BUILD": "instanced"},
         "refit": {"RAYTPU_DEVICE_BUILD": "refit"},
         "lbvh": {"RAYTPU_DEVICE_BUILD": "lbvh"},
         "lbvh_ploc": {"RAYTPU_DEVICE_BUILD": "lbvh",
                       "RAYTPU_DEVICE_TREE": "ploc"}}


def two_humans_figures():
    """The two FinalBaseMesh figures of ``presets.config4_two_humans``
    (the procedural terrain stands in for the mesh where it is absent):
    98,596 triangles without the ground plane, as ``bench.py``'s
    ``two_humans`` mode."""
    from raytracer_tpu_torch.scene import presets

    return presets.config4_two_humans().scene.get_instances()[1:]


def drag(figures, step: int):
    """``bench.py:156-175``'s edit: the last instance 0.05 * step right
    of where it started."""
    import dataclasses

    moved = list(figures)
    x, y, z = moved[-1].position
    moved[-1] = dataclasses.replace(moved[-1],
                                    position=(x + 0.05 * step, y, z))
    return moved


def table_diff(a, b) -> dict:
    """Two FastScenes' tables: differing link and meta words (nodes8
    skip / col7, nodes4 metas), the largest float difference in ulp in
    the cluster records' unit normals (``normal_ulp``) and elsewhere
    (``max_ulp``); counts compared."""
    assert (a.num_nodes, a.num_nodes4, a.num_triangles) == (
        b.num_nodes, b.num_nodes4, b.num_triangles)
    bits = {n: (getattr(a, n).cpu().numpy().view(np.int32).astype(np.int64),
                getattr(b, n).cpu().numpy().view(np.int32).astype(np.int64))
            for n in ("nodes8", "nodes4", "clusters")}
    (a8, b8), (a4, b4), (ac, bc) = bits.values()
    a4, b4 = a4.reshape(-1, 8, 16), b4.reshape(-1, 8, 16)
    links = int((a8[:, 6:8] != b8[:, 6:8]).sum()
                + (a4[:, :, 6] != b4[:, :, 6]).sum())
    ac, bc = ac.reshape(-1, 16), bc.reshape(-1, 16)
    floats = [np.abs(a8[:, :6] - b8[:, :6]), np.abs(a4[:, :, :6]
                                                     - b4[:, :, :6]),
              np.abs(a4[:, :, 7:] - b4[:, :, 7:]),
              np.abs(ac[:, :13] - bc[:, :13])]
    return dict(links=links, max_ulp=int(max(f.max(initial=0)
                                             for f in floats)),
                normal_ulp=int(np.abs(ac[:, 13:] - bc[:, 13:]).max(
                    initial=0)))


def count_host_reads(fn, n: int) -> float:
    """Synchronising CUDA calls per call of fn() over n calls, counted by
    PyTorch's sync debug mode (device -> host reads, blocking host ->
    device copies, stream waits)."""
    import warnings

    _sync()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(n):
                fn(i)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync()
    return sum("synchroniz" in str(w.message) for w in caught) / n


def device_launches(fn) -> int:
    """Device activities (kernels, copies, memsets) of one fn() call, from
    the profiler (which may drop a few)."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def check_device_builds(cfg, uni, dev="cuda", drags: int = 16) -> dict:
    """Phase 13: each device build mode (``MODES``) on the two figures:
    the builder's mode, the card build against the port's CPU build of
    the same instances (0 differing link / meta words, floats within 2
    ulp), kernels A, B, ``trace2`` and ``trace2_warp`` on the card-built
    tables against their plain versions (0 differing lanes), the per-edit
    rebuild ms (median of ``drags`` synchronised drags), the device
    launches of one rebuild and the host reads a rebuild makes."""
    from raytracer_tpu_torch.kernels.bounce import (UNIFORM_BUDGET,
                                                    pack_state)
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.scene.device_builder import DeviceSceneBuilder

    figures = two_humans_figures()
    out = {}
    for mode, env in MODES.items():
        built_by = env["RAYTPU_DEVICE_BUILD"]
        with knob_env(env):
            builder = DeviceSceneBuilder(dev)
            t0 = time.perf_counter()
            scene = builder.build(figures)
            _sync()
            first_s = time.perf_counter() - t0
            assert builder.last_mode == built_by, (mode, builder.last_mode)
            cpu_builder = DeviceSceneBuilder("cpu")
            diff = table_diff(scene, cpu_builder.build(figures))
            assert cpu_builder.last_mode == built_by
            assert diff["links"] == 0 and diff["max_ulp"] <= 2 \
                and diff["normal_ulp"] <= 2, diff

            _, _, ray_o, ray_d, alive, _ = band_primaries(scene, cfg, uni)
            rays = torch.stack([*ray_o, *ray_d]).contiguous()
            lanes = {}
            for name in ("trace4", "trace2", "trace2_warp"):
                lanes[name] = int(compare_trace(scene, rays, alive, cfg,
                                                name)[2].sum())
            o, d, color, atten, seed, live, pix = band_bounce1(scene, cfg,
                                                               uni)
            atten = tuple(torch.where(live, a, c)
                          for a, c in zip(atten, color))
            state = pack_state(o, d, atten, seed, live, UNIFORM_BUDGET, pix)
            state, _ = wavefront._sorted(state,
                                         wavefront._state_key(state, scene))
            lanes["bounce12"] = compare_bounce(scene, state, cfg,
                                               f"{mode} tables")[0]
            assert not any(lanes.values()), (mode, lanes)

            ms = []
            for i in range(1, drags + 1):
                _sync()
                t0 = time.perf_counter()
                builder.build(drag(figures, i))
                _sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            reads = (count_host_reads(
                lambda i: builder.build(drag(figures, drags + 1 + i)), drags)
                if dev == "cuda" else None)
            n_launch = (device_launches(
                lambda: builder.build(drag(figures, 2 * drags + 1)))
                if dev == "cuda" else None)
            assert builder.last_mode == built_by
            out[mode] = dict(mode=builder.last_mode, first_build_s=first_s,
                             triangles=scene.num_triangles,
                             nodes=scene.num_nodes,
                             wide_nodes=scene.num_nodes4, **diff,
                             differing_lanes=lanes,
                             rebuild_ms=float(np.median(ms)),
                             rebuild_ms_all=ms, host_reads=reads,
                             launches_per_rebuild=n_launch)
        print(f"device build {mode}: mode {builder.last_mode}, "
              f"{scene.num_triangles} triangles, {scene.num_nodes} nodes, "
              f"{scene.num_nodes4} wide; first build {first_s:.3f} s; card "
              f"vs CPU: differing link/meta words {diff['links']}, max "
              f"float ulp {diff['max_ulp']} (normals "
              f"{diff['normal_ulp']}); kernels vs plain on its "
              f"tables, differing lanes {lanes}; rebuild "
              f"{out[mode]['rebuild_ms']:.3f} ms (median of {drags}, "
              f"min {min(ms):.3f}, max {max(ms):.3f}); device launches "
              f"per rebuild {n_launch}; host reads per rebuild {reads}")
        if dev == "cuda":
            assert reads == (1 if built_by == "lbvh" else 0), (mode, reads)
    return out


def run_drag(cfg, dev="cuda", frames: int = 16, modes=None) -> dict:
    """Phase 14: ``bench.py:156-175``'s frame per mode: the last figure
    moves 0.05 in x, the scene is rebuilt on the card and rendered
    (frame count 0: a live edit restarts accumulation), one warm frame
    then ``frames``, synchronised; launch counts reset just before.
    ``modes``: label -> (knobs, the builder's ``last_mode``, the kernels
    a frame launches); default each of ``MODES``, kernels A and B."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.scene.device_builder import DeviceSceneBuilder

    figures = two_humans_figures()
    cam = default_camera(cfg.width, cfg.height)
    if modes is None:
        modes = {m: (env, env["RAYTPU_DEVICE_BUILD"],
                     ("trace4", "bounce12", "tonemap"))
                 for m, env in MODES.items()}
    out = {}
    for mode, (env, last_mode, kernels) in modes.items():
        with knob_env(env):
            builder = DeviceSceneBuilder(dev)
            builder.build(figures)
            r = Renderer(cfg)
            accum, _, _ = r.render(builder.build(drag(figures, 1)),
                                   cam.uniforms(device=dev))
            _sync()
            launches.reset()
            build_ms, frame_ms = [], []
            t_start = time.perf_counter()
            for i in range(2, frames + 2):
                t0 = time.perf_counter()
                scene = builder.build(drag(figures, i))
                _sync()
                t1 = time.perf_counter()
                accum, image, stats = r.render(scene,
                                               cam.uniforms(device=dev),
                                               accum)
                _sync()
                t2 = time.perf_counter()
                build_ms.append((t1 - t0) * 1e3)
                frame_ms.append((t2 - t0) * 1e3)
            dt = time.perf_counter() - t_start
            counts, plain = dict(launches.kernel), dict(launches.plain)
        assert builder.last_mode == last_mode, (mode, builder.last_mode)
        for k in kernels:
            assert counts.get(k, 0) > 0, f"{k} never launched on drag {mode}"
        assert not plain, f"plain versions ran on drag {mode}"
        img = image.cpu().numpy()
        assert bool(torch.isfinite(accum).all()) and img.min() != img.max()
        out[mode] = dict(fps=frames / dt, ms=dt / frames * 1e3,
                         median_ms=float(np.median(frame_ms)),
                         rebuild_ms=float(np.median(build_ms)),
                         rebuild_share=sum(build_ms) / sum(frame_ms),
                         launches_per_frame={k: v / frames
                                             for k, v in counts.items()},
                         image_mean=float(img.mean()),
                         last_mode=builder.last_mode,
                         wide_table=scene.nodes4 is not None)
        print(f"drag {mode} {cfg.width}x{cfg.height}, {cfg.max_bounces} "
              f"bounces, {frames} frames: {out[mode]['fps']:.3f} FPS, "
              f"{out[mode]['ms']:.2f} ms/frame (median "
              f"{out[mode]['median_ms']:.2f}), rebuild median "
              f"{out[mode]['rebuild_ms']:.3f} ms, rebuild share "
              f"{out[mode]['rebuild_share']:.4f}; launches per frame "
              f"{out[mode]['launches_per_frame']}")
    return out


def _wait_for(pred, timeout: float, what: str, poll: float = 0.005):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(poll)
    raise AssertionError(f"timed out waiting for {what}")


TICK_S = 0.016  # the viewer's UI tick (VulkanApp.java:171)


def _stop_engine(engine) -> float:
    t0 = time.perf_counter()
    engine.stop()
    dt = time.perf_counter() - t0
    assert dt < 5.0 and not engine._thread.is_alive() \
        and not engine._publisher.is_alive(), dt
    return dt


def check_engine(cfg, dev="cuda", frames: int = 16) -> dict:
    """Phase 15: ``RenderEngine`` at ``cfg`` on the two figures: an async
    rebuild, ``frames`` published frames under the UI tick rule (uniforms
    every TICK_S, the counter growing once a published frame; the meter's
    FPS), a drag rebuilt mid-run, a rebuild that raises (the old scene
    keeps rendering), ``stop()`` within 5 s; then a ladder session
    (previews, then a full-resolution frame)."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.engine.loop import RenderEngine
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.scene.scene import Scene

    figures = two_humans_figures()
    launches.reset()
    engine = RenderEngine(cfg, device=dev)
    engine.start()
    cam = default_camera(cfg.width, cfg.height)
    published = []

    def tick():
        f = engine.latest_frame()
        if f is not None:
            published.append(f)
            cam.increment_frame_count()
        engine.submit_camera_update(cam.uniforms(device=dev))

    try:
        t0 = time.perf_counter()
        engine.rebuild_scene_async(Scene(figures)).result(timeout=120)
        build_s = time.perf_counter() - t0
        assert engine._device_builder.last_mode == "instanced"
        _wait_for(lambda: tick() or len(published) >= 2, 120, "frames",
                  TICK_S)
        n0, t0 = len(published), time.perf_counter()
        _wait_for(lambda: tick() or len(published) >= n0 + frames, 120,
                  f"{frames} frames", TICK_S)
        wall_fps = (len(published) - n0) / (time.perf_counter() - t0)
        meter_fps = engine.meter.fps
        # A drag rebuilt while frames render, then one that raises.
        swapped = []
        engine.on_scene_swapped = lambda: swapped.append(len(published))
        engine.rebuild_scene_async(Scene(drag(figures, 1))).result(
            timeout=60)
        _wait_for(lambda: tick() or swapped, 60, "the drag's swap", TICK_S)
        n1 = len(published)
        with knob_env({"RAYTPU_DEVICE_BUILD": "bogus"}):
            fut = engine.rebuild_scene_async(Scene(figures))
            try:
                fut.result(timeout=60)
                raise AssertionError("the bad rebuild did not raise")
            except NotImplementedError:
                pass
        _wait_for(lambda: tick() or len(published) >= n1 + 3, 60,
                  "frames after the bad rebuild", TICK_S)
        assert len(swapped) == 1, swapped
    finally:
        stop_s = _stop_engine(engine)
    counts, plain = dict(launches.kernel), dict(launches.plain)
    for k in ("trace4", "bounce12", "tonemap"):
        assert counts.get(k, 0) > 0, f"{k} never launched in the engine"
    assert not plain, "plain versions ran in the engine"
    last = published[-1]
    assert last.pixels.shape == (cfg.height, cfg.width, 3)
    assert last.pixels.min() != last.pixels.max()

    # Ladder session: previews after the reset, then full resolution.
    ladder = RenderEngine(cfg, ladder_frames=8, device=dev)
    ladder.start()
    cam = default_camera(cfg.width, cfg.height)
    kinds = []

    def ladder_tick():
        f = ladder.latest_frame()
        if f is not None:
            kinds.append(f.preview)
            assert f.pixels.shape == (cfg.height, cfg.width, 3)
            cam.increment_frame_count()
        ladder.submit_camera_update(cam.uniforms(device=dev))

    try:
        ladder.rebuild_scene_async(Scene(figures)).result(timeout=120)
        _wait_for(lambda: ladder_tick() or (True in kinds
                                            and kinds[-1] is False), 120,
                  "ladder previews then a full frame", TICK_S)
    finally:
        ladder_stop_s = _stop_engine(ladder)
    first_full = kinds.index(False, kinds.index(True))
    out = dict(build_s=build_s, frames=len(published), meter_fps=meter_fps,
               wall_fps=wall_fps, stop_s=stop_s, ladder_kinds=kinds,
               ladder_stop_s=ladder_stop_s, launches=counts,
               stages=engine.profiler.summary())
    print(f"engine {cfg.width}x{cfg.height}: first rebuild {build_s:.3f} s; "
          f"{frames} frames at {wall_fps:.3f} FPS (meter {meter_fps:.3f}); "
          f"drag swapped in after frame {swapped[0]}, bad rebuild raised "
          f"and {len(published) - n1} frames followed; stop {stop_s:.3f} "
          f"s; ladder: {kinds.count(True)} previews, first full frame at "
          f"{first_full}, stop {ladder_stop_s:.3f} s; stages "
          f"{out['stages']}")
    return out


def check_viewer(cfg, dev="cuda", keys: int = 5) -> dict:
    """Phase 16: the viewer on 127.0.0.1 (a free port) over the two
    figures: GET /api/state, POST keys (their keypress -> frame latency),
    add / update / remove an instance (each a device rebuild), stop."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from raytracer_tpu_torch.apps.viewer import ViewerApp, make_handler
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.scene.scene import Scene
    from raytracer_tpu_torch.utils import assets

    cube = os.path.join(REPO, "out", "viewer_cube.obj")
    assets.write_obj(cube, assets.make_cube() * 4.0)
    launches.reset()
    app = ViewerApp(cfg, Scene(two_humans_figures()), device=dev)
    app.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return json.loads(r.read())

    def post(path, data):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(data).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            return json.loads(r.read())

    builds = lambda: app.engine.profiler.summary().get(
        "build", {}).get("count", 0)
    try:
        _wait_for(lambda: get("/api/state")["stats"] is not None, 120,
                  "the viewer's first frame")
        latencies = []
        for k in "WSADQ"[:keys]:
            before = app.engine.last_event_frame
            post("/api/key", {"key": k})
            _wait_for(lambda: app.engine.last_event_frame is not before,
                      60, f"key {k}'s frame")
            latencies.append(app.engine.last_input_latency_ms)
            time.sleep(0.2)
        state_latency = get("/api/state")["stats"]["input_latency_ms"]
        edits = {}
        for label, path, data in (
                ("add", "/api/instance/add",
                 {"model_path": cube, "display_name": "cube",
                  "position": [0, 5, 0], "scale": [2, 2, 2]}),
                ("update", "/api/instance/2/update",
                 {"position": [4, 5, 0], "material_type": 1.0}),
                ("remove", "/api/instance/2/remove", {})):
            n = builds()
            t0 = time.perf_counter()
            post(path, data)
            _wait_for(lambda: builds() > n
                      and not app.engine.build_in_progress, 60,
                      f"the {label} rebuild")
            edits[label] = dict(
                ms=(time.perf_counter() - t0) * 1e3,
                mode=app.engine._device_builder.last_mode,
                instances=len(get("/api/state")["instances"]))
            assert edits[label]["mode"] == "instanced", edits
        assert [e["instances"] for e in edits.values()] == [3, 3, 2]
        state = get("/api/state")
    finally:
        server.shutdown()
        server.server_close()
        t0 = time.perf_counter()
        app.stop()
        stop_s = time.perf_counter() - t0
    assert not app.engine._thread.is_alive() and stop_s < 10.0
    counts, plain = dict(launches.kernel), dict(launches.plain)
    for k in ("trace4", "bounce12", "tonemap"):
        assert counts.get(k, 0) > 0, f"{k} never launched in the viewer"
    assert not plain, "plain versions ran in the viewer"
    out = dict(key_latency_ms=latencies, state_latency_ms=state_latency,
               edits=edits, fps=state["stats"]["fps"], stop_s=stop_s)
    print(f"viewer {cfg.width}x{cfg.height} at {base}: keypress -> frame "
          f"{', '.join(f'{x:.1f}' for x in latencies)} ms (median "
          f"{np.median(latencies):.1f}); edits {edits}; meter FPS "
          f"{state['stats']['fps']}; stop {stop_s:.3f} s")
    return out


MESH_SHAPES = ((2, 1), (1, 2), (2, 2))


def mesh_rank(shapes, frames: int, devices, mesh) -> dict:
    """Phase 17, one rank (``parallel.sharding.launch``): the flagship on
    this rank's device; per (dp, sp) of ``shapes`` (the sub-mesh of the
    first dp * sp ranks) frame 0 at spp = sp, then ``frames`` timed frames
    with the launch counts reset just before and read just after; then
    three accumulated frames on (2, 1) with the whole accumulator. ->
    numpy results (frames and accumulators on a mesh's rank 0 only)."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.parallel.sharding import MeshRenderer, make_mesh
    from raytracer_tpu_torch.scene.presets import flagship_scene

    scene = flagship_scene(mesh.device)
    out = {}
    for dp, sp in shapes:
        m = make_mesh(dp * sp, sp, devices)
        if m is None:
            continue
        cfg = RenderConfig(samples_per_pixel=sp)
        cam = default_camera(cfg.width, cfg.height)
        r = MeshRenderer(cfg, m)
        accum, image, stats = r.render(scene, cam.uniforms(device=m.device))
        run = dict(rays=int(stats["rays_traced"]))
        if m.rank == 0:
            run["image"] = image.cpu().numpy()
        torch.cuda.synchronize(m.device)
        launches.reset()
        ms = []
        for fc in range(1, frames + 1):
            t0 = time.perf_counter()
            cam.frame_count = fc
            accum, image, _ = r.render(scene, cam.uniforms(device=m.device),
                                       accum)
            torch.cuda.synchronize(m.device)
            ms.append((time.perf_counter() - t0) * 1e3)
        run.update(frame_ms=ms, counts=dict(launches.kernel),
                   plain=dict(launches.plain))
        out[(dp, sp)] = run

    m = make_mesh(2, 1, devices)
    if m is not None:
        cfg = RenderConfig()
        cam = default_camera(cfg.width, cfg.height)
        r = MeshRenderer(cfg, m)
        accum = None
        for fc in range(3):
            cam.frame_count = fc
            accum, image, stats = r.render(
                scene, cam.uniforms(device=m.device), accum)
        full = r.full_accumulator(accum).cpu().numpy()
        if m.rank == 0:
            out["accumulated"] = dict(image=image.cpu().numpy(), accum=full,
                                      rays=int(stats["rays_traced"]),
                                      samples=stats["samples"])
    return out


def mesh_results(run, shapes, want, frames: int, where: str) -> dict:
    """Phase 17's checks of one launch: each mesh's frame 0 byte-equal to
    the single-device frame at its spp with equal rays, each rank's
    kernels launched and no plain version run; the (2, 1) accumulation
    equal to three single-device frames. -> per mesh: ms/frame and
    launches per frame over all ranks."""
    res, out = run.results[0], {}
    for dp, sp in shapes:
        got = res[(dp, sp)]
        ranks = [r[(dp, sp)] for r in run.results[:dp * sp]]
        image, rays = want[sp]
        n_px = int((got["image"] != image).any(-1).sum())
        for r in ranks:
            for k in ("trace4", "bounce12", "tonemap"):
                assert r["counts"].get(k, 0) > 0, (dp, sp, k, r["counts"])
            assert not r["plain"], (dp, sp, r["plain"])
        row = dict(differing_pixels=n_px, rays=got["rays"], single_rays=rays,
                   frame_ms=got["frame_ms"],
                   median_ms=float(np.median(got["frame_ms"])),
                   launches_per_frame={k: sum(r["counts"].get(k, 0)
                                              for r in ranks) / frames
                                       for k in ("trace4", "bounce12",
                                                 "tonemap")})
        out[f"{dp}x{sp}"] = row
        ms = ", ".join(f"{x:.1f}" for x in got["frame_ms"])
        print(f"mesh dp {dp} x sp {sp} on {where} ({run.backend}), "
              f"1280x720, 10 bounces, spp {sp}: frame 0 differing pixels "
              f"against one device {n_px}, rays {got['rays']} vs {rays}; "
              f"{frames} frames {ms} ms (median {row['median_ms']:.1f}); "
              f"launches per frame, all ranks: {row['launches_per_frame']}")
        assert n_px == 0 and got["rays"] == rays, (dp, sp)
    acc = res["accumulated"]
    image, accum, rays = want["accumulated"]
    n_acc = int((acc["accum"].view(np.int32) != accum.view(np.int32)).sum())
    print(f"mesh dp 2 x sp 1 on {where}, 3 accumulated frames: differing "
          f"accumulator words {n_acc}, image bytes equal "
          f"{acc['image'].tobytes() == image.tobytes()}, rays "
          f"{acc['rays']} vs {rays}, samples {acc['samples']}")
    assert n_acc == 0 and acc["image"].tobytes() == image.tobytes()
    assert acc["rays"] == rays and acc["samples"] == 3
    out["accumulated"] = dict(differing_accum_words=n_acc)
    return out


def check_mesh(frames: int = 8) -> dict:
    """Phase 17: the flagship at ``RenderConfig()`` (1280x720, 10 bounces)
    with spp = sp, through ``parallel.sharding.launch`` + ``MeshRenderer``
    (``mesh_rank``, checked by ``mesh_results``): meshes (2, 1), (1, 2),
    (2, 2) as four ranks on cuda:0 over gloo (NCCL refuses two ranks on
    one card). Where there are two cards or more,
    every mesh that fits them, one rank a card over NCCL; ``--devices 2``
    of the headless app (on two cards, else ``--device cpu`` at 64x32)
    against its single-device PNG. One-device frame times at spp 1 and 2
    beside the meshes'."""
    import functools

    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.parallel.sharding import launch
    from raytracer_tpu_torch.scene import presets

    scene = presets.flagship_scene()
    want, one_ms = {}, {}
    for spp in (1, 2):
        cfg = RenderConfig(samples_per_pixel=spp)
        cam = default_camera(cfg.width, cfg.height)
        r = Renderer(cfg)
        accum, image, stats = r.render(scene, cam.uniforms())
        want[spp] = (image.cpu().numpy(), int(stats["rays_traced"]))
        one_ms[spp] = []
        for fc in range(1, frames + 1):
            _sync()
            t0 = time.perf_counter()
            cam.frame_count = fc
            accum, _, _ = r.render(scene, cam.uniforms(), accum)
            _sync()
            one_ms[spp].append((time.perf_counter() - t0) * 1e3)
        print(f"one device, 1280x720, 10 bounces, spp {spp}: {frames} "
              f"frames {', '.join(f'{x:.1f}' for x in one_ms[spp])} ms "
              f"(median {np.median(one_ms[spp]):.1f})")
    cfg = RenderConfig()
    cam = default_camera(cfg.width, cfg.height)
    accum = None
    for fc in range(3):
        cam.frame_count = fc
        accum, image, stats = Renderer(cfg).render(scene, cam.uniforms(),
                                                   accum)
    want["accumulated"] = (image.cpu().numpy(), accum.cpu().numpy(),
                           int(stats["rays_traced"]))
    del scene
    torch.cuda.empty_cache()

    out = {"one_device_ms": one_ms}
    devices = ["cuda:0"] * 4
    t0 = time.perf_counter()
    run = launch(functools.partial(mesh_rank, MESH_SHAPES, frames, devices),
                 4, devices=devices, timeout=900)
    out["launch_s"] = time.perf_counter() - t0
    assert run.backend == "gloo", run.backend
    out["gloo"] = mesh_results(run, MESH_SHAPES, want, frames, "cuda:0")

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        n = 4 if n_cards >= 4 else 2
        # (4, 1) cannot split 720 rows into 8-row tiles: 720 % 32 != 0.
        shapes = tuple((dp, sp) for dp, sp in MESH_SHAPES if dp * sp <= n)
        devices = [f"cuda:{i}" for i in range(n)]
        run = launch(functools.partial(mesh_rank, shapes, frames, devices),
                     n, devices=devices, timeout=900)
        assert run.backend == "nccl", run.backend
        out["nccl"] = mesh_results(run, shapes, want, frames,
                                   f"{n} cards")
    else:
        print(f"mesh over NCCL not run: {n_cards} CUDA device (NCCL needs "
              f"a card per rank)")
        out["nccl"] = f"not run: {n_cards} CUDA device"

    d = os.path.join(REPO, "out", "headless")
    os.makedirs(d, exist_ok=True)
    scene_json = os.path.join(d, "mesh_sphere_light.json")
    presets.config2_sphere_light().scene.save_json(scene_json)
    size = ([] if n_cards >= 2 else
            ["--device", "cpu", "--width", "64", "--height", "32",
             "--max-bounces", "3"])
    pngs = []
    for tag, extra in (("one", []), ("mesh", ["--devices", "2"])):
        png = os.path.join(d, f"mesh_{tag}.png")
        cmd = [sys.executable, "-m", "raytracer_tpu_torch.apps.headless",
               "--scene", scene_json, "--frames", "2", "--stats-json", "-o",
               png, *size, *extra]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            raise RuntimeError(f"headless failed:\n{proc.stderr[-4000:]}")
        print(f"headless {' '.join(size + extra)}: "
              f"{proc.stdout.strip().splitlines()[-1]}")
        with open(png, "rb") as f:
            pngs.append(f.read())
    assert pngs[0] == pngs[1], "headless --devices 2 PNG differs"
    out["headless"] = dict(args=size + ["--devices", "2"], png_equal=True)
    return out


# Phase 18: the XLA render path's knobs -> (their knobs, the kernels a
# frame launches, the plain versions a frame books).
XLA_PATHS = {
    "bounce_mega": ({"RAYTPU_BOUNCE": "mega"}, ("trace4", "mega", "tonemap"),
                    ("trace4", "mega")),
    "b0_mega": ({"RAYTPU_B0": "mega"}, ("mega", "tonemap"), ("mega",)),
    "b0_packet": ({"RAYTPU_B0": "packet"},
                  ("trace2_warp", "mega", "tonemap"), ("trace2_warp",
                                                       "mega")),
    "b0_pwave": ({"RAYTPU_B0": "pwave"}, ("bounce12", "tonemap"),
                 ("bounce12",)),
}


def band_raster(scene, cfg, cam, band=None):
    """Band ``band``'s primaries (default the middle one) as
    ``RAYTPU_B0=mega`` makes them (raster order, no pad): (ray_o, ray_d,
    color, atten, seed, alive, pix)."""
    import dataclasses

    from raytracer_tpu_torch.engine.renderer import _num_bands
    from raytracer_tpu_torch.kernels.tracer import (initial_seed,
                                                    make_primary_rays)

    nb = _num_bands(cfg)
    band_h = cfg.height // nb
    bcfg = dataclasses.replace(cfg, height=band_h)
    p = band_h * cfg.width
    i = torch.arange(p, device="cuda")
    xx = i % cfg.width
    yy = i // cfg.width + (nb // 2 if band is None else band) * band_h
    seed = initial_seed(cam, bcfg, yy * cfg.width + xx, 0)
    seed, ray_o, ray_d = make_primary_rays(cam, bcfg, seed, xx, yy,
                                           cfg.height)
    zero = torch.zeros(p, device="cuda")
    one = torch.ones(p, device="cuda")
    return (ray_o, ray_d, (zero,) * 3, (one,) * 3, seed,
            torch.ones(p, dtype=torch.bool, device="cuda"), i)


def walk_occupancy(walks: torch.Tensor, warp: int = 32) -> dict:
    """Walks (bounces run) per ray of a mega call and the lane occupancy of
    one ray per thread: the walks run over 32 x the longest path of each
    warp of 32 consecutive rays."""
    it = torch.nn.functional.pad(walks, (0, -walks.numel() % warp))
    longest = int(it.view(-1, warp).amax(1).sum())
    return dict(occupancy=int(walks.sum()) / max(warp * longest, 1),
                mean_walks=float(walks.float().mean()),
                max_walks=int(walks.max()))


def mega_profile(args, got, rays) -> dict:
    """The mega kernel's counting build on one call (colours and rays
    traced checked equal to the kernel's ``got`` and ``rays``), under the
    kernel's schedule (``kernel``) and under one ray a thread walking a
    whole bounce at a time (``one_ray_a_thread``): the SIMD efficiency of
    the walk's visit loop (active lanes / (32 x warp trips)) and of its
    leaf tests, their trips, the launch's blocks, its span from the first
    block's start to the last block's end and the share of it after the
    first block ended (the drain)."""
    from raytracer_tpu_torch.kernels.mega import mega_count

    out = {}
    for label, schedule in (("kernel", 1), ("one_ray_a_thread", 0)):
        c, r, tallies, times = mega_count(*args, schedule=schedule)
        assert torch.equal(c.view(torch.int32), got.view(torch.int32)) \
            and int(r) == int(rays), "counting build differs from the kernel"
        vt, vl, lt, ll = (int(x) for x in tallies)
        t = times.double()
        span = float(t[:, 1].max() - t[:, 0].min())
        out[label] = dict(visit_efficiency=vl / (32 * max(vt, 1)),
                          leaf_efficiency=ll / (32 * max(lt, 1)),
                          visit_trips=vt, leaf_trips=lt,
                          blocks=int(t.shape[0]), span_ms=span / 1e6,
                          drain_share=float(t[:, 1].max() - t[:, 1].min())
                          / max(span, 1.0))
    return out


def check_mega(scene, cfg, cam, results):
    """The mega kernel against the plain megakernel (its width levels and
    all) on each 720p band (top, middle, bottom), from bounce 0 (the
    ``RAYTPU_B0=mega`` state: raster primaries) and from bounce 1 (the
    ``RAYTPU_BOUNCE=mega`` state: tile-major, after kernel A and the
    shade, pads dropped): 0 differing colour bytes, rays traced equal; the
    kernel's device time, a call's time, the plain version's, the bound,
    the lane occupancy of one ray a thread at walk level and the visit
    and leaf SIMD efficiency of its counting build under both schedules
    (``mega_profile``)."""
    from raytracer_tpu_torch.engine.renderer import _num_bands
    from raytracer_tpu_torch.kernels.mega import mega
    from raytracer_tpu_torch.kernels.packet import megakernel_bounces

    nb = _num_bands(cfg)
    n_out = cfg.height // nb * cfg.width
    tables = nbytes(scene.nodes8, scene.clusters, scene.cluster_counts)
    rows = {}
    for band, bname in ((nb // 2, "middle"), (0, "top"), (nb - 1, "bottom")):
        for start, state in ((0, band_raster(scene, cfg, cam, band)),
                             (1, band_bounce1(scene, cfg, cam, band))):
            o, d, c, a, seed, alive, pix = state
            args = (scene, o, d, c, a, seed, alive, True, cfg, start, pix,
                    n_out)
            got, rays = mega(*args)
            # One plain call (seconds), compared and timed.
            res = []
            plain_ms = time_ms(lambda: res.append(plain_work(
                lambda: megakernel_bounces(*args, walks=True))), 1,
                warm=False)
            (want, want_rays, walks), work = res[0]
            n_diff = int((got.view(torch.int32) != want.view(torch.int32))
                         .any(0).sum())
            err = (got - want).abs().max().item()
            ms = device_ms(lambda: mega(*args), 10, "mega_kernel")
            call_ms = time_ms(lambda: mega(*args), 10)
            lanes = walk_occupancy(walks)
            prof = mega_profile(args, got, rays)
            p = alive.shape[0]
            # The ray state in (12 floats, seed, alive, pixel id), the
            # colours out, the tables once.
            b = bound(p * (12 * 4 + 4 + 1 + 4) + 3 * 4 * n_out + tables,
                      work)
            print(f"check mega, {bname} band from bounce {start}, {p} rays:"
                  f" differing pixels {n_diff}, rays traced {int(rays)} vs "
                  f"{int(want_rays)}; kernel {ms:.4f} ms on the device, "
                  f"{call_ms:.4f} ms a call, plain {plain_ms:.2f} ms; bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); walks a ray "
                  f"{lanes['mean_walks']:.4f} (max {lanes['max_walks']}), "
                  f"walk-level lane occupancy of one ray a thread "
                  f"{lanes['occupancy']:.4f}; visit / leaf SIMD efficiency "
                  + "; ".join(f"{k} {v['visit_efficiency']:.4f} / "
                              f"{v['leaf_efficiency']:.4f} ({v['visit_trips']}"
                              f" visit trips, {v['blocks']} blocks, drain "
                              f"{v['drain_share']:.3f})"
                              for k, v in prof.items())
                  + f"; work {work}")
            assert n_diff == 0 and err == 0.0 and int(rays) == int(want_rays)
            rows[bname, start] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                rays=int(rays), **lanes, lanes=prof, **b)
    # The middle band's bounce-0 call (RAYTPU_B0=mega: the whole band in
    # one launch) is the kernel's row; the other calls ride beside it.
    results["mega"] = dict(rows["middle", 0], from_bounce1=rows["middle", 1],
                           bands={f"{bname}_b{start}": row
                                  for (bname, start), row in rows.items()
                                  if bname != "middle"})


def differing_bytes(got, want) -> int:
    """Bytes that differ between two (nested) tuples of tensors."""
    n = 0
    for g, w in zip(got, want, strict=True):
        if isinstance(g, tuple):
            n += differing_bytes(g, w)
        elif g is None or w is None:
            assert g is None and w is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            n += int((g.contiguous().view(torch.uint8)
                      != w.contiguous().view(torch.uint8)).sum())
    return n


def check_front(scene, cfg, cam, results):
    """The ray-gen and shade kernels (``csrc/front.cu``) on the middle
    720p band against their plain versions: ray-gen from the camera, then
    the shade of bounce 0 on kernel A's record of those primaries, 0
    differing bytes in every output row; each kernel's device time
    (profiler, inputs from device memory and from L2), a call's time, the
    plain version's and the bytes bound."""
    import dataclasses

    from raytracer_tpu_torch.engine.renderer import _num_bands
    from raytracer_tpu_torch.kernels import packet, trace, tracer

    nb = _num_bands(cfg)
    band_h = cfg.height // nb
    bcfg = dataclasses.replace(cfg, height=band_h)
    grain = max(trace.BLOCK, trace.BBLOCK)
    p_pad = -(-band_h * cfg.width // grain) * grain
    args = (cam, bcfg, p_pad, nb // 2 * band_h, cfg.height, 0, "cuda")
    got = packet.primary_rays(*args)
    want = packet.primary_rays_plain(*args)
    n_raygen = differing_bytes(got, want)
    rays, seed, alive, _ = got
    res = trace.traverse_rays(scene, rays, alive, bcfg, coherent=True)
    zero = torch.zeros(p_pad, device="cuda")
    one = torch.ones(p_pad, device="cuda")
    sargs = (res, rays[0:3].unbind(0), rays[3:6].unbind(0),
             (zero,) * 3, (one,) * 3, seed, alive, True, bcfg)
    got_s = tracer.shade(*sargs)
    n_shade = differing_bytes(got_s, tracer.shade_plain(*sargs))
    # Bytes read and written once: ray-gen writes the rays, seed, alive
    # and pixel ids (the camera's 52 bytes aside); the shade reads the
    # record, hit, alive, ray, colour, atten and seed and writes the ray,
    # colour, atten, seed and scattered flag.
    moved = {"raygen": nbytes(*got),
             "shade": nbytes(res.closest_t, *res.normal, *res.mat_albedo,
                             res.mat_type, res.hit, alive, *sargs[1],
                             *sargs[2], *sargs[3], *sargs[4], seed)
             + nbytes(*got_s[0], *got_s[1], *got_s[2], *got_s[3],
                      got_s[4], got_s[5])}
    calls = {"raygen": (lambda: packet.primary_rays(*args),
                        lambda: packet.primary_rays_plain(*args)),
             "shade": (lambda: tracer.shade(*sargs),
                       lambda: tracer.shade_plain(*sargs))}
    for name, n_diff in (("raygen", n_raygen), ("shade", n_shade)):
        kern, plain = calls[name]
        ms = device_ms(kern, 50, f"{name}_kernel", cold=True)
        warm_ms = device_ms(kern, 50, f"{name}_kernel")
        call_ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, 5)
        b = bound(moved[name])
        print(f"check {name}, middle 720p band, {p_pad} rays: differing "
              f"bytes {n_diff}; kernel {ms:.4f} ms on the device from "
              f"device memory, {warm_ms:.4f} ms from L2, {call_ms:.4f} ms a "
              f"call; plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}, {moved[name]} bytes)")
        assert n_diff == 0
        results[name] = dict(max_abs_err=0.0, ms=ms, warm_ms=warm_ms,
                             call_ms=call_ms, plain_ms=plain_ms,
                             differing_bytes=n_diff, **b)


def frame_launches(scene, cfg, cam, env) -> int:
    """Device activities (kernels, copies, memsets) of one frame under the
    knobs ``env``, from the profiler."""
    from raytracer_tpu_torch.engine.renderer import Renderer

    with knob_env(env):
        r = Renderer(cfg)
        r.render(scene, cam.uniforms())
        return device_launches(lambda: r.render(scene, cam.uniforms()))


def run_xla_paths(scene, cfg, cam, frames: int = 4) -> dict:
    """Phase 18's frames: the default path and each XLA-path knob at full
    width, in turns (default, each path, each path again in reverse,
    default): FPS per turn, ms a frame, Mrays/s, kernel launches a frame
    and device activities a frame."""
    order = (["default"] + list(XLA_PATHS) + list(reversed(XLA_PATHS))
             + ["default"])
    turns = {}
    for label in order:
        env, kernels = (({}, ("trace4", "bounce12", "tonemap"))
                        if label == "default" else XLA_PATHS[label][:2])
        turns.setdefault(label, []).append(run_path(
            f"XLA A/B {label}", scene, cfg, cam, frames, env, kernels))
    out = {}
    for label, runs in turns.items():
        env = {} if label == "default" else XLA_PATHS[label][0]
        fps = [r["fps"] for r in runs]
        out[label] = dict(
            fps=fps, ms=[r["ms"] for r in runs],
            mrays=[r["mrays"] for r in runs],
            launches_per_frame={k: v / frames
                                for k, v in runs[-1]["counts"].items()},
            device_launches_per_frame=frame_launches(scene, cfg, cam, env),
            image=runs[-1]["image"], counts=runs[-1]["counts"])
        print(f"XLA A/B {label}: FPS {', '.join(f'{x:.3f}' for x in fps)}, "
              f"ms a frame {', '.join(f'{x:.2f}' for x in out[label]['ms'])}"
              f", Mrays/s {', '.join(f'{x:.2f}' for x in out[label]['mrays'])}"
              f"; kernel launches a frame {out[label]['launches_per_frame']}"
              f"; device activities a frame "
              f"{out[label]['device_launches_per_frame']}")
    return out


# Phase 19: the host builds -> their knobs.
HOST_BUILDS = {"median": {"RAYTPU_BVH": "median"},
               "sbvh": {"RAYTPU_BVH": "sbvh"},
               "ploc": {"RAYTPU_BVH": "ploc"},
               "leaf_counts_off": {"RAYTPU_LEAF_COUNTS": "0"},
               "numpy": {"RAYTPU_NATIVE": "0"}}


def check_host_builds(cfg, cam) -> dict:
    """Phase 19: each host build (``HOST_BUILDS``) of the flagship soup
    (``RAYTPU_NATIVE=0``: of the ``sphere_light`` preset, its meshes
    parsed by the Python ``.obj`` parser): build seconds, node, wide and
    leaf-reference counts; kernels A, B, ``trace2`` and ``trace2_warp`` on
    its tables against their plain versions (0 differing lanes); one frame
    at full width. A table whose walk would need more stack slots than
    the kernels have is refused, and the refusal is recorded."""
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import (UNIFORM_BUDGET,
                                                    pack_state)
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene.builder import (
        build_fast_scene, build_fast_scene_from_arrays)

    verts, mats, _ = presets.flagship_arrays()
    out = {}
    for name, env in HOST_BUILDS.items():
        bcfg, bcam = cfg, cam
        with knob_env(env):
            t0 = time.perf_counter()
            try:
                if name == "numpy":
                    pre = presets.config2_sphere_light()
                    bcfg, bcam = pre.config, pre.camera
                    scene = build_fast_scene(pre.scene.create_snapshot())
                else:
                    scene = build_fast_scene_from_arrays(verts, mats)
            except ValueError as e:
                if "STACK_CAP" not in str(e):
                    raise
                print(f"host build {name}: refused ({e})")
                out[name] = dict(refused=str(e))
                continue
            _sync()
            build_s = time.perf_counter() - t0
        uni = bcam.uniforms()
        _, _, ray_o, ray_d, alive, _ = band_primaries(scene, bcfg, uni)
        rays = torch.stack([*ray_o, *ray_d]).contiguous()
        lanes = {n: int(compare_trace(scene, rays, alive, bcfg, n)[2].sum())
                 for n in ("trace4", "trace2", "trace2_warp")}
        o, d, color, atten, seed, live, pix = band_bounce1(scene, bcfg, uni)
        atten = tuple(torch.where(live, a, c) for a, c in zip(atten, color))
        state = pack_state(o, d, atten, seed, live, UNIFORM_BUDGET, pix)
        state, _ = wavefront._sorted(state,
                                     wavefront._state_key(state, scene))
        lanes["bounce12"] = compare_bounce(scene, state, bcfg,
                                           f"{name} tables")[0]
        run = run_path(f"host build {name}", scene, bcfg, bcam, 1, {},
                       ("trace4", "bounce12", "tonemap"))
        out[name] = dict(build_s=build_s, triangles=scene.num_triangles,
                         nodes=scene.num_nodes, wide_nodes=scene.num_nodes4,
                         references=int(scene.cluster_counts.sum()),
                         differing_lanes=lanes, frame_ms=run["ms"],
                         width=bcfg.width, height=bcfg.height)
        print(f"host build {name}: {scene.num_triangles} triangles, "
              f"{out[name]['references']} leaf references, "
              f"{scene.num_nodes} nodes, {scene.num_nodes4} wide, built in "
              f"{build_s:.3f} s; kernels vs plain on its tables, differing "
              f"lanes {lanes}; one {bcfg.width}x{bcfg.height} frame "
              f"{run['ms']:.2f} ms")
        assert not any(lanes.values()), (name, lanes)
    return out


# Phase 20: kernel B's key and walk-order builds -> (wrapper, key mode,
# ordered walk, source, the TPU kernel code the build replaces).
KEY_BUILDS = {
    "bounce12_pd5": ("bounce12", "pd5", True,
                     "raytracer_tpu_torch/csrc/bounce_pd5.cu",
                     "raytracer_tpu/kernels/pallas_mega.py:557"),
    "bounce12_om9": ("bounce12", "om9", True,
                     "raytracer_tpu_torch/csrc/bounce_om9.cu",
                     "raytracer_tpu/kernels/pallas_mega.py:583"),
    "bounce12_unordered": ("bounce12", "cid", False,
                           "raytracer_tpu_torch/csrc/bounce12.cu",
                           "raytracer_tpu/kernels/pallas_mega.py:264"),
    "bounce15_pd5": ("bounce15", "pd5", True,
                     "raytracer_tpu_torch/csrc/bounce_pd5.cu",
                     "raytracer_tpu/kernels/pallas_mega.py:557"),
    "bounce15_om9": ("bounce15", "om9", True,
                     "raytracer_tpu_torch/csrc/bounce_om9.cu",
                     "raytracer_tpu/kernels/pallas_mega.py:583"),
    "bounce15_unordered": ("bounce15", "cid", False,
                           "raytracer_tpu_torch/csrc/bounce12.cu",
                           "raytracer_tpu/kernels/pallas_mega.py:264"),
    "bounce_packed_pd5": ("bounce_packed", "pd5", True,
                          "raytracer_tpu_torch/csrc/bounce_pd5.cu",
                          "raytracer_tpu/kernels/pallas_mega.py:645"),
    "bounce_packed_om9": ("bounce_packed", "om9", True,
                          "raytracer_tpu_torch/csrc/bounce_om9.cu",
                          "raytracer_tpu/kernels/pallas_mega.py:645"),
}
# The sorted rounds' A/B values at full width -> (their knobs, the kernels
# a frame launches). Each new build is launched by one of them.
KNOB_RUNS = {
    "TAIL_MERGE=0": ({"RAYTPU_TAIL_MERGE": "0"}, ("trace4", "bounce12")),
    "SORT_KEY=pd5": ({"RAYTPU_SORT_KEY": "pd5"}, ("trace4", "bounce12_pd5")),
    "SORT_KEY=om9": ({"RAYTPU_SORT_KEY": "om9"}, ("trace4", "bounce12_om9")),
    "SORT_KEY=pos": ({"RAYTPU_SORT_KEY": "pos"}, ("trace4", "bounce12")),
    "SORT_KEY=oct_morton": ({"RAYTPU_SORT_KEY": "oct_morton"},
                            ("trace4", "bounce12")),
    "GLUE=pack": ({"RAYTPU_GLUE": "pack"}, ("trace4", "bounce12")),
    "DEPOSIT=ch": ({"RAYTPU_DEPOSIT": "ch"}, ("trace4", "bounce12")),
    "DEPOSIT=rows": ({"RAYTPU_DEPOSIT": "rows"}, ("trace4", "bounce12")),
    "WAVE_MINW=2048": ({"RAYTPU_WAVE_MINW": "2048"}, ("trace4", "bounce12")),
    "WAVE_BCAP=2": ({"RAYTPU_WAVE_BCAP": "2"}, ("trace4", "bounce12")),
    "TAIL_BCAP=3": ({"RAYTPU_TAIL_BCAP": "3"}, ("trace4", "bounce12")),
    "ORDER_MINW=65536": ({"RAYTPU_ORDER_MINW": "65536"},
                         ("trace4", "bounce12", "bounce12_unordered")),
    "DEEP_SUB=32": ({"RAYTPU_DEEP_SUB": "32"}, ("trace4", "bounce12")),
    "DEEP_MAXW=100000": ({"RAYTPU_DEEP_MAXW": "100000"},
                         ("trace4", "bounce12")),
    "BOUNCE=pmega,SORT_KEY=pd5": (
        {"RAYTPU_BOUNCE": "pmega", "RAYTPU_SORT_KEY": "pd5"},
        ("trace4", "bounce15")),
    "WAVE=fused,GLUE=perfield": ({"RAYTPU_WAVE": "fused",
                                  "RAYTPU_GLUE": "perfield"},
                                 ("trace4", "bounce15")),
    "WAVE=fused,SORT_KEY=pd5": ({"RAYTPU_WAVE": "fused",
                                 "RAYTPU_SORT_KEY": "pd5"},
                                ("trace4", "bounce15_pd5")),
    "WAVE=fused,SORT_KEY=om9": ({"RAYTPU_WAVE": "fused",
                                 "RAYTPU_SORT_KEY": "om9"},
                                ("trace4", "bounce15_om9")),
    "WAVE=fused,ORDER_MINW=65536": (
        {"RAYTPU_WAVE": "fused", "RAYTPU_ORDER_MINW": "65536"},
        ("trace4", "bounce15", "bounce15_unordered")),
    "WAVE=fused_packed,PACK_GATHER=row": (
        {"RAYTPU_WAVE": "fused_packed", "RAYTPU_PACK_GATHER": "row"},
        ("trace4", "bounce_packed", "bounce15")),
    "WAVE=fused_packed,SORT_KEY=pd5": (
        {"RAYTPU_WAVE": "fused_packed", "RAYTPU_SORT_KEY": "pd5"},
        ("trace4", "bounce_packed_pd5", "bounce15_pd5")),
    "WAVE=fused_packed,SORT_KEY=om9": (
        {"RAYTPU_WAVE": "fused_packed", "RAYTPU_SORT_KEY": "om9"},
        ("trace4", "bounce_packed_om9", "bounce15_om9")),
}
# The run whose launches the kernels line reports for each new build.
BUILD_RUNS = {"bounce12_pd5": "SORT_KEY=pd5", "bounce12_om9": "SORT_KEY=om9",
              "bounce12_unordered": "ORDER_MINW=65536",
              "bounce15_pd5": "WAVE=fused,SORT_KEY=pd5",
              "bounce15_om9": "WAVE=fused,SORT_KEY=om9",
              "bounce15_unordered": "WAVE=fused,ORDER_MINW=65536",
              "bounce_packed_pd5": "WAVE=fused_packed,SORT_KEY=pd5",
              "bounce_packed_om9": "WAVE=fused_packed,SORT_KEY=om9"}
# 256x128 frames, kernels against plain versions: the knobs in groups,
# every knob and every new build in one of them -> the plain versions a
# frame books.
KNOB_FRAMES = {
    "SORT_KEY=pd5": ({"RAYTPU_SORT_KEY": "pd5"}, ("bounce12_pd5",)),
    "WAVE=fused,SORT_KEY=om9,GLUE=perfield,DEPOSIT=rows": (
        {"RAYTPU_WAVE": "fused", "RAYTPU_SORT_KEY": "om9",
         "RAYTPU_GLUE": "perfield", "RAYTPU_DEPOSIT": "rows"},
        ("bounce15_om9",)),
    "WAVE=fused_packed,SORT_KEY=pd5,PACK_GATHER=row": (
        {"RAYTPU_WAVE": "fused_packed", "RAYTPU_SORT_KEY": "pd5",
         "RAYTPU_PACK_GATHER": "row"},
        ("bounce_packed_pd5", "bounce15_pd5")),
    "WAVE=fused_packed,SORT_KEY=om9": (
        {"RAYTPU_WAVE": "fused_packed", "RAYTPU_SORT_KEY": "om9"},
        ("bounce_packed_om9", "bounce15_om9")),
    "ORDER_MINW=12000,WAVE_BCAP=2,TAIL_BCAP=3": (
        {"RAYTPU_ORDER_MINW": "12000", "RAYTPU_WAVE_BCAP": "2",
         "RAYTPU_TAIL_BCAP": "3"}, ("bounce12", "bounce12_unordered")),
    "WAVE=fused,ORDER_MINW=12000,SORT_KEY=pos": (
        {"RAYTPU_WAVE": "fused", "RAYTPU_ORDER_MINW": "12000",
         "RAYTPU_SORT_KEY": "pos"}, ("bounce15", "bounce15_unordered")),
    "GLUE=pack,DEPOSIT=ch,WAVE_MINW=2048,DEEP_MAXW=100000": (
        {"RAYTPU_GLUE": "pack", "RAYTPU_DEPOSIT": "ch",
         "RAYTPU_WAVE_MINW": "2048", "RAYTPU_DEEP_MAXW": "100000"},
        ("bounce12",)),
    "DEEP_SUB=32,TAIL_MERGE=0,SORT_KEY=oct_morton": (
        {"RAYTPU_DEEP_SUB": "32", "RAYTPU_TAIL_MERGE": "0",
         "RAYTPU_SORT_KEY": "oct_morton"}, ("bounce12",)),
}
# RAYTPU_SORT_KEY's modes, the five of the JAX package's sort_key.
SORT_MODES = ("cid", "pd5", "om9", "pos", "oct_morton")


def key_states(scene, cfg, cam, mode: str):
    """The middle band's bounce-1 state as each engine's first round gets
    it under ``RAYTPU_SORT_KEY=mode``: sorted by that key (the host form;
    cid's is om9's) -> (fused12 i32[13, P], fused i32[16, P], packed
    (sf, si))."""
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import UNIFORM_BUDGET, pack_state

    o, d, color, atten, seed, alive, pix = band_bounce1(scene, cfg, cam)
    att12 = tuple(torch.where(alive, a, c) for a, c in zip(atten, color))
    st12 = pack_state(o, d, att12, seed, alive, UNIFORM_BUDGET, pix)
    st15 = pack_state(o, d, atten, seed, alive, UNIFORM_BUDGET, pix,
                      color=color)
    packed = (torch.stack([*o, *d, *color, *atten, alive.to(torch.float32)]),
              torch.stack([seed.to(torch.int32), pix]))
    return tuple(
        wavefront._sorted(st, wavefront._state_key(st, scene, engine,
                                                   mode))[0]
        for st, engine in ((st12, "fused12"), (st15, "fused"),
                           (packed, "fused_packed")))


def build_calls(scene, cfg, name, state, bcap=1):
    """(kernel call, plain call) of build ``name`` (KEY_BUILDS) on
    ``state`` (a packed pair for the packed builds)."""
    from raytracer_tpu_torch.kernels import bounce

    kernel, key_mode, ordered = KEY_BUILDS[name][:3]
    if kernel == "bounce_packed":
        args = (scene, *state, bcap, True, cfg, key_mode)
    else:
        args = (scene, state, bcap, True, cfg, key_mode, ordered)
    return (lambda: getattr(bounce, kernel)(*args),
            lambda: getattr(bounce, f"{kernel}_plain")(*args))


def equal_outputs(got, want) -> int:
    """Differing bytes between a kernel's outputs and its plain
    version's."""
    n = 0
    for g, w in zip(got, want):
        g, w = (x.contiguous().view(torch.uint8) for x in (g, w))
        n += int((g != w).sum())
    return n


def tail_state(scene, cfg, cam, state, kernel):
    """A merged-tail-width state from ``state`` after one default round of
    ``kernel`` (bounce12 or bounce15), live rays first, budgets 0-3."""
    from raytracer_tpu_torch.kernels import bounce, wavefront
    from raytracer_tpu_torch.kernels.bounce import ROW_BUDGET
    from raytracer_tpu_torch.kernels.packet import tail_merge_widths

    out, key, _ = getattr(bounce, kernel)(scene, state, 1, True, cfg)
    out, _ = wavefront._sorted(out, key)
    bcfg = band_primaries(scene, cfg, cam)[0]
    merged = tail_merge_widths(cfg, bcfg.height, cfg.height // bcfg.height)
    w = min(merged[1], out.shape[1])
    tail = out[:, :w].contiguous()
    g = torch.Generator(device="cuda").manual_seed(7)
    tail[ROW_BUDGET] = torch.randint(0, 4, (w,), generator=g, device="cuda",
                                     dtype=torch.int32)
    return tail


def check_key_builds(scene, cfg, cam, results):
    """Phase 20: each build of KEY_BUILDS against its plain version on the
    middle 720p band's bounce-1 state sorted by its key (the unordered
    builds also on a merged-tail state with budgets 0-3): 0 differing
    bytes in state, key and counts; its time, the plain version's and
    the bound."""
    states = {m: key_states(scene, cfg, cam, m) for m in ("cid", "pd5",
                                                           "om9")}
    tables = nbytes(scene.nodes4, scene.clusters)
    for name, (kernel, key_mode, ordered, _, _) in KEY_BUILDS.items():
        st12, st15, packed = states[key_mode]
        state = {"bounce12": st12, "bounce15": st15}.get(kernel, packed)
        call, plain = build_calls(scene, cfg, name, state)
        got = call()
        want, work = plain_work(plain)
        n_diff = equal_outputs(got, want)
        ms = time_ms(call, 10)
        plain_ms = time_ms(plain, 1, warm=False)
        p = st12.shape[1]
        b = bound(2 * nbytes(*(state if isinstance(state, tuple)
                               else (state,))) + 4 * p + tables + 24, work)
        print(f"check {name} ({kernel}, key {key_mode}, "
              f"{'ordered' if ordered else 'unordered'} walk) on the sorted "
              f"bounce-1 round of {p} rays: rays/live {got[-1].tolist()}, "
              f"differing bytes {n_diff}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); work {work}")
        assert n_diff == 0, f"{name} differs from its plain version"
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **b)
        if not ordered:
            tail = tail_state(scene, cfg, cam, state, kernel)
            call, plain = build_calls(scene, cfg, name, tail)
            n_tail = equal_outputs(call(), plain())
            print(f"check {name} on a tail round of {tail.shape[1]} rays "
                  f"with budgets 0-3: differing bytes {n_tail}")
            assert n_tail == 0, f"{name} differs on the tail state"


def time_sort_keys(scene, cfg, cam) -> dict:
    """Kernel B, each key's build, on the middle band's bounce-1 round and
    on its bounce-2 round (after one default round; cid is then the
    winner-cluster key the kernel emitted, on bounce 1 it is om9's host
    form) sorted by each of the five keys: device ms (CUDA events, 20
    launches), beside the bound (the same work and bytes whatever the
    order)."""
    from raytracer_tpu_torch.kernels import bounce, wavefront
    from raytracer_tpu_torch.kernels.keys import KERNEL_KEYS

    st1 = key_states(scene, cfg, cam, "cid")[0]
    st2, cid2, _ = bounce.bounce12(scene, st1, 1, True, cfg)
    tables = nbytes(scene.nodes4, scene.clusters)
    out = {}
    for label, state in (("bounce1", st1), ("bounce2", st2)):
        _, work = plain_work(
            lambda: bounce.bounce12_plain(scene, state, 1, True, cfg))
        b = bound(2 * nbytes(state) + 4 * state.shape[1] + tables + 24,
                  work)
        for mode in SORT_MODES:
            key = (cid2 if label == "bounce2" and mode == "cid" else
                   wavefront._state_key(state, scene, "fused12", mode))
            s, _ = wavefront._sorted(state, key)
            build = mode if mode in KERNEL_KEYS else "cid"
            ms = time_ms(lambda: bounce.bounce12(scene, s, 1, True, cfg,
                                                 build), 20)
            row = dict(ms=ms, build=bounce.build_name("bounce12", build),
                       **b)
            out[f"{label}_{mode}"] = row
            print(f"kernel B on the {label} round of {state.shape[1]} rays "
                  f"sorted by {mode}: {ms:.4f} ms ({row['build']}), bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return out


def run_knob_paths(scene, cfg, cam, frames: int = 4) -> dict:
    """Phase 20's frames: each A/B value of KNOB_RUNS at full width, with
    the default before, between the two halves and after: FPS, ms a frame,
    Mrays/s, kernel launches and device activities a frame."""
    labels = list(KNOB_RUNS)
    half = len(labels) // 2
    order = ["default"] + labels[:half] + ["default"] + labels[half:] + [
        "default"]
    out = {}
    for label in order:
        env, kernels = (({}, ("trace4", "bounce12")) if label == "default"
                        else KNOB_RUNS[label])
        run = run_path(f"knob A/B {label}", scene, cfg, cam, frames, env,
                       kernels + ("tonemap",))
        entry = out.setdefault(label, dict(fps=[], ms=[], mrays=[]))
        for k in ("fps", "ms", "mrays"):
            entry[k].append(run[k])
        entry["launches_per_frame"] = {k: v / frames
                                       for k, v in run["counts"].items()}
        entry["counts"] = run["counts"]
    for label, entry in out.items():
        env = {} if label == "default" else KNOB_RUNS[label][0]
        entry["device_launches_per_frame"] = frame_launches(scene, cfg, cam,
                                                            env)
        print(f"knob A/B {label}: FPS "
              f"{', '.join(f'{x:.3f}' for x in entry['fps'])}, ms a frame "
              f"{', '.join(f'{x:.2f}' for x in entry['ms'])}; kernel "
              f"launches a frame {entry['launches_per_frame']}; device "
              f"activities a frame {entry['device_launches_per_frame']}")
    return out


# Phase 21: the table layouts off the default -> the knobs a table is
# built under.
LAYOUT_KNOBS = {"c2": {"RAYTPU_CLUSTER": "2"}, "c4": {"RAYTPU_CLUSTER": "4"},
                "w16": {"RAYTPU_WIDE": "16"},
                "c2w16": {"RAYTPU_CLUSTER": "2", "RAYTPU_WIDE": "16"},
                "c4w16": {"RAYTPU_CLUSTER": "4", "RAYTPU_WIDE": "16"}}
# The layouts rendered at full width with 4 frames, in turns with the
# default layout's kernels A and B.
FULL_LAYOUTS = ("c2", "c4", "w16")
# Kernel B's 15 builds: the name at the default layout -> (wrapper, key
# mode, ordered walk).
B_BUILDS = {f"{k}{'' if key == 'cid' else '_' + key}"
            f"{'' if ordered else '_unordered'}": (k, key, ordered)
            for k in ("bounce12", "bounce15", "bounce_packed")
            for key in ("cid", "pd5", "om9")
            for ordered in (True, False)
            if ordered or k != "bounce_packed"}
# Each build's source and the TPU kernel code it replaces.
B_SOURCES = {"cid": "raytracer_tpu_torch/csrc/bounce12.cu",
             "pd5": "raytracer_tpu_torch/csrc/bounce_pd5.cu",
             "om9": "raytracer_tpu_torch/csrc/bounce_om9.cu"}
B_REPLACES = {"bounce12": "raytracer_tpu/kernels/pallas_mega.py:782",
              "bounce15": "raytracer_tpu/kernels/pallas_mega.py:800",
              "bounce_packed": "raytracer_tpu/kernels/pallas_mega.py:645"}
# The paths each layout's frames run -> (their knobs, the kernels a frame
# launches, by their default-layout names). Every build of kernel B runs
# on one of them; the binary walks and mega (leaf builds) at the cluster
# layouts only.
ORDER_ALL = {"RAYTPU_ORDER_MINW": "65536"}
LAYOUT_PATHS = {
    "main": ({}, ("trace4", "bounce12", "tonemap")),
    "ORDER_MINW": (ORDER_ALL, ("trace4", "bounce12", "bounce12_unordered")),
    "SORT_KEY=pd5": (dict(ORDER_ALL, RAYTPU_SORT_KEY="pd5"),
                     ("trace4", "bounce12_pd5", "bounce12_pd5_unordered")),
    "SORT_KEY=om9": (dict(ORDER_ALL, RAYTPU_SORT_KEY="om9"),
                     ("trace4", "bounce12_om9", "bounce12_om9_unordered")),
    "WAVE=fused": (dict(ORDER_ALL, RAYTPU_WAVE="fused"),
                   ("trace4", "bounce15", "bounce15_unordered")),
    "WAVE=fused,SORT_KEY=pd5": (
        dict(ORDER_ALL, RAYTPU_WAVE="fused", RAYTPU_SORT_KEY="pd5"),
        ("trace4", "bounce15_pd5", "bounce15_pd5_unordered")),
    "WAVE=fused,SORT_KEY=om9": (
        dict(ORDER_ALL, RAYTPU_WAVE="fused", RAYTPU_SORT_KEY="om9"),
        ("trace4", "bounce15_om9", "bounce15_om9_unordered")),
    "WAVE=fused_packed": ({"RAYTPU_WAVE": "fused_packed"},
                          ("trace4", "bounce_packed", "bounce15")),
    "WAVE=fused_packed,SORT_KEY=pd5": (
        {"RAYTPU_WAVE": "fused_packed", "RAYTPU_SORT_KEY": "pd5"},
        ("trace4", "bounce_packed_pd5", "bounce15_pd5")),
    "WAVE=fused_packed,SORT_KEY=om9": (
        {"RAYTPU_WAVE": "fused_packed", "RAYTPU_SORT_KEY": "om9"},
        ("trace4", "bounce_packed_om9", "bounce15_om9")),
    "split+binary": ({"RAYTPU_WAVE": "split", "RAYTPU_TRAVERSE": "binary"},
                     ("trace2_warp", "trace2")),
    "B0=mega": ({"RAYTPU_B0": "mega"}, ("mega",)),
}
LEAF_KERNELS = ("trace2", "trace2_warp", "mega")


def layout_kernel(name: str, layout) -> str:
    """A kernel's launch name on tables of ``layout`` (the binary walks
    and mega run the build of the layout's leaves)."""
    from raytracer_tpu_torch.kernels import cuda_build

    if name == "tonemap":
        return name
    if name in LEAF_KERNELS:
        return cuda_build.leaf_kernel_name(name, layout)
    return cuda_build.kernel_name(name, layout)


def layout_scenes() -> dict:
    """The flagship built under each layout's knobs -> name -> (scene,
    build seconds)."""
    from raytracer_tpu_torch.scene import presets

    out = {}
    for name, env in LAYOUT_KNOBS.items():
        with knob_env(env):
            t0 = time.perf_counter()
            scene = presets.flagship_scene()
            _sync()
            out[name] = (scene, time.perf_counter() - t0)
        s = out[name][0]
        print(f"layout {name} {s.layout}: flagship {s.num_triangles} "
              f"triangles, nodes8 {s.nodes8.shape[0]} rows, nodes4 "
              f"{s.nodes4.shape[0]} rows ({s.num_nodes4} wide nodes), "
              f"clusters {s.clusters.shape[0]} rows, built in "
              f"{out[name][1]:.3f} s")
    return out


def build_layouts() -> dict:
    """Phase 21 (a): the five non-default layout libraries, every nvcc at
    once -> (nvcc seconds, launch name -> attrs of each kernel)."""
    from raytracer_tpu_torch.kernels import cuda_build

    layouts = [l for l in cuda_build.LAYOUTS
               if l != cuda_build.DEFAULT_LAYOUT]
    t0 = time.perf_counter()
    cuda_build.build(layouts)
    secs = time.perf_counter() - t0
    attrs = {cuda_build.kernel_name(k, l): cuda_build.kernel_attrs(k, l)
             for l in cuda_build.LAYOUTS for k in cuda_build.KERNELS}
    print(f"build: {len(layouts)} layout libraries "
          f"({', '.join(cuda_build.layout_tag(l)[1:] for l in layouts)}), "
          f"{len(layouts) * len(cuda_build.SOURCES)} nvcc at once, "
          f"{secs:.1f} s")
    for k in ("trace4", "bounce12", "bounce15_pmega", "bounce_packed",
              "trace2", "mega"):
        print(f"registers / local B / blocks per SM of {k}: " + ", ".join(
            f"{cuda_build.layout_tag(l)[1:] or 'default'} "
            f"{attrs[cuda_build.kernel_name(k, l)]['regs']} / "
            f"{attrs[cuda_build.kernel_name(k, l)]['local_bytes']} / "
            f"{attrs[cuda_build.kernel_name(k, l)]['blocks_per_sm']}"
            for l in cuda_build.LAYOUTS))
    return dict(nvcc_s=secs, attrs=attrs)


def _check_kernel(label, call, plain, nbytes_, rows, key):
    """Kernel vs plain on the same inputs: 0 differing bytes -> a row with
    its time, the plain version's (that one call, CUDA events) and the
    bound."""
    got = call()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want, work = plain_work(plain)
    end.record()
    _sync()
    plain_ms = start.elapsed_time(end)
    n_diff = equal_outputs(got if isinstance(got, tuple) else (got,),
                           want if isinstance(want, tuple) else (want,))
    ms = time_ms(call, 10)
    b = bound(nbytes_, work)
    print(f"check {key} ({label}): differing bytes {n_diff}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b['bound_ms']:.4f} "
          f"ms ({b['bound_by']}); work {work}")
    assert n_diff == 0, f"{key} differs from its plain version"
    rows[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **b)
    return got


def check_layout_kernels(name, scene, cfg, cam, results):
    """Phase 21 (b): every kernel of the layout's library on the flagship
    of that layout against its plain version, 0 differing bytes: kernel
    A on the middle band's primaries; at the cluster layouts the binary
    walks (``trace2_warp`` on those primaries, ``trace2`` on the split
    engine's sorted bounce-1 round) and mega from bounce 0 (raster
    primaries); kernel B's 15 builds on the middle band's bounce-1 state
    sorted by the build's key, and on a merged-tail state with budgets
    0-3 (its packed form for the packed builds)."""
    from raytracer_tpu_torch.engine.renderer import _num_bands
    from raytracer_tpu_torch.kernels import bounce, mega, packet, trace

    layout = scene.layout
    _, _, ray_o, ray_d, alive, _ = band_primaries(scene, cfg, cam)
    rays = torch.stack([*ray_o, *ray_d]).contiguous()
    p = rays.shape[1]
    _check_kernel(f"{p} primaries", lambda: trace.trace4(scene, rays, alive,
                                                         cfg),
                  lambda: trace.trace4_plain(scene, rays, alive, cfg),
                  trace_bytes(scene, rays, "nodes4"), results,
                  layout_kernel("trace4", layout))
    if layout[1] == 8:
        _check_kernel(
            f"{p} primaries", lambda: trace.trace2(scene, rays, alive, cfg,
                                                   coherent=True),
            lambda: trace.trace2_plain(scene, rays, alive, cfg),
            trace_bytes(scene, rays, "nodes8"), results,
            layout_kernel("trace2_warp", layout))
        srays, sact = split_round1(scene, cfg, cam)
        _check_kernel(
            f"{p} split-round rays",
            lambda: trace.trace2(scene, srays, sact, cfg),
            lambda: trace.trace2_plain(scene, srays, sact, cfg),
            trace_bytes(scene, srays, "nodes8"), results,
            layout_kernel("trace2", layout))
        o, d, c, a, seed, alive0, pix = band_raster(scene, cfg, cam)
        n_out = cfg.height // _num_bands(cfg) * cfg.width
        args = (scene, o, d, c, a, seed, alive0, True, cfg, 0, pix, n_out)
        _check_kernel(
            f"{n_out} raster primaries from bounce 0",
            lambda: mega.mega(*args)[0],
            lambda: packet.megakernel_bounces(*args)[0],
            n_out * (12 * 4 + 4 + 1 + 4 + 3 * 4)
            + nbytes(scene.nodes8, scene.clusters, scene.cluster_counts),
            results, layout_kernel("mega", layout))

    states = {m: key_states(scene, cfg, cam, m) for m in ("cid", "pd5",
                                                           "om9")}
    tails = {k: tail_state(scene, cfg, cam, states["cid"][i], k)
             for i, k in enumerate(("bounce12", "bounce15"))}
    t15 = tails["bounce15"]
    tails["bounce_packed"] = (
        torch.cat([t15[0:12].view(torch.float32),
                   (t15[bounce.ROW_ALIVE] != 0).to(torch.float32)[None]]),
        t15[[bounce.ROW_SEED, bounce.ROW_PIX]].contiguous())
    tables = nbytes(scene.nodes4, scene.clusters)
    for base, (kernel, key_mode, ordered) in B_BUILDS.items():
        st12, st15, packed = states[key_mode]
        state = {"bounce12": st12, "bounce15": st15}.get(kernel, packed)
        key = bounce.build_name(kernel, key_mode, ordered, layout)

        def calls(st):
            if kernel == "bounce_packed":
                args = (scene, *st, 1, True, cfg, key_mode)
            else:
                args = (scene, st, 1, True, cfg, key_mode, ordered)
            return (lambda: getattr(bounce, kernel)(*args),
                    lambda: getattr(bounce, f"{kernel}_plain")(*args))

        sts = state if isinstance(state, tuple) else (state,)
        _check_kernel(f"sorted bounce-1 round of {p} rays", *calls(state),
                      2 * nbytes(*sts) + 4 * p + tables + 24, results, key)
        tail = tails[kernel]
        call, plain = calls(tail)
        n_tail = equal_outputs(call(), plain())
        packed = kernel == "bounce_packed"
        w = (tail[0] if packed else tail).shape[1]
        budgets = "(packed: no budget)" if packed else "with budgets 0-3"
        print(f"check {key} on a tail round of {w} rays {budgets}: "
              f"differing bytes {n_tail}")
        assert n_tail == 0, f"{key} differs on the tail state"


def layout_turns(scenes, cfg, cam) -> dict:
    """Phase 21 (c): kernel A on the middle band's primaries and kernel B
    on its sorted bounce-1 round, each layout of FULL_LAYOUTS in turns
    with the default (default, layout, layout, default): device ms (CUDA
    events, 10 launches each)."""
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import (UNIFORM_BUDGET, bounce12,
                                                    pack_state)
    from raytracer_tpu_torch.kernels.trace import trace4

    inputs = {}
    for name, scene in scenes.items():
        _, _, ray_o, ray_d, alive, _ = band_primaries(scene, cfg, cam)
        rays = torch.stack([*ray_o, *ray_d]).contiguous()
        o, d, color, atten, seed, live, pix = band_bounce1(scene, cfg, cam)
        atten = tuple(torch.where(live, a, c) for a, c in zip(atten, color))
        st = pack_state(o, d, atten, seed, live, UNIFORM_BUDGET, pix)
        st, _ = wavefront._sorted(st, wavefront._state_key(st, scene))
        inputs[name] = (scene, rays, alive, st)
    out = {}
    for name in FULL_LAYOUTS:
        turns = []
        for label in ("default", name, name, "default"):
            scene, rays, alive, st = inputs[label]
            a_ms = time_ms(lambda: trace4(scene, rays, alive, cfg), 10)
            b_ms = time_ms(lambda: bounce12(scene, st, 1, True, cfg), 10)
            turns.append((label, a_ms, b_ms))
        out[name] = turns
        print(f"layout {name} in turns with the default, kernel A / kernel "
              f"B ms on the middle band: " + ", ".join(
                  f"{lb} {a:.4f} / {b:.4f}" for lb, a, b in turns))
    return out


def run_layout_paths(scenes, cfg, cam) -> dict:
    """Phase 21 (c): each layout's flagship at full width through every
    path of LAYOUT_PATHS (the binary walks and mega at the cluster layouts
    only): 4 frames on the main path of FULL_LAYOUTS, 1 elsewhere, each
    after a warm frame, launch counts reset just before and read just
    after -> layout -> path -> run."""
    out = {}
    for name, scene in scenes.items():
        runs = out.setdefault(name, {})
        for label, (env, kernels) in LAYOUT_PATHS.items():
            if scene.layout[1] != 8 and any(k in LEAF_KERNELS
                                            for k in kernels):
                continue
            frames = 4 if label == "main" and name in FULL_LAYOUTS else 1
            run = run_path(
                f"layout {name} {label}", scene, cfg, cam, frames, env,
                tuple(layout_kernel(k, scene.layout) for k in kernels)
                + ("tonemap",))
            run.pop("image")
            run["launches_per_frame"] = {k: v / frames
                                         for k, v in run["counts"].items()}
            runs[label] = run
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import cuda_build, launches
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays
    from raytracer_tpu_torch.utils.png import write_png

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    cuda_build.library()
    t_nvcc = time.perf_counter() - t0
    print(f"build: kernels {', '.join(cuda_build.SOURCES)} (nvcc, one "
          f"process each) {t_nvcc:.1f} s")
    cfg = RenderConfig()
    scene = presets.flagship_scene()
    cam = default_camera(cfg.width, cfg.height)
    uni = cam.uniforms()
    cfg12 = RenderConfig(width=640, height=480, max_bounces=1,
                         shading="fixed_light")
    scene12 = build_fast_scene_from_arrays(*presets.c12_arrays())
    cam12 = presets.c12_camera(cfg12.width, cfg12.height)
    results = {}
    clock = [time.perf_counter()]

    def lap(phases: str) -> None:
        now = time.perf_counter()
        print(f"phases {phases} took {now - clock[0]:.1f} s")
        clock[0] = now

    check_tonemap(results)
    check_trace(scene, cfg, uni, results)
    check_front(scene, cfg, uni, results)
    check_bounce(scene, cfg, uni, results)
    check_trace2(scene, cfg, uni, (scene12, cfg12, cam12.uniforms()),
                 results)
    check_color_kernels(scene, cfg, uni, results)
    check_stack_limit()

    lap("1-3")

    # Phase 4: the main path at full size.
    main_run = run_path("main path", scene, cfg, cam, 16, {},
                        ("raygen", "trace4", "shade", "bounce12", "tonemap"))
    os.makedirs(os.path.join(REPO, "out"), exist_ok=True)
    write_png(os.path.join(REPO, "out", "chip_smoke.png"), main_run["image"])

    # Phase 5: a small frame, kernels against plain versions.
    cfg5 = RenderConfig(width=256, height=128, band_rays=16384)
    cam5 = default_camera(cfg5.width, cfg5.height).uniforms()
    acc_k, img_k, st_k = Renderer(cfg5).render(scene, cam5)
    launches.reset()
    with plain_versions():
        acc_p, img_p, st_p = Renderer(cfg5).render(scene, cam5)
    _sync()
    assert not launches.kernel and launches.plain["bounce12"] > 0
    n_px = int((img_k != img_p).any(-1).sum())
    lin_err = (acc_k - acc_p).abs().max().item()
    print(f"end to end 256x128 (2 bands, tail merge): u8 differing pixels "
          f"{n_px}, linear max abs diff {lin_err:.3g}, rays "
          f"{int(st_k['rays_traced'])} vs {int(st_p['rays_traced'])}")
    assert n_px <= TIE_FRACTION_MAX * cfg5.width * cfg5.height

    # Phase 6: pmega against the default path, in turns (two cycles of
    # default, pmega, pmega, default, 8 frames each: the host-bound frame
    # is noisy).
    pmega = {"RAYTPU_BOUNCE": "pmega"}
    turns = []
    for label, env in (("default", {}), ("pmega", pmega), ("pmega", pmega),
                       ("default", {})) * 2:
        kernels = ("trace4", "bounce15") if env else ("trace4", "bounce12")
        turns.append((label, run_path(f"A/B {label}", scene, cfg, cam, 8,
                                      env, kernels)))
    for label in ("default", "pmega"):
        fps = [r["fps"] for lb, r in turns if lb == label]
        print(f"A/B {label}: FPS {', '.join(f'{x:.3f}' for x in fps)} "
              f"(median {np.median(fps):.3f})")
    pmega_run = turns[1][1]

    # Phase 7: the other paths at full width.
    fused_run = run_path("fused", scene, cfg, cam, 4,
                         {"RAYTPU_WAVE": "fused"}, ("trace4", "bounce15"))
    packed_run = run_path("fused_packed", scene, cfg, cam, 4,
                          {"RAYTPU_WAVE": "fused_packed"},
                          ("trace4", "bounce_packed", "bounce15"))
    split_env = {"RAYTPU_WAVE": "split", "RAYTPU_TRAVERSE": "binary"}
    split_run = run_path("split+binary", scene, cfg, cam, 2, split_env,
                         ("trace2", "trace2_warp", "tonemap"), warm=0)
    c12_runs = {}
    for trav, walk in (("bvh4", "trace4"), ("binary", "trace2_warp")):
        c12_runs[walk] = run_path(
            f"C12 {trav}", scene12, cfg12, cam12, 16,
            {"RAYTPU_TRAVERSE": trav}, (walk, "tonemap"))
    write_png(os.path.join(REPO, "out", "chip_smoke_c12.png"),
              c12_runs["trace4"]["image"])
    assert np.array_equal(c12_runs["trace4"]["image"],
                          c12_runs["trace2_warp"]["image"])

    # Phase 8: a 256x128 frame per new path, kernels against plain.
    ties = int(TIE_FRACTION_MAX * cfg5.width * cfg5.height)
    for label, env, kernels, max_px in (
            ("pmega", pmega, ("trace4", "bounce15"), ties),
            ("fused", {"RAYTPU_WAVE": "fused"}, ("trace4", "bounce15"),
             ties),
            ("fused_packed", {"RAYTPU_WAVE": "fused_packed"},
             ("trace4", "bounce_packed", "bounce15"), ties),
            ("split+binary", split_env, ("trace2",), 0)):
        small_frame(label, scene, cfg5, cam5, env, kernels, max_px)
    cfg8 = RenderConfig(width=256, height=128, max_bounces=1,
                        shading="fixed_light")
    cam8 = presets.c12_camera(cfg8.width, cfg8.height).uniforms()
    for trav, walk in (("bvh4", "trace4"), ("binary", "trace2")):
        small_frame(f"C12 {trav}", scene12, cfg8, cam8,
                    {"RAYTPU_TRAVERSE": trav}, (walk,), 0)

    lap("4-8")

    # Phase 9: the five presets at their own widths.
    from raytracer_tpu_torch.scene.presets import ALL_PRESETS

    preset_runs = {name: run_preset(name, make)
                   for name, make in ALL_PRESETS.items()}
    lap("9")

    # Phases 10-12: chain against frames, the headless app, per-ray path.
    chain = check_chain(scene, cfg, cam)
    headless_run = check_headless()
    per_ray = check_per_ray()

    lap("10-12")

    # Phases 13-16: live edits on the card, the engine and the viewer.
    device_builds = check_device_builds(cfg, uni)
    drag_runs = run_drag(cfg)
    engine_run = check_engine(cfg)
    viewer_run = check_viewer(cfg)

    lap("13-16")

    # Phase 17: multi-GPU rendering, meshes against one device.
    mesh_run = check_mesh()
    mesh_launches = mesh_run["gloo"]

    lap("17")

    # Phase 18: the XLA render path: the mega kernel against its plain
    # version, the paths at full width in turns with the default, C12 with
    # RAYTPU_B0=mega against phase 7's image, 256x128 frames kernels
    # against plain versions.
    check_mega(scene, cfg, uni, results)
    xla_runs = run_xla_paths(scene, cfg, cam)
    c12_mega = run_path("C12 B0=mega", scene12, cfg12, cam12, 16,
                        {"RAYTPU_B0": "mega"}, ("trace2", "tonemap"))
    assert np.array_equal(c12_mega["image"], c12_runs["trace4"]["image"])
    for label, (env, _, plain) in XLA_PATHS.items():
        small_frame(label, scene, cfg5, cam5, env, plain,
                    ties if label == "b0_pwave" else 0)
    small_frame("C12 B0=mega", scene12, cfg8, cam8, {"RAYTPU_B0": "mega"},
                ("trace2",), 0)

    lap("18")

    # Phase 19: the host builds, kernels on each table, one frame each.
    host_builds = check_host_builds(cfg, cam)

    lap("19")

    # Phase 20: the sorted rounds' knobs: kernel B's key and walk-order
    # builds against their plain versions, kernel B under the five keys,
    # each knob's A/B value at full width, 256x128 frames kernels against
    # plain versions.
    check_key_builds(scene, cfg, uni, results)
    key_times = time_sort_keys(scene, cfg, uni)
    knob_runs = run_knob_paths(scene, cfg, cam)
    for label, (env, plain) in KNOB_FRAMES.items():
        small_frame(label, scene, cfg5, cam5, env, plain, 0)

    lap("20")

    # Phase 21: the table layouts: their libraries, every kernel of each
    # against its plain version on the flagship of that layout, the
    # 16-wide stack limit, kernels A and B in turns with the default,
    # every path at full width, 256x128 frames kernels against plain
    # versions, the two_humans drag at width 16.
    layout_build = build_layouts()
    scenes = {name: s for name, (s, _) in layout_scenes().items()}
    for lname, lscene in scenes.items():
        check_layout_kernels(lname, lscene, cfg, uni, results)
    check_stack_limit(width=16)
    layout_turn_ms = layout_turns(
        {"default": scene, **{n: scenes[n] for n in FULL_LAYOUTS}}, cfg, uni)
    layout_runs = run_layout_paths(scenes, cfg, cam)
    for lname, lscene in scenes.items():
        small_frame(f"layout {lname}", lscene, cfg5, cam5, {},
                    tuple(layout_kernel(k, lscene.layout)
                          for k in ("trace4", "bounce12")), 0)
    w16_drags = run_drag(cfg, frames=4, modes={
        "w16_instanced": ({"RAYTPU_DEVICE_BUILD": "instanced",
                           "RAYTPU_WIDE": "16"}, "instanced",
                          ("trace4_w16", "bounce12_w16", "tonemap")),
        "w16_refit": ({"RAYTPU_DEVICE_BUILD": "refit", "RAYTPU_WIDE": "16"},
                      "lbvh", ("trace2_warp", "trace2", "tonemap"))})
    assert w16_drags["w16_instanced"]["wide_table"]
    assert not w16_drags["w16_refit"]["wide_table"]
    lap("21")

    launches_on_path = {
        "trace4": main_run["counts"]["trace4"],
        "bounce12": main_run["counts"]["bounce12"],
        "tonemap": main_run["counts"]["tonemap"],
        "trace2": split_run["counts"]["trace2"],
        "trace2_warp": split_run["counts"]["trace2_warp"],
        "bounce15": pmega_run["counts"]["bounce15"],
        "bounce_packed": packed_run["counts"]["bounce_packed"],
        "mega": xla_runs["b0_mega"]["counts"]["mega"],
        "raygen": main_run["counts"]["raygen"],
        "shade": main_run["counts"]["shade"]}
    launches_on_path.update({k: knob_runs[run]["counts"][k]
                             for k, run in BUILD_RUNS.items()})
    srcs = {"tonemap": ("cuda", "raytracer_tpu_torch/csrc/tonemap.cu",
                        "raytracer_tpu/kernels/pallas_ops.py:25"),
            "trace4": ("cuda", "raytracer_tpu_torch/csrc/trace4.cu",
                       "raytracer_tpu/kernels/pallas_trace.py:266"),
            "bounce12": ("cuda", "raytracer_tpu_torch/csrc/bounce12.cu",
                         "raytracer_tpu/kernels/pallas_mega.py:131"),
            "trace2": ("cuda", "raytracer_tpu_torch/csrc/trace2.cu",
                       "raytracer_tpu/kernels/pallas_trace.py:66"),
            "trace2_warp": ("cuda", "raytracer_tpu_torch/csrc/trace2.cu",
                            "raytracer_tpu/kernels/pallas_trace.py:66"),
            "bounce15": ("cuda", "raytracer_tpu_torch/csrc/bounce12.cu",
                         "raytracer_tpu/kernels/pallas_mega.py:800"),
            "bounce_packed": ("cuda", "raytracer_tpu_torch/csrc/bounce12.cu",
                              "raytracer_tpu/kernels/pallas_mega.py:645"),
            "mega": ("cuda", "raytracer_tpu_torch/csrc/mega.cu",
                     "raytracer_tpu/kernels/packet.py:281"),
            "raygen": ("cuda", "raytracer_tpu_torch/csrc/front.cu",
                       "none: raytracer_tpu/kernels/tracer.py "
                       "initial_seed, make_primary_rays (plain ops)"),
            "shade": ("cuda", "raytracer_tpu_torch/csrc/front.cu",
                      "none: raytracer_tpu/kernels/tracer.py shade "
                      "(plain ops)")}
    srcs.update({k: ("cuda", src, rep)
                 for k, (_, _, _, src, rep) in KEY_BUILDS.items()})
    for k in srcs:
        # The bounce15 row is the pmega call: its persistent-warp kernel.
        attrs = cuda_build.kernel_attrs(
            {"bounce15": "bounce15_pmega"}.get(k, k))
        results[k].update({a: attrs.get(a) for a in cuda_build.ATTRS})
    # Phase 21's builds: each layout's kernels, launches from the first of
    # its paths that ran them.
    from raytracer_tpu_torch.kernels import bounce as bounce_mod

    for lname, lscene in scenes.items():
        lay = lscene.layout
        new = {layout_kernel("trace4", lay): (
            "raytracer_tpu_torch/csrc/trace4.cu",
            "raytracer_tpu/kernels/pallas_trace.py:266")}
        if lay[1] == 8:
            new.update({
                layout_kernel(k, lay): (
                    "raytracer_tpu_torch/csrc/trace2.cu",
                    "raytracer_tpu/kernels/pallas_trace.py:66")
                for k in ("trace2", "trace2_warp")})
            new[layout_kernel("mega", lay)] = (
                "raytracer_tpu_torch/csrc/mega.cu",
                "raytracer_tpu/kernels/packet.py:281")
        new.update({bounce_mod.build_name(k, key, ordered, lay): (
            B_SOURCES[key], B_REPLACES[k])
            for k, key, ordered in B_BUILDS.values()})
        for k, (src, rep) in new.items():
            srcs[k] = ("cuda", src, rep)
            launches_on_path[k] = next(
                run["counts"][k] for run in layout_runs[lname].values()
                if run["counts"].get(k))
            attrs = layout_build["attrs"][k]
            results[k].update({a: attrs.get(a) for a in cuda_build.ATTRS})
    paths = {"main": main_run, "pmega": pmega_run, "fused": fused_run,
             "fused_packed": packed_run, "split_binary": split_run,
             "c12_bvh4": c12_runs["trace4"],
             "c12_binary": c12_runs["trace2_warp"]}
    with open(os.path.join(REPO, "out", "chip_smoke_paths.json"), "w") as f:
        json.dump({"device": smi, "bounce15_fused": results["bounce15_fused"],
                   "paths": {k: {m: v for m, v in r.items() if m != "image"}
                             for k, r in paths.items()},
                   "ab": [(lb, {m: v for m, v in r.items() if m != "image"})
                          for lb, r in turns],
                   "presets": preset_runs, "chain": chain,
                   "headless": headless_run, "per_ray": per_ray,
                   "device_builds": device_builds, "drag": drag_runs,
                   "engine": engine_run, "viewer": viewer_run,
                   "ploc": {"device_build": device_builds["lbvh_ploc"],
                            "drag": drag_runs["lbvh_ploc"]},
                   "mesh": mesh_run,
                   "mega": results["mega"],
                   "xla_paths": {k: {m: v for m, v in r.items()
                                     if m != "image"}
                                 for k, r in xla_runs.items()},
                   "c12_b0_mega": {m: v for m, v in c12_mega.items()
                                   if m != "image"},
                   "host_builds": host_builds,
                   "key_builds": {k: results[k] for k in KEY_BUILDS},
                   "sort_key_times": key_times,
                   "knob_runs": knob_runs,
                   "layouts": {
                       "nvcc_s": layout_build["nvcc_s"],
                       "tables": {n: dict(layout=s.layout,
                                          nodes8_rows=s.nodes8.shape[0],
                                          nodes4_rows=s.nodes4.shape[0],
                                          wide_nodes=s.num_nodes4,
                                          cluster_rows=s.clusters.shape[0])
                                  for n, s in scenes.items()},
                       "kernels": {k: results[k] for k in results
                                   if k in srcs and k[-3:] in (
                                       "_c2", "_c4", "w16")},
                       "turns": layout_turn_ms, "runs": layout_runs,
                       "w16_drags": w16_drags}}, f, indent=1)
    # Launches per frame on this slice's paths: the PLOC drag and each
    # mesh (all ranks).
    new_paths = {"drag_lbvh_ploc": drag_runs["lbvh_ploc"][
        "launches_per_frame"]}
    new_paths.update({f"mesh_{shape}": mesh_launches[shape][
        "launches_per_frame"] for shape in ("2x1", "1x2", "2x2")})
    new_paths.update({f"xla_{label}": run["launches_per_frame"]
                      for label, run in xla_runs.items()})
    new_paths.update({f"knob_{label}": run["launches_per_frame"]
                      for label, run in knob_runs.items()})
    new_paths.update({f"layout_{lname}_{label}": run["launches_per_frame"]
                      for lname, runs in layout_runs.items()
                      for label, run in runs.items()})
    new_paths.update({f"drag_{mode}": run["launches_per_frame"]
                      for mode, run in w16_drags.items()})
    print(json.dumps({"kernels": [
        dict(name=k, route=route, source=src, replaces=rep,
             launches=launches_on_path[k], **results[k],
             path_launches_per_frame={
                 p: c[k] for p, c in new_paths.items() if k in c})
        for k, (route, src, rep) in srcs.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each (any failure raises and exits non-zero):

1. device: the card's name and its nvidia-smi name / power limit;
2. build: nvcc builds every kernel of ``raytracer_tpu_torch/csrc`` (one
   process per source, all at once) into ``raytracer_tpu_torch/_build``;
   Triton compiles the tonemap;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, with both times and the least time the card
   could take for the same work (``bound_ms``): the tonemap on a 1280x720
   frame; kernel A on the middle 720p band of flagship primaries (307,200
   rays); kernel B on that band's sorted bounce-1 state and on a
   merged-tail-width state with mixed bounce budgets (0 included); kernel
   5 (``trace2``) on the same primaries (0 differing lanes required), and
   ``trace2`` / kernel A with the normal flip off on the 640x480 C12
   primaries; the colour-carrying kernel (``bounce15``) on the sorted
   bounce-1 band state at bcap 1 (a ``fused`` round) and on the same state
   sorted by the pmega host key at bcap 9 (the pmega call); the packed
   kernel on the bounce-1 state as the ``fused_packed`` round sorts it;
   kernel A and kernel B on a hand-built 36-level tree whose walk pushes
   246 stack entries (``presets.stack_limit_scene``, need 253 of the
   256-slot stack), bit-equal;
4. the main path at full size: the flagship scene, ``Renderer`` with
   ``RenderConfig()`` (1280x720, 10 bounces), one warm frame, then 16
   progressive frames with the launch counts of every kernel; writes
   ``out/chip_smoke.png``;
5. one 256x128 frame (2 bands, cross-band tail merge) through the
   kernels and through the plain versions, compared;
6. ``RAYTPU_BOUNCE=pmega`` against the default path in turns (default,
   pmega, pmega, default, twice), 16 720p frames each;
7. the other paths at full width through ``Renderer``: ``fused`` and
   ``fused_packed`` (4 720p frames each), ``split`` with
   ``RAYTPU_TRAVERSE=binary`` (2 frames), and the C12 tier (``c12_cube``,
   640x480, 16 frames) walking the 8-wide and the binary table; writes
   ``out/chip_smoke_c12.png``;
8. a 256x128 frame per new path through the kernels and the plain
   versions, compared;

then a JSON line of per-kernel results (with each CUDA kernel's
registers, local and shared bytes and resident blocks per SM as the main
path launches it) and, last, the JSON result line.
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
# of an 8-wide node (pallas_trace.py:332-350), one run of the
# 19-comparator network (a visit that pushes two children or more), a
# binary node visit (one slab test), a Moller-Trumbore test of a live
# triangle (:436-451), a PCG draw with its u32 -> f32 conversion, and the
# rest of one ray's shade (sky, Lambert / metal directions, carry).
OPS = {"slots4": 33, "nets4": 19, "visits2": 25, "tris": 54, "draws": 12,
       "shades": 70}


def _sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs (CUDA events, after one
    warm-up run)."""
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
    from raytracer_tpu_torch.kernels.tonemap import (tonemap_accumulate,
                                                     tonemap_plain)

    g = torch.Generator(device="cuda").manual_seed(11)
    shape = (720, 1280, 3)
    accum = torch.rand(shape, generator=g, device="cuda") * 1.5
    sample = torch.rand(shape, generator=g, device="cuda") * 1.5
    fc = torch.tensor(5, dtype=torch.int32, device="cuda")
    ex = torch.tensor(0.5, device="cuda")
    acc_k, img_k = tonemap_accumulate(accum.clone(), sample, fc, ex)
    acc_p, img_p = tonemap_plain(accum.clone(), sample, fc, ex)
    _sync()
    du8 = (img_k.int() - img_p.int()).abs()
    equal = (du8 == 0).float().mean().item()
    ulp = (acc_k.view(torch.int32).long()
           - acc_p.view(torch.int32).long()).abs().max().item()
    err = (acc_k - acc_p).abs().max().item()
    scratch = accum.clone()
    ms = time_ms(lambda: tonemap_accumulate(scratch, sample, fc, ex), 50)
    plain_ms = time_ms(lambda: tonemap_plain(scratch, sample, fc, ex), 50)
    print(f"check tonemap 1280x720: u8 equal {equal * 100:.5f}% max u8 diff "
          f"{du8.max().item()} accum max ulp {ulp} max abs {err:.3g}; "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    assert equal >= 0.9999 and du8.max().item() <= 1 and ulp <= 2
    # Reads accum and sample, writes accum and the u8 frame.
    results["tonemap"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              **bound(nbytes(accum, sample, acc_k, img_k)))


def band_primaries(scene, cfg, cam):
    """The middle band of the frame (the one that sees the most of the
    scene): tile-major primaries exactly as
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
    yy = yy_local + (nb // 2) * band_h
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
    """Kernel A (or ``trace2``) vs plain on the same rays -> (kernel out,
    plain out, tie mask, max abs err outside ties, plain work)."""
    from raytracer_tpu_torch.kernels import trace

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
    plain_ms = time_ms(lambda: trace4_plain(scene, rays, alive, cfg), 1)
    print(f"check kernel A, {rays.shape[1]} primaries: t bit-equal, tie "
          f"lanes {n_tie}, max abs err outside ties {err:.3g}; kernel "
          f"{ms:.4f} ms plain {plain_ms:.2f} ms; work {work}")
    assert n_tie <= TIE_FRACTION_MAX * rays.shape[1] and err == 0.0
    results["trace4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(trace_bytes(scene, rays, "nodes4"),
                                     work))


def check_trace2(scene, cfg, cam, c12, results):
    """Kernel 5 on the flagship band primaries (flip on) and, with kernel
    A, on the C12 primaries (flip off): 0 differing lanes."""
    from raytracer_tpu_torch.kernels.trace import trace2, trace2_plain

    _, _, ray_o, ray_d, alive, _ = band_primaries(scene, cfg, cam)
    rays = torch.stack([*ray_o, *ray_d]).contiguous()
    _, _, ties, err, work = compare_trace(scene, rays, alive, cfg, "trace2")
    ms = time_ms(lambda: trace2(scene, rays, alive, cfg), 10)
    plain_ms = time_ms(lambda: trace2_plain(scene, rays, alive, cfg), 1)
    print(f"check trace2, {rays.shape[1]} primaries (flip on): differing "
          f"lanes {int(ties.sum())}; kernel {ms:.4f} ms plain "
          f"{plain_ms:.2f} ms; work {work}")
    assert not ties.any() and err == 0.0
    results["trace2"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(trace_bytes(scene, rays, "nodes8"),
                                     work))

    scene12, cfg12, cam12 = c12
    _, _, ray_o, ray_d, alive, _ = band_primaries(scene12, cfg12, cam12)
    rays = torch.stack([*ray_o, *ray_d]).contiguous()
    for name in ("trace2", "trace4"):
        _, _, ties, err, _ = compare_trace(scene12, rays, alive, cfg12, name)
        print(f"check {name}, {rays.shape[1]} C12 primaries (flip off): "
              f"differing lanes {int(ties.sum())}")
        assert not ties.any() and err == 0.0


def band_bounce1(scene, cfg, cam):
    """The middle band after bounce 0 (kernel A + shade): (ray_o, ray_d,
    color, atten, seed, alive, pix)."""
    from raytracer_tpu_torch.kernels.trace import traverse
    from raytracer_tpu_torch.kernels.tracer import shade

    _, seed, ray_o, ray_d, alive, pix = band_primaries(scene, cfg, cam)
    p = alive.shape[0]
    zero = torch.zeros(p, device="cuda")
    one = torch.ones(p, device="cuda")
    res = traverse(scene, ray_o, ray_d, alive, cfg)
    o, d, color, atten, seed, alive = shade(
        res, ray_o, ray_d, (zero,) * 3, (one,) * 3, seed, alive, True, cfg)
    return o, d, color, atten, seed, alive, pix


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
                       1)
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


def check_stack_limit():
    """Kernels A and B on a tree close to the deepest the stack takes
    (need 253 of 256 slots): bit-equal to the plain versions in every
    lane."""
    from raytracer_tpu_torch.bvh.bvh4 import nodes4_stack_need
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import (bounce12,
                                                    bounce12_plain,
                                                    pack_state)
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain
    from raytracer_tpu_torch.scene import presets

    n = 16384
    scene, rays = presets.stack_limit_scene(n)
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
    print(f"check stack limit ({scene.num_nodes4} wide nodes, need "
          f"{nodes4_stack_need(scene.nodes4.cpu().numpy())}, plain walk "
          f"reached {work['stack4_max']}), "
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
    smin, smax = scene.bounds()
    order = torch.argsort(wavefront.sort_key(o, d, alive, smin, smax),
                          stable=True)
    pmega = flat.index_select(1, order)
    rows = {}
    for label, state, bcap in (("fused round", fused, 1),
                               ("pmega call", pmega, cfg.max_bounces - 1)):
        got = bounce15(scene, state, bcap, True, cfg)
        want, work = plain_work(
            lambda: bounce15_plain(scene, state, bcap, True, cfg))
        n_diff, err = compare_outputs(got, want, walk_ties(state), label)
        ms = time_ms(lambda: bounce15(scene, state, bcap, True, cfg), 10)
        plain_ms = time_ms(
            lambda: bounce15_plain(scene, state, bcap, True, cfg), 1)
        print(f"check bounce15 bcap {bcap} ({label}, {p} rays): rays/live "
              f"{got[2].tolist()}, differing lanes {n_diff}, max abs err "
              f"{err:.3g}; kernel {ms:.4f} ms plain {plain_ms:.2f} ms; "
              f"work {work}")
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           **bound(2 * nbytes(state) + 4 * p + tables,
                                   work))
    # The pmega call is the kernel's main use: its row goes in the table.
    results["bounce15"] = rows["pmega call"]
    results["bounce15_fused"] = rows["fused round"]

    sf = torch.stack([*o, *d, *color, *atten, alive.to(torch.float32)])
    si = torch.stack([seed.to(torch.int32), pix])
    (sf, si), _ = wavefront._sorted((sf, si),
                                    wavefront._state_key((sf, si), scene))
    got = bounce_packed(scene, sf, si, 1, True, cfg)
    want, work = plain_work(
        lambda: bounce_packed_plain(scene, sf, si, 1, True, cfg))
    rays = sf[0:6].contiguous()
    ties = compare_trace(scene, rays, sf[12] > 0.5, cfg)[2]
    n_diff, err = compare_outputs(got, want, ties, "packed round")
    ms = time_ms(lambda: bounce_packed(scene, sf, si, 1, True, cfg), 10)
    plain_ms = time_ms(
        lambda: bounce_packed_plain(scene, sf, si, 1, True, cfg), 1)
    print(f"check bounce_packed bcap 1 (fused_packed round, {p} rays): "
          f"rays/live {got[3].tolist()}, differing lanes {n_diff}, max abs "
          f"err {err:.3g}; kernel {ms:.4f} ms plain {plain_ms:.2f} ms")
    results["bounce_packed"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(2 * nbytes(sf, si) + 4 * p + tables, work))


@contextlib.contextmanager
def plain_versions():
    """Route the render modules to the plain versions."""
    from raytracer_tpu_torch.engine import renderer
    from raytracer_tpu_torch.kernels import (bounce, packet, tonemap, trace,
                                             wavefront)

    slots = [(trace, "trace4", trace.trace4_plain),
             (trace, "trace2", trace.trace2_plain),
             (wavefront, "bounce12", bounce.bounce12_plain),
             (wavefront, "bounce15", bounce.bounce15_plain),
             (wavefront, "bounce_packed", bounce.bounce_packed_plain),
             (packet, "bounce15", bounce.bounce15_plain),
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import cuda_build, launches
    from raytracer_tpu_torch.kernels.tonemap import tonemap_accumulate
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
    t0 = time.perf_counter()
    x = torch.zeros((8, 8, 3), device="cuda")
    tonemap_accumulate(x, x.clone(), 0, 0.0)
    _sync()
    t_triton = time.perf_counter() - t0
    print(f"build: kernels {', '.join(cuda_build.SOURCES)} (nvcc, one "
          f"process each) {t_nvcc:.1f} s, tonemap (triton) {t_triton:.1f} s")

    cfg = RenderConfig()
    scene = presets.flagship_scene()
    cam = default_camera(cfg.width, cfg.height)
    uni = cam.uniforms()
    cfg12 = RenderConfig(width=640, height=480, max_bounces=1,
                         shading="fixed_light")
    scene12 = build_fast_scene_from_arrays(*presets.c12_arrays())
    cam12 = presets.c12_camera(cfg12.width, cfg12.height)
    results = {}
    check_tonemap(results)
    check_trace(scene, cfg, uni, results)
    check_bounce(scene, cfg, uni, results)
    check_trace2(scene, cfg, uni, (scene12, cfg12, cam12.uniforms()),
                 results)
    check_color_kernels(scene, cfg, uni, results)
    check_stack_limit()

    # Phase 4: the main path at full size.
    main_run = run_path("main path", scene, cfg, cam, 16, {},
                        ("trace4", "bounce12", "tonemap"))
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
    # default, pmega, pmega, default: the host-bound frame is noisy).
    pmega = {"RAYTPU_BOUNCE": "pmega"}
    turns = []
    for label, env in (("default", {}), ("pmega", pmega), ("pmega", pmega),
                       ("default", {})) * 2:
        kernels = ("trace4", "bounce15") if env else ("trace4", "bounce12")
        turns.append((label, run_path(f"A/B {label}", scene, cfg, cam, 16,
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
                         ("trace2", "tonemap"), warm=0)
    c12_runs = {}
    for trav, walk in (("bvh4", "trace4"), ("binary", "trace2")):
        c12_runs[walk] = run_path(
            f"C12 {trav}", scene12, cfg12, cam12, 16,
            {"RAYTPU_TRAVERSE": trav}, (walk, "tonemap"))
    write_png(os.path.join(REPO, "out", "chip_smoke_c12.png"),
              c12_runs["trace4"]["image"])
    assert np.array_equal(c12_runs["trace4"]["image"],
                          c12_runs["trace2"]["image"])

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

    launches_on_path = {
        "trace4": main_run["counts"]["trace4"],
        "bounce12": main_run["counts"]["bounce12"],
        "tonemap": main_run["counts"]["tonemap"],
        "trace2": split_run["counts"]["trace2"],
        "bounce15": pmega_run["counts"]["bounce15"],
        "bounce_packed": packed_run["counts"]["bounce_packed"]}
    srcs = {"tonemap": ("triton", "raytracer_tpu_torch/kernels/tonemap.py",
                        "raytracer_tpu/kernels/pallas_ops.py:25"),
            "trace4": ("cuda", "raytracer_tpu_torch/csrc/trace4.cu",
                       "raytracer_tpu/kernels/pallas_trace.py:266"),
            "bounce12": ("cuda", "raytracer_tpu_torch/csrc/bounce12.cu",
                         "raytracer_tpu/kernels/pallas_mega.py:131"),
            "trace2": ("cuda", "raytracer_tpu_torch/csrc/trace2.cu",
                       "raytracer_tpu/kernels/pallas_trace.py:66"),
            "bounce15": ("cuda", "raytracer_tpu_torch/csrc/bounce12.cu",
                         "raytracer_tpu/kernels/pallas_mega.py:800"),
            "bounce_packed": ("cuda", "raytracer_tpu_torch/csrc/bounce12.cu",
                              "raytracer_tpu/kernels/pallas_mega.py:645")}
    for k, (route, _, _) in srcs.items():
        attrs = cuda_build.kernel_attrs(k) if route == "cuda" else {}
        results[k].update({a: attrs.get(a) for a in cuda_build.ATTRS})
    paths = {"main": main_run, "pmega": pmega_run, "fused": fused_run,
             "fused_packed": packed_run, "split_binary": split_run,
             "c12_bvh4": c12_runs["trace4"], "c12_binary": c12_runs["trace2"]}
    with open(os.path.join(REPO, "out", "chip_smoke_paths.json"), "w") as f:
        json.dump({"device": smi, "bounce15_fused": results["bounce15_fused"],
                   "paths": {k: {m: v for m, v in r.items() if m != "image"}
                             for k, r in paths.items()},
                   "ab": [(lb, {m: v for m, v in r.items() if m != "image"})
                          for lb, r in turns]}, f, indent=1)
    print(json.dumps({"kernels": [
        dict(name=k, route=route, source=src, replaces=rep,
             launches=launches_on_path[k], **results[k])
        for k, (route, src, rep) in srcs.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device: the card's name and its nvidia-smi name / power limit;
2. build: nvcc builds kernels A and B from ``raytracer_tpu_torch/csrc``
   into ``raytracer_tpu_torch/_build``; Triton compiles the tonemap;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: the tonemap on a 1280x720 frame, kernel
   A on the middle 720p band of flagship primaries (307,200 rays), kernel B on
   that band's sorted bounce-1 state and on a merged-tail-width state
   with mixed bounce budgets (0 included), with both times;
4. the main path at full size: the flagship scene, ``Renderer`` with
   ``RenderConfig()`` (1280x720, 10 bounces), one warm frame, then 16
   progressive frames with the launch counts of every kernel; writes
   ``out/chip_smoke.png``;
5. one 256x128 frame (2 bands, cross-band tail merge) through the
   kernels and through the plain versions, compared;

then a JSON line of per-kernel results and, last, the JSON result line.
Imports nothing of JAX.
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
    results["tonemap"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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
                                           cfg.height)
    pix = torch.where(alive, yy_local * cfg.width + xx, p).to(torch.int32)
    return bcfg, seed, ray_o, ray_d, alive, pix


def compare_trace(scene, rays, active, cfg):
    """Kernel A vs plain on the same rays -> (kernel out, plain out, tie
    mask, max abs err outside ties)."""
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain

    out_k = trace4(scene, rays, active, cfg)
    out_p = trace4_plain(scene, rays, active, cfg)
    _sync()
    assert torch.equal(out_k[0], out_p[0]), "kernel A t differs from plain"
    ties = (out_k != out_p).any(0)
    err = (out_k - out_p)[:, ~ties].abs().max().item() if (~ties).any() \
        else 0.0
    return out_k, out_p, ties, err


def check_trace(scene, cfg, cam, results):
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain

    _, _, ray_o, ray_d, alive, _ = band_primaries(scene, cfg, cam)
    rays = torch.stack([*ray_o, *ray_d]).contiguous()
    _, _, ties, err = compare_trace(scene, rays, alive, cfg)
    n_tie = int(ties.sum())
    ms = time_ms(lambda: trace4(scene, rays, alive, cfg), 10)
    plain_ms = time_ms(lambda: trace4_plain(scene, rays, alive, cfg), 1)
    print(f"check kernel A, {rays.shape[1]} primaries: t bit-equal, tie "
          f"lanes {n_tie}, max abs err outside ties {err:.3g}; kernel "
          f"{ms:.4f} ms plain {plain_ms:.2f} ms")
    assert n_tie <= TIE_FRACTION_MAX * rays.shape[1] and err == 0.0
    results["trace4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def compare_bounce(scene, state, cfg, label):
    """Kernel B vs plain on one state; lanes may differ only where kernel
    A's walk of the same rays is an equal-t tie."""
    from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, bounce12,
                                                    bounce12_plain)

    out_k, key_k, cnt_k = bounce12(scene, state, 1, True, cfg)
    out_p, key_p, cnt_p = bounce12_plain(scene, state, 1, True, cfg)
    _sync()
    fk, fp = out_k[0:9].view(torch.float32), out_p[0:9].view(torch.float32)
    diff = ((out_k[9:] != out_p[9:]).any(0) | (key_k != key_p)
            | ((fk - fp).abs() > 2e-5).any(0))
    rays = state[0:6].view(torch.float32).contiguous()
    _, _, ties, _ = compare_trace(scene, rays, state[ROW_ALIVE] != 0, cfg)
    assert not (diff & ~ties).any(), (
        f"kernel B differs from plain outside tie lanes ({label})")
    assert torch.equal(cnt_k, cnt_p) or bool(ties.any()), (cnt_k, cnt_p)
    keep = ~diff
    err = (fk - fp)[:, keep].abs().max().item() if keep.any() else 0.0
    return int(diff.sum()), int(ties.sum()), err, cnt_k.tolist()


def check_bounce(scene, cfg, cam, results):
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                    UNIFORM_BUDGET, bounce12,
                                                    bounce12_plain,
                                                    pack_state)
    from raytracer_tpu_torch.kernels.packet import tail_merge_widths
    from raytracer_tpu_torch.kernels.trace import traverse
    from raytracer_tpu_torch.kernels.tracer import shade

    bcfg, seed, ray_o, ray_d, alive, pix = band_primaries(scene, cfg, cam)
    p = alive.shape[0]
    zero = torch.zeros(p, device="cuda")
    one = torch.ones(p, device="cuda")
    res = traverse(scene, ray_o, ray_d, alive, cfg)
    o, d, color, atten, seed, alive = shade(
        res, ray_o, ray_d, (zero,) * 3, (one,) * 3, seed, alive, True, cfg)
    atten = tuple(torch.where(alive, a, c) for a, c in zip(atten, color))
    state = pack_state(o, d, atten, seed, alive, UNIFORM_BUDGET, pix)
    state, _ = wavefront._sorted(state, wavefront._state_key(state, scene))

    n_diff, n_tie, err, cnt = compare_bounce(scene, state, cfg, "round")
    ms = time_ms(lambda: bounce12(scene, state, 1, True, cfg), 10)
    plain_ms = time_ms(lambda: bounce12_plain(scene, state, 1, True, cfg),
                       1)
    print(f"check kernel B, sorted bounce-1 round of {p} rays: rays/live "
          f"{cnt}, differing lanes {n_diff} (walk tie lanes {n_tie}), max "
          f"abs err {err:.3g}; kernel {ms:.4f} ms plain {plain_ms:.2f} ms")

    # Tail round: the merged width, alive rays with budgets 0..3.
    out, key, _ = bounce12(scene, state, 1, True, cfg)
    out, _ = wavefront._sorted(out, key)
    merged = tail_merge_widths(cfg, bcfg.height, cfg.height // bcfg.height)
    w = merged[1] if merged[1] <= p else p
    tail = out[:, :w].contiguous()
    g = torch.Generator(device="cuda").manual_seed(5)
    tail[ROW_BUDGET] = torch.randint(0, 4, (w,), generator=g, device="cuda",
                                     dtype=torch.int32)
    n_diff2, n_tie2, err2, cnt2 = compare_bounce(scene, tail, cfg, "tail")
    n_zero = int(((tail[ROW_BUDGET] == 0) & (tail[ROW_ALIVE] != 0)).sum())
    print(f"check kernel B, tail round of {w} rays with budgets 0-3 "
          f"({n_zero} alive at budget 0): rays/live {cnt2}, differing lanes "
          f"{n_diff2} (walk tie lanes {n_tie2}), max abs err {err2:.3g}")
    results["bounce12"] = dict(max_abs_err=max(err, err2), ms=ms,
                               plain_ms=plain_ms)


@contextlib.contextmanager
def plain_versions():
    """Route the render modules to the plain versions (phase 5 only)."""
    from raytracer_tpu_torch.engine import renderer
    from raytracer_tpu_torch.kernels import bounce, tonemap, trace, wavefront

    saved = (trace.trace4, wavefront.bounce12, renderer.tonemap_accumulate)
    trace.trace4 = trace.trace4_plain
    wavefront.bounce12 = bounce.bounce12_plain
    renderer.tonemap_accumulate = tonemap.tonemap_plain
    try:
        yield
    finally:
        (trace.trace4, wavefront.bounce12,
         renderer.tonemap_accumulate) = saved


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import cuda_build, launches
    from raytracer_tpu_torch.kernels.tonemap import tonemap_accumulate
    from raytracer_tpu_torch.scene.presets import flagship_scene
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
    print(f"build: kernels A+B (nvcc) {t_nvcc:.1f} s, tonemap (triton) "
          f"{t_triton:.1f} s")

    cfg = RenderConfig()
    scene = flagship_scene("cuda")
    cam = default_camera(cfg.width, cfg.height)
    uni = cam.uniforms(device="cuda")
    results = {}
    check_tonemap(results)
    check_trace(scene, cfg, uni, results)
    check_bounce(scene, cfg, uni, results)

    # Phase 4: the main path at full size.
    r = Renderer(cfg)
    accum, image, _ = r.render(scene, uni)
    _sync()
    launches.reset()
    rays = 0
    frames = 16
    frame_ms = []
    t0 = time.perf_counter()
    for fc in range(1, frames + 1):
        t1 = time.perf_counter()
        cam.frame_count = fc
        accum, image, stats = r.render(scene, cam.uniforms(device="cuda"),
                                       accum)
        rays = rays + stats["rays_traced"]
        _sync()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
    dt = time.perf_counter() - t0
    counts, plain_counts = dict(launches.kernel), dict(launches.plain)
    img = image.cpu().numpy()
    assert bool(torch.isfinite(accum).all()), "non-finite accumulator"
    assert img.min() != img.max(), "image is one value"
    mrays = float(rays) / dt / 1e6
    print(f"main path 1280x720, 10 bounces, {frames} frames: "
          f"{frames / dt:.3f} FPS, {dt / frames * 1e3:.2f} ms/frame "
          f"(median {np.median(frame_ms):.2f}, max {max(frame_ms):.2f}), "
          f"{mrays:.2f} Mrays/s; kernel launches {counts}, plain calls "
          f"{plain_counts}; image mean {img.mean():.3f}")
    for k in ("trace4", "bounce12", "tonemap"):
        assert counts.get(k, 0) > 0, f"{k} never launched on the main path"
    assert not plain_counts, "plain versions ran on the main path"
    os.makedirs(os.path.join(REPO, "out"), exist_ok=True)
    write_png(os.path.join(REPO, "out", "chip_smoke.png"), img)

    # Phase 5: a small frame, kernels against plain versions.
    cfg5 = RenderConfig(width=256, height=128, band_rays=16384)
    cam5 = default_camera(cfg5.width, cfg5.height).uniforms(device="cuda")
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

    srcs = {"trace4": ("cuda", "raytracer_tpu_torch/csrc/trace4.cu",
                       "raytracer_tpu/kernels/pallas_trace.py:266"),
            "bounce12": ("cuda", "raytracer_tpu_torch/csrc/bounce12.cu",
                         "raytracer_tpu/kernels/pallas_mega.py:131"),
            "tonemap": ("triton", "raytracer_tpu_torch/kernels/tonemap.py",
                        "raytracer_tpu/kernels/pallas_ops.py:25")}
    print(json.dumps({"kernels": [
        dict(name=k, route=route, source=src, replaces=rep,
             launches=counts[k], **results[k])
        for k, (route, src, rep) in srcs.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

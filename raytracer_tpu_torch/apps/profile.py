"""Where a frame's time goes on the card, per bounce path.

    python -m raytracer_tpu_torch.apps.profile --paths default,pmega \\
        --frames 3 --rounds 2
    python -m raytracer_tpu_torch.apps.profile --mesh 2x1,1x2 --spp 2

For each path (a set of knobs, see ``raytracer_tpu_torch/knobs.py``) on
the flagship scene at ``RenderConfig()``: a few warm frames, then
``--frames`` frames under ``torch.profiler`` (CPU and CUDA activities).
Prints one JSON line per path and round: wall ms per frame, device busy ms
per frame (the union of kernel and copy intervals), the device idle share
of the profiled span, kernel launches per frame, the eight kernels with
the most device time, and the device time of each of the port's own
kernels (the CUDA kernels of ``csrc/``, the tonemap included). Paths
run in turns, ``--rounds`` times, so two paths are compared on one card
within one call. Needs a CUDA device.

With ``--mesh``, each (dp, sp) mesh renders the default path at
``--spp`` (each mesh's sp by default) through ``parallel/sharding.launch``,
one rank a card (NCCL: needs dp * sp cards), after the one-device frame
at the same spp on cuda:0. Every rank profiles its frames and reports, on
top of the fields above, its collectives' device time (the NCCL kernels)
and host time (the ``c10d::`` calls) per frame and its peak device
memory, so a mesh frame's time splits into the rank's own launches and
its collectives.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import torch

from raytracer_tpu_torch.core.camera import default_camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.parallel.sharding import MeshRenderer, launch
from raytracer_tpu_torch.scene.presets import flagship_scene

PATHS = {
    "default": {},
    "pmega": {"RAYTPU_BOUNCE": "pmega"},
    "fused": {"RAYTPU_WAVE": "fused"},
    "fused_packed": {"RAYTPU_WAVE": "fused_packed"},
    "split_binary": {"RAYTPU_WAVE": "split", "RAYTPU_TRAVERSE": "binary"},
    "bounce_mega": {"RAYTPU_BOUNCE": "mega"},
    "b0_mega": {"RAYTPU_B0": "mega"},
    "b0_packet": {"RAYTPU_B0": "packet"},
    "b0_pwave": {"RAYTPU_B0": "pwave"},
    # The sorted rounds' A/B values (the JAX package's).
    "sort_key_pd5": {"RAYTPU_SORT_KEY": "pd5"},
    "sort_key_om9": {"RAYTPU_SORT_KEY": "om9"},
    "sort_key_pos": {"RAYTPU_SORT_KEY": "pos"},
    "tail_merge_off": {"RAYTPU_TAIL_MERGE": "0"},
    "glue_pair": {"RAYTPU_GLUE": "pack"},
    "deposit_ch": {"RAYTPU_DEPOSIT": "ch"},
    "deposit_rows": {"RAYTPU_DEPOSIT": "rows"},
    "wave_minw_2048": {"RAYTPU_WAVE_MINW": "2048"},
    "wave_bcap_2": {"RAYTPU_WAVE_BCAP": "2"},
    "tail_bcap_3": {"RAYTPU_TAIL_BCAP": "3"},
    "order_minw_65536": {"RAYTPU_ORDER_MINW": "65536"},
    "deep_sub_32": {"RAYTPU_DEEP_SUB": "32"},
}


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_path(scene, cfg, env: dict, frames: int, warm: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cam = default_camera(cfg.width, cfg.height)
        r = Renderer(cfg)
        accum = None
        for f in range(warm):
            cam.frame_count = f
            accum, _, _ = r.render(scene, cam.uniforms(), accum)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in range(warm, warm + frames):
                cam.frame_count = f
                accum, _, _ = r.render(scene, cam.uniforms(), accum)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return _frame_stats(prof, wall, frames)


def _frame_stats(prof, wall: float, frames: int) -> dict:
    """Per-frame figures of a profiled run of ``frames`` frames that took
    ``wall`` seconds."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)
            if intervals else 0.0)
    busy = _busy_us(intervals)
    # Summed by the first 60 characters of the name, so the kernels of one
    # template (PyTorch's elementwise kernels) count as one entry.
    by_name: dict = {}
    for e in dev:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # The port's kernels: csrc/ defines them in anonymous namespaces and
    # kernel B's builds in namespace rtb (csrc/bounce.cuh).
    port = {n: t for n, t in by_name.items()
            if "(anonymous namespace)::" in n or "rtb::" in n}
    return {"wall_ms_per_frame": wall / frames * 1e3,
            "device_busy_ms_per_frame": busy / frames / 1e3,
            "device_idle_share": 1.0 - busy / span if span else None,
            "device_launches_per_frame": len(dev) / frames,
            "top_kernels_ms_per_frame": {
                n: t / frames / 1e3 for n, t in top},
            "port_kernels_ms_per_frame": {
                n: t / frames / 1e3 for n, t in port.items()}}


def _mesh_rank(spp: int, frames: int, warm: int, mesh) -> dict:
    """One rank of a profiled mesh: the flagship's default path on this
    rank's rows and samples -> its per-frame figures."""
    from torch.profiler import ProfilerActivity, profile

    cfg = RenderConfig(samples_per_pixel=spp)
    r = MeshRenderer(cfg, mesh)
    scene = r.prepare_scene(flagship_scene())
    cam = default_camera(cfg.width, cfg.height)
    accum = None
    for f in range(warm):
        cam.frame_count = f
        accum, _, _ = r.render(scene, cam.uniforms(device=mesh.device),
                               accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(warm, warm + frames):
            cam.frame_count = f
            accum, _, _ = r.render(scene, cam.uniforms(device=mesh.device),
                                   accum)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = _frame_stats(prof, wall, frames)
    # The NCCL kernels alone: each also shows as an "nccl:<op>" range.
    coll_dev = sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name.startswith("ncclDevKernel"))
    coll_host = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("c10d::"))
    res.update(rank=mesh.rank,
               collective_device_ms_per_frame=coll_dev / frames / 1e3,
               collective_host_ms_per_frame=coll_host / frames / 1e3,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    return res


def profile_mesh(spec: str, spp: int, frames: int, warm: int) -> list:
    """The one-device frame at the mesh's spp on cuda:0, then every rank
    of the ``DPxSP`` mesh -> JSON-ready rows."""
    dp, sp = (int(x) for x in spec.split("x"))
    spp = spp or sp
    cfg = RenderConfig(samples_per_pixel=spp)
    torch.cuda.reset_peak_memory_stats()
    one = profile_path(flagship_scene(), cfg, {}, frames, warm)
    one["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run = launch(functools.partial(_mesh_rank, spp, frames, warm),
                 dp * sp, sp, timeout=900)
    rows = [{"mesh": "one device", "spp": spp, **one}]
    rows += [{"mesh": spec, "spp": spp, "backend": run.backend, **res}
             for res in run.results]
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch.apps.profile",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--paths", default="default,pmega",
                   help=f"comma-separated, of {', '.join(PATHS)}")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--warm", type=int, default=2)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--mesh", default="",
                   help="comma-separated DPxSP meshes (e.g. 2x1,1x2), one "
                        "card a rank, in place of --paths")
    p.add_argument("--spp", type=int, default=0,
                   help="samples per pixel of --mesh (default: its sp)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    device = torch.cuda.get_device_name(0)
    if args.mesh:
        for spec in args.mesh.split(","):
            for row in profile_mesh(spec, args.spp, args.frames, args.warm):
                print(json.dumps({**row, "device": device}), flush=True)
        return 0
    names = args.paths.split(",")
    for n in names:
        if n not in PATHS:
            p.error(f"unknown path {n}")
    cfg = RenderConfig()
    scene = flagship_scene()
    for rnd in range(args.rounds):
        for n in names:
            res = profile_path(scene, cfg, PATHS[n], args.frames, args.warm)
            print(json.dumps({"path": n, "round": rnd, "device": device,
                              **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

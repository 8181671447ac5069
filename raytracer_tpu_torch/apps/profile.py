"""Where a frame's time goes on the card, per bounce path.

    python -m raytracer_tpu_torch.apps.profile --paths default,pmega \\
        --frames 3 --rounds 2

For each path (a set of knobs, see ``raytracer_tpu_torch/knobs.py``) on
the flagship scene at ``RenderConfig()``: a few warm frames, then
``--frames`` frames under ``torch.profiler`` (CPU and CUDA activities).
Prints one JSON line per path and round: wall ms per frame, device busy ms
per frame (the union of kernel and copy intervals), the device idle share
of the profiled span, kernel launches per frame, and the five kernels with
the most device time. Paths run in turns, ``--rounds`` times, so two paths
are compared on one card within one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from raytracer_tpu_torch.core.camera import default_camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.scene.presets import flagship_scene

PATHS = {
    "default": {},
    "pmega": {"RAYTPU_BOUNCE": "pmega"},
    "fused": {"RAYTPU_WAVE": "fused"},
    "fused_packed": {"RAYTPU_WAVE": "fused_packed"},
    "split_binary": {"RAYTPU_WAVE": "split", "RAYTPU_TRAVERSE": "binary"},
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms_per_frame": wall / frames * 1e3,
            "device_busy_ms_per_frame": busy / frames / 1e3,
            "device_idle_share": 1.0 - busy / span if span else None,
            "device_launches_per_frame": len(dev) / frames,
            "top_kernels_ms_per_frame": {
                n: t / frames / 1e3 for n, t in top}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch.apps.profile",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--paths", default="default,pmega",
                   help=f"comma-separated, of {', '.join(PATHS)}")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--warm", type=int, default=2)
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    names = args.paths.split(",")
    for n in names:
        if n not in PATHS:
            p.error(f"unknown path {n}")
    cfg = RenderConfig()
    scene = flagship_scene()
    for rnd in range(args.rounds):
        for n in names:
            res = profile_path(scene, cfg, PATHS[n], args.frames, args.warm)
            print(json.dumps({"path": n, "round": rnd,
                              "device": torch.cuda.get_device_name(0),
                              **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Headless renderer CLI on the GPU: flagship scene -> frames -> PNG.

    python -m raytracer_tpu_torch.apps.headless --flagship -o out.png \\
        --width 1280 --height 720 --frames 16 --stats-json

Renders on ``cuda`` and raises when there is no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from raytracer_tpu_torch.core.camera import default_camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.scene.presets import flagship_scene
from raytracer_tpu_torch.utils.png import write_png


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_tpu_torch.apps.headless",
        description="GPU path tracer, headless: render a scene to PNG.")
    p.add_argument("--flagship", action="store_true", required=True,
                   help="the ~50k-triangle flagship scene")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=16,
                   help="accumulation frames (progressive samples)")
    p.add_argument("--max-bounces", type=int, default=10)
    p.add_argument("--exposure", type=float, default=0.0, help="stops")
    p.add_argument("--no-sky", action="store_true")
    p.add_argument("--assets", action="append", default=[],
                   help="directory to search for FinalBaseMesh.obj")
    p.add_argument("--stats-json", action="store_true",
                   help="print a stats JSON line at the end")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.frames < 1:
        build_parser().error("--frames must be >= 1")
    if not torch.cuda.is_available():
        raise RuntimeError("the headless renderer needs a CUDA device")
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.max_bounces)
    t0 = time.perf_counter()
    scene = flagship_scene("cuda", search=args.assets)
    build_ms = (time.perf_counter() - t0) * 1e3

    cam = default_camera(args.width, args.height)
    renderer = Renderer(cfg)
    accum = None
    rays = 0
    t0 = time.perf_counter()
    for f in range(args.frames):
        cam.frame_count = f
        uni = cam.uniforms(sky_enabled=not args.no_sky,
                           exposure=args.exposure, device="cuda")
        accum, image, stats = renderer.render(scene, uni, accum)
        rays = rays + stats["rays_traced"]
    pixels = image.cpu().numpy()
    render_s = time.perf_counter() - t0
    write_png(args.output, pixels)

    if args.stats_json:
        print(json.dumps({
            "output": args.output,
            "device": torch.cuda.get_device_name(0),
            "resolution": f"{args.width}x{args.height}",
            "triangles": scene.num_triangles,
            "frames": args.frames,
            "build_ms": round(build_ms, 1),
            "render_s": round(render_s, 3),
            "fps": round(args.frames / render_s, 3),
            "mrays_per_s": round(float(rays) / render_s / 1e6, 3),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

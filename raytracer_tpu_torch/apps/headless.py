"""Headless renderer CLI: scene -> accumulated frames -> PNG.

    python -m raytracer_tpu_torch.apps.headless --scene scene.json \\
        --frames 64 --width 1280 --height 720 --exposure 1.0 -o out.png
    python -m raytracer_tpu_torch.apps.headless --flagship -o out.png \\
        --frames 16 --stats-json

The port of ``raytracer_tpu.apps.headless``: a scene JSON
(``Scene.save_json``), the reference default scene or the flagship scene,
rendered on ``cuda`` (the default; it raises when there is no card) or on
the CPU with ``--device cpu``. ``--checkpoint`` saves the accumulator and
frame count and resumes from them; ``--chain`` renders that many frames a
``Renderer.render_chain`` call.

``--devices N`` (with ``--sp S``) renders on an (N/S, S) mesh, one process
a rank (``parallel/sharding.launch`` + ``MeshRenderer``, a frame a step):
every rank builds the same scene from the same source (the host build is
deterministic), rank 0 writes the PNG and the checkpoint, whose
accumulator is the whole frame's, so a single-device run resumes it and
the other way round. On ``cuda`` the mesh needs N cards (NCCL); with
``--device cpu`` the ranks run on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from raytracer_tpu_torch.core.camera import Camera, default_camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.scene.builder import (build_fast_scene,
                                               build_gpu_scene)
from raytracer_tpu_torch.scene.presets import flagship_scene
from raytracer_tpu_torch.scene.scene import Scene, default_scene
from raytracer_tpu_torch.utils import assets
from raytracer_tpu_torch.utils.log import get_logger
from raytracer_tpu_torch.utils.png import write_png

_log = get_logger("headless")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_tpu_torch.apps.headless",
        description="GPU path tracer, headless: render a scene to PNG.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="scene JSON file (Scene.save_json)")
    src.add_argument("--default-scene", action="store_true",
                     help="reference default scene (ground plane + car "
                          "slot) from the --assets dir")
    src.add_argument("--flagship", action="store_true",
                     help="the ~50k-triangle flagship scene")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=16,
                   help="accumulation frames (progressive samples)")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per pixel per frame")
    p.add_argument("--max-bounces", type=int, default=10)
    p.add_argument("--exposure", type=float, default=0.0, help="stops")
    p.add_argument("--no-sky", action="store_true")
    p.add_argument("--kernel", choices=("packet", "wavefront"),
                   default="packet",
                   help="packet: the packet kernels over a FastScene; "
                        "wavefront: the per-ray path over a GpuScene")
    p.add_argument("--rng", choices=("progressive", "reference"),
                   default="progressive")
    p.add_argument("--camera", metavar="X,Y,Z",
                   help="camera origin (default: reference pose -25,30,140)")
    p.add_argument("--look-at", metavar="X,Y,Z", default="0,0,0")
    p.add_argument("--vfov", type=float, default=20.0)
    p.add_argument("--assets", help="asset search dir override")
    p.add_argument("--stats-json", action="store_true",
                   help="print a stats JSON line at the end")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="render device (cuda raises without a card)")
    p.add_argument("--devices", type=int, default=0,
                   help="render on an N-device (dp x sp) mesh, one process "
                        "a device over torch.distributed (0 = single "
                        "device); with --device cpu, N CPU ranks over gloo")
    p.add_argument("--sp", type=int, default=1,
                   help="sample-parallel mesh axis (devices = dp * sp; "
                        "--spp must be divisible by sp)")
    p.add_argument("--checkpoint", metavar="FILE.npz",
                   help="save the accumulation state here at the end; if "
                        "the file exists, resume from it (render N more "
                        "frames on top)")
    p.add_argument("--chain", type=int, default=0,
                   help="progressive frames per Renderer.render_chain call "
                        "(bit-identical to sequential frames). 0 = auto "
                        "(largest of 8/4/2 dividing --frames), 1 = off")
    return p


def _parse_vec(s: str):
    return tuple(float(x) for x in s.split(","))


def _config(args) -> RenderConfig:
    return RenderConfig(width=args.width, height=args.height,
                        max_bounces=args.max_bounces,
                        samples_per_pixel=args.spp,
                        kernel=args.kernel, rng_mode=args.rng)


def _build_scene(args, cfg: RenderConfig, dev):
    """The scene of --scene / --default-scene / --flagship on ``dev`` ->
    (scene, build ms)."""
    t0 = time.perf_counter()
    if args.flagship:
        device_scene = flagship_scene(
            dev, search=[args.assets] if args.assets else [])
    else:
        if args.default_scene:
            scene_graph = default_scene(
                asset_dir=args.assets or assets.REPO_ASSETS)
        else:
            scene_graph = Scene.load_json(args.scene)
        build = build_fast_scene if cfg.kernel == "packet" else \
            build_gpu_scene
        device_scene = build(scene_graph.create_snapshot(), device=dev)
    return device_scene, (time.perf_counter() - t0) * 1e3


def _camera(args) -> Camera:
    if args.camera:
        return Camera(origin=_parse_vec(args.camera),
                      look_at=_parse_vec(args.look_at),
                      vfov_deg=args.vfov,
                      aspect_ratio=args.width / args.height)
    return default_camera(args.width, args.height)


def _resume(args):
    """(whole-frame accumulator f32[H, W, 3] or None, start frame) from
    the checkpoint file, if there is one of this resolution."""
    if not (args.checkpoint and os.path.exists(args.checkpoint)):
        return None, 0
    with np.load(args.checkpoint) as ckpt:
        if tuple(ckpt["accum"].shape) != (args.height, args.width, 3):
            _log.warning("checkpoint resolution mismatch; starting fresh")
            return None, 0
        _log.info("resumed %s at frame %d", args.checkpoint,
                  int(ckpt["frame_count"]))
        return (np.array(ckpt["accum"], np.float32),
                int(ckpt["frame_count"]))


def _finish(args, pixels, accum, end: int, stats: dict, render_s: float,
            **info) -> dict:
    """Write the PNG and the checkpoint -> the stats JSON fields."""
    write_png(args.output, pixels)
    _log.info("wrote %s", args.output)
    if args.checkpoint:
        np.savez(args.checkpoint, accum=accum, frame_count=end)
    return {
        "output": args.output, **info,
        "resolution": f"{args.width}x{args.height}",
        "frames": args.frames,
        "samples": float(stats["samples"]),
        "render_s": round(render_s, 3),
        "fps": round(args.frames / render_s, 3),
        "mrays_per_s": round(
            float(stats["rays_traced"]) * args.frames / render_s / 1e6, 3),
    }


def _mesh_rank(args, mesh):
    """One rank of ``--devices``: the same scene on every rank, a frame a
    ``MeshRenderer.render`` step; rank 0 writes the PNG and the whole
    accumulator -> rank 0's stats JSON fields (None elsewhere)."""
    from raytracer_tpu_torch.parallel.sharding import MeshRenderer

    dev = mesh.device
    cfg = _config(args)
    device_scene, build_ms = _build_scene(args, cfg, dev)
    cam = _camera(args)
    renderer = MeshRenderer(cfg, mesh)
    full, start_frame = _resume(args)
    accum = None
    if full is not None:
        rows = slice(mesh.dp_idx * renderer.shard_h,
                     (mesh.dp_idx + 1) * renderer.shard_h)
        accum = torch.from_numpy(np.ascontiguousarray(full[rows])).to(dev)

    t0 = time.perf_counter()
    end = start_frame + args.frames
    for f in range(start_frame, end):
        cam.frame_count = f
        uniforms = cam.uniforms(sky_enabled=not args.no_sky,
                                exposure=args.exposure, device=dev)
        accum, image, stats = renderer.render(device_scene, uniforms, accum)
    full = renderer.full_accumulator(accum).cpu().numpy()
    render_s = time.perf_counter() - t0
    if mesh.rank:
        return None
    return _finish(args, image.cpu().numpy(), full, end, stats, render_s,
                   device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                   triangles=int(device_scene.num_triangles),
                   build_ms=round(build_ms, 1))


def _single_device(args, dev) -> dict:
    """The run on one device (``Renderer``, ``--chain`` frames a call) ->
    the stats JSON fields."""
    cfg = _config(args)
    device_scene, build_ms = _build_scene(args, cfg, dev)
    cam = _camera(args)
    renderer = Renderer(cfg)

    # Checkpoint / resume: the accumulator and the frame count persist
    # across runs.
    full, start_frame = _resume(args)
    accum = None if full is None else torch.from_numpy(full).to(dev)

    chain = args.chain
    if chain <= 0:  # auto: chain when it divides the frame budget
        chain = next((k for k in (8, 4, 2) if args.frames % k == 0), 1)

    t0 = time.perf_counter()
    stats = {}
    f = start_frame
    end = start_frame + args.frames
    while f < end:
        k = min(chain, end - f)
        cam.frame_count = f
        uniforms = cam.uniforms(sky_enabled=not args.no_sky,
                                exposure=args.exposure, device=dev)
        if k > 1:
            accum, image, stats = renderer.render_chain(
                device_scene, uniforms, accum, k)
        else:
            accum, image, stats = renderer.render(device_scene, uniforms,
                                                  accum)
        f += k
    pixels = image.cpu().numpy()
    render_s = time.perf_counter() - t0
    return _finish(args, pixels, accum.cpu().numpy(), end, stats, render_s,
                   device=(torch.cuda.get_device_name(accum.device)
                           if dev == "cuda" else "cpu"),
                   triangles=int(device_scene.num_triangles),
                   build_ms=round(build_ms, 1))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.frames < 1:
        parser.error("--frames must be >= 1")
    if args.devices and args.spp % args.sp:
        parser.error("--spp must be divisible by --sp")
    if args.flagship and args.kernel != "packet":
        parser.error("--flagship renders --kernel packet")
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device")
    if args.assets:   # read by the asset search (the ranks inherit it)
        os.environ["RAYTPU_ASSETS"] = args.assets
    if args.devices:
        from raytracer_tpu_torch.parallel.sharding import launch

        run = launch(functools.partial(_mesh_rank, args), args.devices,
                     args.sp, devices=[dev] * args.devices
                     if dev == "cpu" else None)
        out = run.results[0]
        out["mesh"] = {"dp": args.devices // args.sp, "sp": args.sp,
                       "backend": run.backend}
    else:
        out = _single_device(args, dev)
    if args.stats_json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

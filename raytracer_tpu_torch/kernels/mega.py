"""The mega kernel: every bounce of a ray in one thread (``csrc/mega.cu``).

Replaces the JAX package's XLA megakernel, ``raytracer_tpu/kernels/
packet.py`` ``megakernel_bounces`` (:281) with ``_mega_level`` (:389):
the fused per-ray walk of the binary ``nodes8`` table, ``tracer.shade``
and the respawn of scattered rays, from bounce 0 (``RAYTPU_B0=mega``) or
bounce 1 (``RAYTPU_BOUNCE=mega`` after kernel A, ``RAYTPU_B0=packet``
after the group walk). One launch runs a band: persistent warps, one loop
at visit level across bounces, each lane taking a new ray from a counter
when its ray ends and writing the ended ray's colour at its pixel id.

``mega_plain`` is the plain version: ``kernels/packet.megakernel_bounces``,
which keeps the JAX loop's width levels, compaction and deposits at each
level boundary. Those change no result (each ray's path is its own), and
the kernel runs none of them, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import cuda_build, launches
from raytracer_tpu_torch.kernels.trace import _check_scene2


def mega_plain(scene: FastScene, ray_o, ray_d, color, atten, seed, alive,
               sky_on: bool, cfg: RenderConfig, start_bounce: int = 1,
               pix=None, n_out: int | None = None):
    """The plain version (``packet.megakernel_bounces``): SoA ray state
    (3-tuples of f32[P]; ``seed`` u32 values in int64; ``alive`` bool[P])
    from bounce ``start_bounce`` -> (color f32[3, n_out] deposited at
    ``pix`` (default each ray's index; cells >= ``n_out``, default P,
    dropped), rays traced (int64 tensor): the live rays plus every
    respawn)."""
    from raytracer_tpu_torch.kernels.packet import megakernel_bounces

    return megakernel_bounces(scene, ray_o, ray_d, color, atten, seed,
                              alive, sky_on, cfg, start_bounce, pix, n_out)


def _launch(name: str, scene: FastScene, ray_o, ray_d, color, atten, seed,
            alive, sky_on: bool, cfg: RenderConfig, start_bounce: int, pix,
            n_out, outs=(), ints=()):
    """Check the state and launch ``rt_<name>``, with the outputs
    ``outs`` after its own and the ints ``ints`` after its own ->
    (colour f32[3, n_out], rays int64[2]: traced, the ray counter)."""
    if start_bounce not in (0, 1):
        raise ValueError(f"start_bounce must be 0 or 1, got {start_bounce}")
    _check_scene2(scene, alive.device)
    p = alive.shape[0]
    n_out = p if n_out is None else n_out
    pix = (torch.arange(p, dtype=torch.int32, device=alive.device)
           if pix is None else pix.to(torch.int32).contiguous())
    fields = (*ray_o, *ray_d, *color, *atten)
    if (len(fields) != 12 or alive.dtype != torch.bool
            or any(t.shape != (p,) or t.device != alive.device
                   for t in (*fields, seed, pix))):
        raise ValueError("ray state must be 3-tuples of [P] tensors, seed "
                         "and pix [P], beside alive bool[P] on one device")
    state = torch.stack(fields).to(torch.float32)
    seed32 = seed.to(torch.int32).contiguous()
    act = alive.to(torch.uint8)
    out = torch.zeros((3, n_out), dtype=torch.float32, device=alive.device)
    rays = torch.zeros(2, dtype=torch.int64, device=alive.device)
    layout = cuda_build.leaf_layout(scene.layout)
    lib = cuda_build.library(layout)
    stream = torch.cuda.current_stream(alive.device).cuda_stream
    cuda_build.check(getattr(lib, f"rt_{name}")(
        scene.nodes8.data_ptr(), scene.clusters.data_ptr(),
        scene.cluster_counts.data_ptr(), state.data_ptr(),
        seed32.data_ptr(), act.data_ptr(), pix.data_ptr(), out.data_ptr(),
        rays.data_ptr(), *(t.data_ptr() for t in outs), p, n_out,
        scene.num_nodes, start_bounce, cfg.max_bounces, int(bool(sky_on)),
        int(bool(cfg.emissive_emits)),
        cfg.fuzz, cfg.t_min, cfg.t_max, cfg.det_eps, *ints, stream),
        f"rt_{name}")
    return out, rays


def mega(scene: FastScene, ray_o, ray_d, color, atten, seed, alive,
         sky_on: bool, cfg: RenderConfig, start_bounce: int = 1, pix=None,
         n_out: int | None = None):
    """The mega kernel on CUDA tensors, its plain version on CPU tensors
    (same arguments and result as ``mega_plain``). The pixel ids below
    ``n_out`` must be distinct (the kernel writes, the plain version
    adds)."""
    name = cuda_build.leaf_kernel_name("mega", scene.layout)
    if not launches.on_card(name, alive.device):
        return mega_plain(scene, ray_o, ray_d, color, atten, seed, alive,
                          sky_on, cfg, start_bounce, pix, n_out)
    out, rays = _launch("mega", scene, ray_o, ray_d, color, atten, seed,
                        alive, sky_on, cfg, start_bounce, pix, n_out)
    launches.launched(name)
    return out, rays[0]


def mega_count(scene: FastScene, ray_o, ray_d, color, atten, seed, alive,
               sky_on: bool, cfg: RenderConfig, start_bounce: int = 1,
               pix=None, n_out: int | None = None, schedule: int = 1):
    """The counting build of the mega kernel (CUDA tensors only), a
    measurement entry that no render calls: ``schedule`` 1 runs the
    kernel's schedule, 0 one ray a thread walking a whole bounce at a
    time. -> the results of ``mega``, then the walk's tallies int64[4]
    (visit trips, lanes active in them, leaf tests, lanes active in them,
    summed over warps) and each launched block's first and last
    ``%globaltimer`` reading, int64[blocks, 2] in ns. Books its launch as
    ``mega_count``."""
    if not launches.is_card(alive.device):
        raise ValueError("the counting build runs on the card only")
    tallies = torch.zeros(4, dtype=torch.int64, device=alive.device)
    times = torch.zeros((-(-alive.shape[0] // 128), 2), dtype=torch.int64,
                        device=alive.device)
    out, rays = _launch("mega_count", scene, ray_o, ray_d, color, atten,
                        seed, alive, sky_on, cfg, start_bounce, pix, n_out,
                        (tallies, times), (int(schedule),))
    launches.launched(cuda_build.leaf_kernel_name("mega_count",
                                                  scene.layout))
    return out, rays[0], tallies, times[times[:, 0] != 0]

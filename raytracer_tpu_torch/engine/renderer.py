"""The render step: bands -> band sum -> accumulate + tonemap.

The port of ``raytracer_tpu/engine/renderer.py``: the packet kernel over a
``FastScene`` (path shading on every ported bounce path,
``raytracer_tpu_torch/knobs.py``, and the fixed-light tier), and the
per-ray path (``kernels/tracer.render_linear``) for a ``GpuScene`` or
``kernel="wavefront"``, as the JAX renderer routes them. PyTorch runs
eagerly, so Python loops replace ``lax.scan`` / ``fori_loop`` and there is
no jit cache and no environment fingerprint: the path knobs are read at
call time. The frame tail always goes through the tonemap kernel
(``kernels/tonemap.py``), which accumulates and tonemaps in one launch;
``render_chain`` runs k frames as k steps (no CUDA graph: the sorted
rounds read their live count on the host once a round).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import (CameraUniforms, RenderConfig,
                                            to_device)
from raytracer_tpu_torch.kernels.bounce import ROW_PIX
from raytracer_tpu_torch.kernels.packet import (render_linear_fast,
                                                tail_merge_active,
                                                tail_merge_widths)
from raytracer_tpu_torch.kernels.tonemap import tonemap_accumulate
from raytracer_tpu_torch.kernels.tracer import render_linear
from raytracer_tpu_torch.kernels.wavefront import wavefront_tail


def tonemap(linear: torch.Tensor, exposure) -> torch.Tensor:
    """Exposure scale (2**stops) -> sqrt gamma -> u8 (plain ops)."""
    scaled = linear * torch.exp2(torch.as_tensor(
        exposure, dtype=torch.float32, device=linear.device))
    gamma = torch.sqrt(torch.clamp_min(scaled, 0.0))
    return torch.clamp(torch.round(gamma * 255.0), 0.0, 255.0).to(
        torch.uint8)


def _num_bands(cfg: RenderConfig) -> int:
    """Largest band count that divides the row-tiles and keeps bands at or
    under cfg.band_rays rays."""
    if not cfg.band_rays:
        return 1
    row_tiles = cfg.height // 8 if cfg.height % 8 == 0 else cfg.height
    for nb in range(1, row_tiles + 1):
        if row_tiles % nb:
            continue
        if (cfg.height // nb) * cfg.width <= cfg.band_rays:
            return nb
    return row_tiles


def _sample_terms(scene, cam: CameraUniforms, cfg: RenderConfig, *,
                  y_base: int = 0, global_height: Optional[int] = None,
                  sample_offset: int = 0, n_samples: Optional[int] = None):
    """Per sample of the frame, in sample order: (terms, rays traced
    (int64 tensor)), where the terms are the f32[3, H*W] colours whose
    sum in list order is that sample's radiance: the bands' colours and,
    where the cross-band tail merge applies, the merged tail's deposits.
    A ``FastScene`` with ``kernel="packet"`` renders through the packet
    kernels, anything else through the per-ray path (no tail merge
    there).

    ``y_base`` / ``global_height`` render this cfg-sized frame as the
    rows from ``y_base`` of a taller frame (the dp mesh axis);
    ``sample_offset`` / ``n_samples`` render a slice of the samples (the
    sp axis). ``cfg`` keeps the GLOBAL samples_per_pixel either way: the
    RNG folds it into the seeds (``tracer.initial_seed``)."""
    packet = cfg.kernel == "packet" and isinstance(scene, FastScene)
    spp = cfg.samples_per_pixel if n_samples is None else n_samples
    gh = global_height or cfg.height
    nb = _num_bands(cfg)
    band_h = cfg.height // nb
    band_cfg = dataclasses.replace(cfg, height=band_h)
    hw = cfg.height * cfg.width
    tm = (tail_merge_widths(cfg, band_h, nb)
          if packet and tail_merge_active(scene, cfg) else None)

    for i in range(sample_offset, sample_offset + spp):
        bands, survivors = [], []
        rays = torch.zeros((), dtype=torch.int64, device=scene.device)
        for b in range(nb):
            y0 = y_base + b * band_h
            if packet:
                color, brays, surv = render_linear_fast(
                    scene, cam, band_cfg, sample_index=i, y_offset=y0,
                    global_height=gh, tail_handoff=tm[0] if tm else None)
                survivors.append(surv)
            else:
                color, brays = render_linear(
                    scene, cam, band_cfg, sample_index=i, y_offset=y0,
                    global_height=gh)
            bands.append(color)
            rays = rays + brays
        terms = [torch.cat(bands, dim=1)]
        if tm is not None:
            # Survivor pixel ids are global; deposits target this
            # frame's rows, so shift them by its base row (the pad
            # sentinel gh * w stays >= hw and still drops).
            merged = torch.cat(survivors, dim=1)
            if y_base:
                merged[ROW_PIX] -= y_base * cfg.width
            tail, trays = wavefront_tail(scene, merged, cam.sky_host, cfg,
                                         out_size=hw)
            terms.append(tail)
            rays = rays + trays
        yield terms, rays


def _render_total(scene, cam: CameraUniforms, cfg: RenderConfig, *,
                  y_base: int = 0, global_height: Optional[int] = None,
                  sample_offset: int = 0, n_samples: Optional[int] = None):
    """Radiance of one frame summed over its samples -> (f32[3, H*W],
    rays traced (int64 tensor)): the ``_sample_terms`` of the row band
    and sample slice (as there) added in order. The tonemap kernel
    divides by spp and reads the planar layout as it stands."""
    hw = cfg.height * cfg.width
    total = torch.zeros((3, hw), dtype=torch.float32, device=scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for terms, sample_rays in _sample_terms(
            scene, cam, cfg, y_base=y_base, global_height=global_height,
            sample_offset=sample_offset, n_samples=n_samples):
        for term in terms:
            total = total + term
        rays = rays + sample_rays
    return total, rays


def _render_step(scene, cam: CameraUniforms, accum: torch.Tensor,
                 cfg: RenderConfig):
    """scene + camera + accumulation -> (new accum, u8 frame, stats)."""
    total, rays = _render_total(scene, cam, cfg)
    # The running average is written into ``accum`` in place.
    new_accum, image = tonemap_accumulate(accum, total,
                                          cfg.samples_per_pixel,
                                          cam.frame_count, cam.exposure)
    stats = {"rays_traced": rays,
             "samples": (cam.fc_host + 1) * cfg.samples_per_pixel}
    return new_accum, image, stats


class Renderer:
    """Render step + accumulation buffer lifecycle."""

    def __init__(self, config: Optional[RenderConfig] = None):
        self.cfg = config or RenderConfig()

    def new_accumulator(self, device) -> torch.Tensor:
        return torch.zeros((self.cfg.height, self.cfg.width, 3),
                           dtype=torch.float32, device=device)

    def render(self, scene, cam: CameraUniforms,
               accum: Optional[torch.Tensor] = None):
        """One frame of a FastScene or GpuScene -> (accum, u8 image
        [H, W, 3], stats). ``accum`` is updated in place and returned;
        ``accum=None`` starts a new accumulation run."""
        if accum is None:
            accum = self.new_accumulator(scene.device)
        return _render_step(scene, cam, accum, self.cfg)

    def render_chain(self, scene, cam: CameraUniforms,
                     accum: Optional[torch.Tensor], k: int):
        """k progressive frames from ``cam``'s frame count, the count
        advancing a step a frame -> (accum, u8 image of the final
        accumulator, stats averaged per frame: ``rays_traced`` / k and
        ``samples`` = end frame count * spp). Bit-equal to k ``render``
        calls; the caller's frame counter should advance by k."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if accum is None:
            accum = self.new_accumulator(scene.device)
        rays = torch.zeros((), dtype=torch.int64, device=accum.device)
        fc = cam.fc_host
        for i in range(k):
            cam_i = dataclasses.replace(
                cam, fc_host=fc + i,
                frame_count=to_device(np.int32(fc + i), accum.device))
            accum, image, stats = _render_step(scene, cam_i, accum, self.cfg)
            rays = rays + stats["rays_traced"]
        return accum, image, {"rays_traced": rays / k,
                              "samples": (fc + k) * self.cfg.samples_per_pixel}

    def render_to_numpy(self, scene, cam, accum=None):
        accum, image, stats = self.render(scene, cam, accum)
        return accum, image.cpu().numpy(), {
            "rays_traced": float(stats["rays_traced"]),
            "samples": float(stats["samples"])}

"""The frame tail: running-average accumulate + exposure + sqrt gamma + u8
(``csrc/tonemap.cu``).

Replaces the Pallas kernel ``raytracer_tpu/kernels/pallas_ops.py``
``_tonemap_accum_kernel`` (via ``tonemap_accumulate``), which the JAX
renderer's default computes in plain ops instead (``engine/renderer.py``
``tonemap``, ``pallas_tonemap=False``); the port's frame tail always goes
through this kernel.

Like the TPU kernel, it reads the frame in the planar [3, H*W] view: the
band sum ``total`` as the renderer builds it, divided by ``spp`` inside the
kernel, so the frame needs no division, transpose or copy before the call.
The frame count and exposure are read from the card (no host sync); the
accumulator f32[H, W, 3] is updated in place. One device launch a call.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.kernels import cuda_build, launches


def _check(accum, total):
    h, w, c = accum.shape if accum.dim() == 3 else (0, 0, 0)
    if (accum.dtype != torch.float32 or total.dtype != torch.float32
            or c != 3 or total.shape != (3, h * w)
            or accum.device != total.device
            or not accum.is_contiguous() or not total.is_contiguous()):
        raise ValueError("accum must be contiguous f32[H, W, 3] and total "
                         "contiguous f32[3, H*W] on its device")


def tonemap_plain(accum, total, spp: int, frame_count, exposure):
    """Plain version: (accum f32[H, W, 3], band sum total f32[3, H*W], spp,
    frame count, exposure stops) -> (accum, u8 image [H, W, 3]). With s =
    total / spp in the [H, W, 3] layout, ``accum`` becomes (accum*fc +
    s)/(fc+1) in place; the image is round(sqrt(max(accum*2^exposure, 0))
    * 255) in [0, 255]."""
    _check(accum, total)
    dev = accum.device
    # A true division: PyTorch multiplies by the reciprocal of a host
    # scalar on the card.
    sample = (total / torch.tensor(float(spp), device=dev)).T.reshape(
        accum.shape)
    fc = torch.as_tensor(frame_count, device=dev).to(torch.float32)
    scale = torch.exp2(torch.as_tensor(exposure, device=dev).to(
        torch.float32))
    accum.copy_((accum * fc + sample) / (fc + 1.0))
    gamma = torch.sqrt(torch.clamp_min(accum * scale, 0.0))
    image = torch.clamp(torch.round(gamma * 255.0), 0.0, 255.0)
    return accum, image.to(torch.uint8)


def tonemap_accumulate(accum, total, spp: int, frame_count, exposure):
    """The kernel on CUDA tensors, its plain version on CPU tensors (same
    arguments and results as ``tonemap_plain``; on the card
    ``frame_count`` is an i32 and ``exposure`` an f32 tensor there)."""
    if not launches.on_card("tonemap", accum.device):
        return tonemap_plain(accum, total, spp, frame_count, exposure)
    _check(accum, total)
    if (not isinstance(frame_count, torch.Tensor)
            or not isinstance(exposure, torch.Tensor)
            or frame_count.dtype != torch.int32
            or exposure.dtype != torch.float32
            or frame_count.numel() != 1 or exposure.numel() != 1
            or frame_count.device != accum.device
            or exposure.device != accum.device):
        raise ValueError("frame_count (i32) and exposure (f32) must be "
                         "one-element tensors on the accumulator's device")
    if int(spp) < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    image = torch.empty(accum.shape, dtype=torch.uint8, device=accum.device)
    stream = torch.cuda.current_stream(accum.device).cuda_stream
    cuda_build.check(cuda_build.library().rt_tonemap(
        total.data_ptr(), accum.data_ptr(), image.data_ptr(), total.shape[1],
        int(spp), frame_count.data_ptr(), exposure.data_ptr(), stream),
        "rt_tonemap")
    launches.launched("tonemap")
    return accum, image

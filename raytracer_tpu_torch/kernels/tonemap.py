"""The frame tail: running-average accumulate + exposure + sqrt gamma + u8.

Replaces the Pallas kernel ``raytracer_tpu/kernels/pallas_ops.py``
``_tonemap_accum_kernel`` (via ``tonemap_accumulate``), which the JAX
renderer's default computes in plain ops instead (``engine/renderer.py``
``tonemap``, ``pallas_tonemap=False``); the port's frame tail always goes
through this kernel.

The kernel is Triton: one fused elementwise pass over the 3*H*W floats of
the frame with two scalars and no reduction. It is bound by memory
traffic alone (read accum and sample, write accum and the u8 image: 13
bytes a pixel channel), so a hand-written CUDA version would be the same
load-compute-store. It keeps IEEE division and square root (``div_rn``,
``sqrt_rn``), rounds half to even (``libdevice.rint``, as ``torch.round``
and ``jnp.round`` do) and is compiled without FMA contraction, so it
agrees with the plain version bit for bit. Elementwise, it takes the
accumulator in the renderer's [H, W, 3] layout rather than the TPU
kernel's [3, H*W] view.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.kernels import launches

_BLOCK = 1024
_kernel = None


def _triton_kernel():
    """Build the Triton kernel on first use (this keeps ``import triton``
    out of module import)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def tonemap_accum_kernel(acc_ptr, smp_ptr, fc_ptr, scale_ptr,
                             out_acc_ptr, img_ptr, n,
                             BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        fc = tl.load(fc_ptr)
        scale = tl.load(scale_ptr)
        acc = tl.load(acc_ptr + offs, mask=m, other=0.0)
        smp = tl.load(smp_ptr + offs, mask=m, other=0.0)
        new = tl.div_rn(acc * fc + smp, fc + 1.0)
        tl.store(out_acc_ptr + offs, new, mask=m)
        gamma = tl.sqrt_rn(tl.maximum(new * scale, 0.0))
        q = libdevice.rint(gamma * 255.0)
        q = tl.minimum(tl.maximum(q, 0.0), 255.0)
        tl.store(img_ptr + offs, q.to(tl.uint8), mask=m)

    _kernel = tonemap_accum_kernel
    return _kernel


def _scalars(accum, frame_count, exposure):
    """(fc, 2**exposure) as f32[1] tensors on the accumulator's device."""
    dev = accum.device
    fc = torch.as_tensor(frame_count, device=dev).to(torch.float32).reshape(1)
    ex = torch.as_tensor(exposure, device=dev).to(torch.float32).reshape(1)
    return fc, torch.exp2(ex)


def _check(accum, sample):
    if (accum.dtype != torch.float32 or sample.dtype != torch.float32
            or accum.shape != sample.shape or accum.device != sample.device
            or not accum.is_contiguous() or not sample.is_contiguous()):
        raise ValueError("accum and sample must be contiguous f32 tensors "
                         "of one shape on one device")


def tonemap_plain(accum, sample, frame_count, exposure):
    """Plain version: (accum, sample, fc, exposure stops) -> (accum, u8
    image). ``accum`` becomes (accum*fc + sample)/(fc+1) in place; the
    image is round(sqrt(max(accum*2^exposure, 0)) * 255) in [0, 255]."""
    _check(accum, sample)
    launches.plain["tonemap"] += 1
    fc, scale = _scalars(accum, frame_count, exposure)
    accum.copy_((accum * fc + sample) / (fc + 1.0))
    gamma = torch.sqrt(torch.clamp_min(accum * scale, 0.0))
    image = torch.clamp(torch.round(gamma * 255.0), 0.0, 255.0)
    return accum, image.to(torch.uint8)


def tonemap_accumulate(accum, sample, frame_count, exposure):
    """The Triton kernel on CUDA tensors, its plain version on CPU
    tensors (same arguments and results as ``tonemap_plain``)."""
    if accum.device.type == "cpu":
        return tonemap_plain(accum, sample, frame_count, exposure)
    if accum.device.type != "cuda":
        raise ValueError(f"unsupported device {accum.device}")
    _check(accum, sample)
    fc, scale = _scalars(accum, frame_count, exposure)
    image = torch.empty(accum.shape, dtype=torch.uint8, device=accum.device)
    n = accum.numel()
    kernel = _triton_kernel()
    grid = ((n + _BLOCK - 1) // _BLOCK,)
    # Each element is read, then written back in place by the same lane.
    kernel[grid](accum, sample, fc, scale, accum, image, n, BLOCK=_BLOCK,
                 enable_fp_fusion=False)
    launches.kernel["tonemap"] += 1
    return accum, image

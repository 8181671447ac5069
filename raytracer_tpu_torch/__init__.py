"""raytracer_tpu_torch — the PyTorch + CUDA port of raytracer_tpu.

The JAX package (``raytracer_tpu``) is the reference this package is held
against; this one imports ``torch`` and never ``jax``. It renders the
default main path of the JAX renderer (a 1280x720, 10-bounce progressive
path-traced frame over a host-built packed scene, banded, with sorted
wavefront bounce rounds and the cross-band tail merge), every bounce path
that reaches a Pallas kernel, and the per-ray GLSL-parity path, over
scenes made of instances (``scene/scene.py``, ``scene/presets.py``).
Three hand-written kernels carry the main path on an NVIDIA Hopper card:

* kernel A, ``csrc/trace4.cu`` (closest hit over the 8-wide BVH),
* kernel B, ``csrc/bounce12.cu`` (one fused walk + shade round),
* the tonemap, ``csrc/tonemap.cu`` (accumulate, exposure, gamma, u8).

Each kernel has a plain PyTorch version beside it. A wrapper runs the
plain version for a CPU tensor and the kernel for a CUDA tensor.
"""

from raytracer_tpu_torch.core.camera import Camera, default_camera
from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import CameraUniforms, RenderConfig

__all__ = ["Camera", "CameraUniforms", "FastScene", "RenderConfig",
           "default_camera"]

"""Render configuration, per-frame camera uniforms and the per-ray scene.

``RenderConfig`` is a field-for-field copy of ``raytracer_tpu.core.types.
RenderConfig`` (same defaults and validation), so one config describes a
frame in both packages. ``CameraUniforms`` holds the per-frame UBO surface
as torch tensors on the render device, plus host mirrors of the scalars
that steer host control flow (so reading them never waits on the card).
``FlatBVH`` and ``GpuScene`` are the JAX package's per-ray scene layout
(``raytracer_tpu.core.types``) as torch tensors, with host-int counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def to_device(a, device) -> torch.Tensor:
    """A host array as a new tensor on ``device``. A copy to the card goes
    from pinned memory and does not wait: ``torch.tensor(..., device=
    "cuda")`` synchronises the stream, so it would wait for every frame
    and build already queued."""
    t = torch.from_numpy(np.array(a))
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)  # raises for "cuda" without a card


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (see the JAX twin for each field's story)."""

    width: int = 1280
    height: int = 720
    max_bounces: int = 10
    t_min: float = 1e-3
    t_max: float = 1e4
    fuzz: float = 0.3
    det_eps: float = 1e-5
    rng_mode: str = "progressive"
    samples_per_pixel: int = 1
    emissive_emits: bool = True
    kernel: str = "packet"
    shading: str = "path"
    band_rays: int = 414720
    pallas_tonemap: bool = False

    def __post_init__(self):
        if self.rng_mode not in ("reference", "progressive"):
            raise ValueError(f"bad rng_mode: {self.rng_mode}")
        if self.kernel not in ("packet", "wavefront"):
            raise ValueError(f"bad kernel: {self.kernel}")
        if self.shading not in ("path", "fixed_light"):
            raise ValueError(f"bad shading: {self.shading}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("resolution must be positive")
        if self.max_bounces < 1:
            raise ValueError("max_bounces must be >= 1")


@dataclasses.dataclass
class CameraUniforms:
    """Everything the host sends the renderer per frame.

    Tensors live on the render device; ``fc_host``/``sky_host`` mirror the
    frame counter and sky flag on the host.
    """

    origin: torch.Tensor             # f32[3]
    lower_left_corner: torch.Tensor  # f32[3]
    horizontal: torch.Tensor         # f32[3]
    vertical: torch.Tensor           # f32[3]
    frame_count: torch.Tensor        # i32 scalar
    sky_enabled: torch.Tensor        # i32 scalar
    exposure: torch.Tensor           # f32 scalar (stops)
    fc_host: int = 0
    sky_host: bool = True

    @staticmethod
    def create(origin, lower_left_corner, horizontal, vertical,
               frame_count: int = 0, sky_enabled: bool = True,
               exposure: float = 0.0, device="cuda") -> "CameraUniforms":
        """Rounds each f64 host value to f32 once, as the JAX twin does.
        Two copies to the device (``to_device``), neither waiting for
        the card."""
        f = to_device(np.concatenate([
            np.asarray(v, np.float32).reshape(-1) for v in (
                origin, lower_left_corner, horizontal, vertical,
                exposure)]), device)
        i = to_device(np.asarray([frame_count, 1 if sky_enabled else 0],
                                 np.int32), device)
        return CameraUniforms(
            origin=f[0:3], lower_left_corner=f[3:6], horizontal=f[6:9],
            vertical=f[9:12], frame_count=i[0], sky_enabled=i[1],
            exposure=f[12], fc_host=int(frame_count),
            sky_host=bool(sky_enabled))


@dataclasses.dataclass
class FlatBVH:
    """Binary BVH in pre-order, structure of arrays (the JAX twin's
    layout): internal nodes ``node_tri`` -1, ``node_data`` = left child,
    ``node_count`` = right child; leaves ``node_tri`` = triangle index,
    ``node_data`` = -(tri + 1), ``node_count`` = -1. ``node_skip`` is the
    pre-order escape link (the node count past the end), so a walk is
    stackless: box hit and internal -> i + 1, else skip."""

    node_min: torch.Tensor    # f32[M, 3]
    node_max: torch.Tensor    # f32[M, 3]
    node_tri: torch.Tensor    # i32[M]
    node_skip: torch.Tensor   # i32[M]
    node_data: torch.Tensor   # i32[M]
    node_count: torch.Tensor  # i32[M]

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


@dataclasses.dataclass
class GpuScene:
    """Per-ray scene: triangles in BVH order and their materials (r, g, b,
    type), padded to power-of-two capacities like the JAX twin (padding
    nodes are unreachable, padding triangles degenerate)."""

    bvh: FlatBVH
    tri_verts: torch.Tensor   # f32[Tpad, 3, 3]
    materials: torch.Tensor   # f32[Tpad, 4]
    num_triangles: int
    num_nodes: int

    @property
    def capacity(self) -> int:
        return self.tri_verts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_verts.device

    def to(self, device) -> "GpuScene":
        bvh = FlatBVH(**{f.name: getattr(self.bvh, f.name).to(device)
                         for f in dataclasses.fields(FlatBVH)})
        return dataclasses.replace(self, bvh=bvh,
                                   tri_verts=self.tri_verts.to(device),
                                   materials=self.materials.to(device))


# Material type codes (reference VulkanApp.java:483-488).
MAT_LAMBERTIAN = 0.0
MAT_METAL = 1.0
MAT_METAL_FUZZY = 2.0
MAT_EMISSIVE = 3.0

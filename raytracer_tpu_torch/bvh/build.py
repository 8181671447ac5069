"""Host-side BVH build: binned SAH or PLOC, pre-order flattened (native
builder).

The JAX package's default build (``RAYTPU_BVH=sah`` through
``native/raytpu_native.cpp``) and its PLOC build (window 8), so both
packages get the same tree. Node encoding: ``node_tri`` = first
triangle of a leaf (-1 internal), ``node_ntri`` = triangles in the leaf,
``node_skip`` = pre-order escape index, ``order`` maps flattened
position -> input triangle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracer_tpu_torch import knobs, native_bridge

# Degenerate-axis pad of a triangle's AABB (the JAX package's
# ``bvh/build.AABB_EPS``), used by the device builders.
AABB_EPS = 1e-4


@dataclasses.dataclass
class HostBVH:
    node_min: np.ndarray    # f32[M, 3]
    node_max: np.ndarray    # f32[M, 3]
    node_tri: np.ndarray    # i32[M]
    node_ntri: np.ndarray   # i32[M]
    node_skip: np.ndarray   # i32[M]
    node_data: np.ndarray   # i32[M]
    node_count: np.ndarray  # i32[M]
    order: np.ndarray       # i64[T]

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def build_bvh(tris: np.ndarray, leaf_size: int = 1,
              method: str | None = None) -> HostBVH:
    """f32[T, 3, 3] triangle soup (T > 0) -> HostBVH. ``method``: None
    reads ``RAYTPU_BVH`` (``sah`` only, as every scene pack builds); a
    caller that picks its own tree passes ``"sah"`` or ``"ploc"`` (the
    refit capture, ``scene/refit.py``)."""
    knobs.fixed("RAYTPU_NATIVE")
    if method is None:
        knobs.fixed("RAYTPU_BVH")
        method = "sah"
    builders = {"sah": native_bridge.build_bvh_sah,
                "ploc": native_bridge.build_bvh_ploc}
    if method not in builders:
        raise NotImplementedError(
            f"BVH method {method!r} is not ported (ported: sah, ploc)")
    tris = np.asarray(tris, np.float32)
    if tris.shape[0] == 0:
        raise ValueError("cannot build BVH from empty triangle list")
    return HostBVH(**builders[method](tris, leaf_size))

"""Host-side BVH build: binned SAH, pre-order flattened (native builder).

The JAX package's default build (``RAYTPU_BVH=sah`` through
``native/raytpu_native.cpp``), so both packages get the same tree. Node
encoding: ``node_tri`` = first triangle of a leaf (-1 internal),
``node_ntri`` = triangles in the leaf, ``node_skip`` = pre-order escape
index, ``order`` maps flattened position -> input triangle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracer_tpu_torch import knobs, native_bridge


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


def build_bvh(tris: np.ndarray, leaf_size: int = 1) -> HostBVH:
    """f32[T, 3, 3] triangle soup (T > 0) -> HostBVH."""
    knobs.fixed("RAYTPU_BVH", "RAYTPU_NATIVE")
    tris = np.asarray(tris, np.float32)
    if tris.shape[0] == 0:
        raise ValueError("cannot build BVH from empty triangle list")
    return HostBVH(**native_bridge.build_bvh_sah(tris, leaf_size))

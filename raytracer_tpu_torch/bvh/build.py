"""Host-side BVH build, pre-order flattened: the JAX package's
``raytracer_tpu/bvh/build.py`` (``build_bvh`` and ``build_bvh_numpy``).

``RAYTPU_BVH`` picks the split policy (``knobs.bvh_method``): ``sah``
(binned SAH, the default), ``median`` (median split on the longest axis),
``sbvh`` (spatial splits; straddling triangles are referenced by several
leaves, so ``order`` repeats triangle ids and is longer than T) or
``ploc`` (capped-leaf PLOC, window 8). They run in the native library
(``native/raytpu_native.cpp``), as in the JAX package, so both packages
get the same tree. ``RAYTPU_NATIVE=0`` builds in NumPy instead, as the
JAX package does: ``bvh/ploc.py`` for ``ploc``, else the median tree of
``build_bvh_numpy``. With the library on, a native failure raises (the
JAX package logs it and builds the NumPy median tree).

Node encoding: ``node_tri`` = first reference of a leaf (-1 internal),
``node_ntri`` = triangles in the leaf, ``node_skip`` = pre-order escape
index, ``order`` maps flattened position -> input triangle.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np

from raytracer_tpu_torch import knobs, native_bridge
from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("bvh")

# Degenerate-axis pad of a triangle's AABB (the JAX package's
# ``bvh/build.AABB_EPS``), used by the NumPy and the device builders.
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
    order: np.ndarray       # i64[T], longer under SBVH (repeats)

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def triangle_aabbs(tris: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-triangle AABBs with epsilon padding on degenerate axes."""
    lo = tris.min(axis=1)
    hi = tris.max(axis=1)
    thin = (hi - lo) < AABB_EPS
    lo = np.where(thin, lo - AABB_EPS, lo)
    hi = np.where(thin, hi + AABB_EPS, hi)
    return lo.astype(np.float32), hi.astype(np.float32)


def build_bvh(tris: np.ndarray, leaf_size: int = 1,
              method: str | None = None) -> HostBVH:
    """f32[T, 3, 3] triangle soup (T > 0) -> HostBVH. ``method``: None
    reads ``RAYTPU_BVH``; a caller that picks its own tree passes one of
    ``knobs.BVH_METHODS`` (the refit capture, ``scene/refit.py``)."""
    if method is None:
        method = knobs.bvh_method()
    if method not in knobs.BVH_METHODS:
        raise NotImplementedError(
            f"BVH method {method!r} is not ported (ported: "
            f"{', '.join(knobs.BVH_METHODS)})")
    tris = np.asarray(tris, np.float32)
    if tris.shape[0] == 0:
        raise ValueError("cannot build BVH from empty triangle list")
    if knobs.native():
        builders = {"sah": native_bridge.build_bvh_sah,
                    "median": native_bridge.build_bvh_median,
                    "sbvh": native_bridge.build_bvh_sbvh,
                    "ploc": native_bridge.build_bvh_ploc}
        return HostBVH(**builders[method](tris, leaf_size))
    if method == "ploc":
        from raytracer_tpu_torch.bvh.ploc import build_bvh_ploc

        return build_bvh_ploc(tris, leaf_size=leaf_size)
    return build_bvh_numpy(tris, leaf_size)


def build_bvh_numpy(tris: np.ndarray, leaf_size: int = 1) -> HostBVH:
    """Median split on the longest axis, pure NumPy (the JAX package's
    ``build_bvh_numpy``, whose tree the native ``rt_build_bvh`` repeats):
    a segment of k triangles splits into k // 2 and k - k // 2 by
    centroid along its box's longest axis (k == 2 by direct compare),
    leaves at k <= leaf_size, pre-order with skip links."""
    t0 = time.perf_counter()
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH from empty triangle list")

    lo, hi = triangle_aabbs(tris)
    centers = (lo + hi) * 0.5

    # Subtree node count for a segment of k tris, following the actual
    # median-split recursion (k -> k//2, k-k//2, leaf at k <= leaf_size).
    @functools.lru_cache(maxsize=None)
    def subtree_nodes(k: int) -> int:
        if k <= leaf_size:
            return 1
        return 1 + subtree_nodes(k // 2) + subtree_nodes(k - k // 2)

    m = subtree_nodes(n)
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    node_tri = np.full(m, -1, np.int32)
    node_ntri = np.zeros(m, np.int32)
    node_skip = np.empty(m, np.int32)
    node_data = np.empty(m, np.int32)
    node_count = np.empty(m, np.int32)
    order = np.empty(n, np.int64)

    idx = np.arange(n)  # mutable permutation of triangle ids
    next_node = 0
    next_tri = 0

    # Explicit stack of (start, end, skip_index); LIFO pop order gives
    # pre-order DFS emission (left subtree immediately after its parent).
    stack: list[tuple[int, int, int]] = [(0, n, m)]
    while stack:
        start, end, skip = stack.pop()
        my = next_node
        next_node += 1
        seg = idx[start:end]
        node_min[my] = lo[seg].min(axis=0)
        node_max[my] = hi[seg].max(axis=0)
        node_skip[my] = skip
        k = end - start

        if k <= leaf_size:
            node_tri[my] = next_tri
            node_ntri[my] = k
            order[next_tri:next_tri + k] = seg
            # Reference leaf encoding (single-tri leaves).
            node_data[my] = -(next_tri + 1)
            node_count[my] = -1
            next_tri += k
            continue

        ext = node_max[my] - node_min[my]
        axis = int(np.argmax(ext))
        if k == 2:
            # Direct compare (reference BVHBuilder.java:63-71).
            if centers[seg[0], axis] > centers[seg[1], axis]:
                idx[start], idx[start + 1] = idx[start + 1], idx[start]
        else:
            # Median split: partial sort by AABB center along axis.
            mid_off = k // 2
            part = np.argpartition(centers[seg, axis], mid_off)
            idx[start:end] = seg[part]
        mid = start + k // 2

        left_nodes = subtree_nodes(mid - start)
        right_index = my + 1 + left_nodes
        node_data[my] = my + 1
        node_count[my] = right_index
        # Push right first so left pops first (pre-order).
        stack.append((mid, end, skip))
        stack.append((start, mid, right_index))

    assert next_node == m and next_tri == n
    _log.debug("BVH build: %d tris -> %d nodes in %.2f ms",
               n, m, (time.perf_counter() - t0) * 1e3)
    return HostBVH(node_min, node_max, node_tri, node_ntri, node_skip,
                   node_data, node_count, order)

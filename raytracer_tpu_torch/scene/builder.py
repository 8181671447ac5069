"""Scene packing: triangle soup -> ``FastScene`` tensors on a device.

Builds the same tables, with the same capacity buckets and padding, as
``raytracer_tpu.scene.builder.build_fast_scene_from_arrays`` at its
default knobs (binned-SAH tree, native cluster packing, count-encoded
8-wide collapse). Everything is NumPy or the native library until the
final ``torch.from_numpy(...).to(device)``.

Also carries state across from the JAX package: ``fast_scene_from_numpy``
and ``camera_uniforms_from_numpy`` rebuild the port's types from the JAX
package's leaves (taken with ``np.asarray``), so tests can feed both sides
from the same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch import native_bridge
from raytracer_tpu_torch.bvh.build import build_bvh
from raytracer_tpu_torch.bvh.bvh4 import (STACK_CAP, collapse4,
                                          nodes4_stack_need)
from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, CLUSTER_SIZE,
                                                 TRI_STRIDE, FastScene)
from raytracer_tpu_torch.core.types import CameraUniforms

_MIN_CAPACITY = 64
_BIG = np.float32(1e30)


def _bucket(n: int) -> int:
    """Smallest power-of-two capacity >= n (minimum 64)."""
    c = _MIN_CAPACITY
    while c < n:
        c *= 2
    return c


def pack_tri_records(v9: np.ndarray, m4: np.ndarray) -> np.ndarray:
    """[T,9] verts + [T,4] mats -> [T,16] packed cluster records: v0,
    e1=v1-v0, e2=v2-v0, albedo, type, unit normal normalize(cross(e1,e2))
    (the layout the native packer writes)."""
    v9 = np.asarray(v9, np.float32)
    m4 = np.asarray(m4, np.float32)
    v0 = v9[:, 0:3]
    e1 = v9[:, 3:6] - v0
    e2 = v9[:, 6:9] - v0
    nrm = np.cross(e1, e2).astype(np.float32)
    nlen = np.sqrt((nrm * nrm).sum(-1, keepdims=True, dtype=np.float32))
    nrm = np.where(nlen > 0.0, nrm / np.where(nlen > 0.0, nlen, 1.0), 0.0)
    return np.concatenate(
        [v0, e1, e2, m4[:, 0:3], m4[:, 3:4], nrm.astype(np.float32)],
        axis=1).astype(np.float32)


def _host_tables(verts: np.ndarray, mats: np.ndarray):
    """NumPy tables (nodes8, clusters, nodes4, num_nodes, num_nodes4)."""
    n = verts.shape[0]
    if n == 0:
        mcap = _MIN_CAPACITY
        nodes8 = np.zeros((mcap, 8), np.float32)
        nodes8[:, 0:3] = _BIG
        nodes8[:, 3:6] = -_BIG
        nodes8[:, 6] = np.full((), 1, np.int32).view(np.float32)  # skip
        nodes8[:, 7] = np.full((), 0, np.int32).view(np.float32)  # leaf 0
        clusters = np.zeros((_MIN_CAPACITY, CLUSTER_ROW), np.float32)
        num_nodes = 1
        counts = np.ones(1, np.int32)
    else:
        bvh = build_bvh(verts, leaf_size=CLUSTER_SIZE)
        m = bvh.num_nodes
        mcap = _bucket(m)
        leaf_mask = bvh.node_tri >= 0
        num_leaves = int(leaf_mask.sum())
        lcap = _bucket(num_leaves)

        # col7: leaves -> dense cluster id (>= 0); internal ->
        # -(left_child + 1) (pre-order: left = node + 1).
        leaf_ids = np.empty(m, np.int32)
        leaf_ids[leaf_mask] = np.arange(num_leaves, dtype=np.int32)
        internal = np.nonzero(~leaf_mask)[0]
        leaf_ids[internal] = -(internal.astype(np.int32) + 1 + 1)

        nodes8 = np.zeros((mcap, 8), np.float32)
        nodes8[:, 0:3] = _BIG
        nodes8[:, 3:6] = -_BIG
        nodes8[:m, 0:3] = bvh.node_min
        nodes8[:m, 3:6] = bvh.node_max
        skips = np.full(mcap, m, np.int32)
        skips[:m] = bvh.node_skip
        nodes8[:, 6] = skips.view(np.float32)
        lids = np.zeros(mcap, np.int32)
        lids[:m] = leaf_ids
        nodes8[:, 7] = lids.view(np.float32)

        # Padding triangles stay all-zero (det == 0, never hit).
        clusters = np.zeros((lcap, CLUSTER_SIZE * TRI_STRIDE), np.float32)
        native_bridge.pack_clusters(verts, mats, bvh.order, bvh.node_tri,
                                    bvh.node_ntri, clusters, CLUSTER_SIZE,
                                    TRI_STRIDE)
        num_nodes = m
        counts = bvh.node_ntri[leaf_mask].astype(np.int32)

    nodes4, n4 = collapse4(nodes8, num_nodes, cluster_counts=counts)
    r4cap = _bucket(nodes4.shape[0])
    if nodes4.shape[0] < r4cap:
        nodes4 = np.concatenate(
            [nodes4, np.zeros((r4cap - nodes4.shape[0], CLUSTER_ROW),
                              np.float32)])
    return nodes8, clusters, nodes4, num_nodes, n4


def build_fast_scene_from_arrays(verts: np.ndarray, mats: np.ndarray,
                                 device="cuda") -> FastScene:
    """Pack a triangle soup (f32[T,3,3] verts, f32[T,4] rgb+type mats)
    into a FastScene on ``device``."""
    verts = np.asarray(verts, np.float32)
    mats = np.asarray(mats, np.float32)
    nodes8, clusters, nodes4, num_nodes, n4 = _host_tables(verts, mats)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FastScene(nodes8=put(nodes8), clusters=put(clusters),
                     nodes4=put(nodes4), num_nodes=int(num_nodes),
                     num_triangles=int(verts.shape[0]), num_nodes4=int(n4))


def fast_scene_from_numpy(leaves: dict, device="cuda") -> FastScene:
    """The JAX package's FastScene leaves (name -> np.asarray(leaf)) ->
    the port's FastScene on ``device``. Refuses a ``nodes4`` whose walk
    could push more than the kernels' STACK_CAP stack slots (a depth pass,
    as ``collapse4`` checks the trees it builds)."""
    need = nodes4_stack_need(np.asarray(leaves["nodes4"]))
    if need > STACK_CAP:
        raise ValueError(f"nodes4 would need {need} stack slots > "
                         f"STACK_CAP {STACK_CAP}")
    put = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return FastScene(nodes8=put(leaves["nodes8"]),
                     clusters=put(leaves["clusters"]),
                     nodes4=put(leaves["nodes4"]),
                     num_nodes=int(leaves["num_nodes"]),
                     num_triangles=int(leaves["num_triangles"]),
                     num_nodes4=int(leaves["num_nodes4"]))


def camera_uniforms_from_numpy(leaves: dict,
                               device="cuda") -> CameraUniforms:
    """The JAX package's CameraUniforms leaves (name -> np.asarray(leaf))
    -> the port's CameraUniforms on ``device`` (values taken as they are,
    already f32/i32)."""
    f32 = lambda k: torch.from_numpy(
        np.array(leaves[k], np.float32)).to(device)
    i32 = lambda k: torch.tensor(int(leaves[k]), dtype=torch.int32,
                                 device=device)
    return CameraUniforms(
        origin=f32("origin"), lower_left_corner=f32("lower_left_corner"),
        horizontal=f32("horizontal"), vertical=f32("vertical"),
        frame_count=i32("frame_count"), sky_enabled=i32("sky_enabled"),
        exposure=f32("exposure"), fc_host=int(leaves["frame_count"]),
        sky_host=bool(int(leaves["sky_enabled"])))

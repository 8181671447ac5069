"""Scene packing: instances -> triangle soup -> ``FastScene`` (packet
path) or ``GpuScene`` (per-ray path) tensors on a device.

``gather_triangles`` loads and transforms each instance (a mesh that
fails to load is skipped with a warning). The packers build the same
tables, with the same capacity buckets and padding, as
``raytracer_tpu.scene.builder`` under the same knobs: the host tree of
``RAYTPU_BVH`` (``bvh/build.py``), cluster packing in the native library
or, with ``RAYTPU_NATIVE=0``, in NumPy, and the 8-wide collapse with
each leaf's live count or, with ``RAYTPU_LEAF_COUNTS=0``, full counts;
leaf size 1 for the per-ray scene. Everything is NumPy or the native
library until the final ``torch.from_numpy(...).to(device)``. The table
layout is ``knobs.layout()`` (``RAYTPU_CLUSTER`` / ``RAYTPU_WIDE``), read
once a build and kept in the scene.

Also carries state across from the JAX package: ``fast_scene_from_numpy``,
``gpu_scene_from_numpy`` and ``camera_uniforms_from_numpy`` rebuild the
port's types from the JAX package's leaves (taken with ``np.asarray``),
so tests can feed both sides from the same tables.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from raytracer_tpu_torch import knobs, native_bridge
from raytracer_tpu_torch.bvh.build import build_bvh
from raytracer_tpu_torch.bvh.bvh4 import (STACK_CAP, collapse4,
                                          nodes4_stack_need)
from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, ROW_TRIS,
                                                 TRI_STRIDE, FastScene)
from raytracer_tpu_torch.core.types import CameraUniforms, FlatBVH, GpuScene
from raytracer_tpu_torch.scene.objloader import load_obj
from raytracer_tpu_torch.scene.scene import ModelInstance
from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("srt")

_MIN_CAPACITY = 64
_BIG = np.float32(1e30)


def bucket(n: int) -> int:
    """Smallest power-of-two capacity >= n (minimum 64)."""
    c = _MIN_CAPACITY
    while c < n:
        c *= 2
    return c


def gather_triangles(
    instances: Sequence[ModelInstance],
) -> tuple[np.ndarray, np.ndarray]:
    """Load + transform all instances -> (verts f32[T,3,3], mats f32[T,4]).
    An instance whose mesh fails to load is skipped with a warning; a knob
    the port refuses still raises."""
    all_verts = []
    all_mats = []
    for i, inst in enumerate(instances):
        try:
            tris = load_obj(inst.model_path)
        except NotImplementedError:
            raise
        except Exception as e:  # skip-and-continue policy
            _log.warning("failed to load model %s (%s): %s",
                         inst.display_name, inst.model_path, e)
            continue
        if tris.shape[0] == 0:
            continue
        tris = inst.transform(tris)
        mat = np.empty((tris.shape[0], 4), np.float32)
        mat[:, 0:3] = np.asarray(inst.color, np.float32)
        mat[:, 3] = inst.material_type
        all_verts.append(tris.astype(np.float32))
        all_mats.append(mat)
        _log.debug("instance [%d] %s: %d triangles", i, inst.display_name,
                   tris.shape[0])
    if not all_verts:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0, 4), np.float32)
    return np.concatenate(all_verts), np.concatenate(all_mats)


def _put(device):
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_gpu_scene(instances: Sequence[ModelInstance], leaf_size: int = 1,
                    device="cuda") -> GpuScene:
    """Instances -> the per-ray GpuScene on ``device``."""
    verts, mats = gather_triangles(instances)
    return build_gpu_scene_from_arrays(verts, mats, leaf_size=leaf_size,
                                       device=device)


def build_gpu_scene_from_arrays(verts: np.ndarray, mats: np.ndarray,
                                leaf_size: int = 1,
                                device="cuda") -> GpuScene:
    """Pack a transformed triangle soup into the per-ray GpuScene: the
    triangles in BVH order, padded to power-of-two buckets (the empty
    scene: one unreachable leaf and degenerate triangles)."""
    t0 = time.perf_counter()
    verts = np.asarray(verts, np.float32)
    mats = np.asarray(mats, np.float32)
    n = verts.shape[0]
    if n == 0:
        tcap = mcap = _MIN_CAPACITY
        host = dict(
            node_min=np.full((mcap, 3), _BIG, np.float32),
            node_max=np.full((mcap, 3), -_BIG, np.float32),
            node_tri=np.zeros(mcap, np.int32),
            node_skip=np.ones(mcap, np.int32),
            node_data=np.full(mcap, -1, np.int32),
            node_count=np.full(mcap, -1, np.int32))
        tri_verts = np.zeros((tcap, 3, 3), np.float32)
        materials = np.zeros((tcap, 4), np.float32)
        num_tris, num_nodes = 0, 1
    else:
        bvh = build_bvh(verts, leaf_size=leaf_size)
        n_refs = len(bvh.order)
        tcap = bucket(n_refs)
        mcap = bucket(bvh.num_nodes)
        tri_verts = np.zeros((tcap, 3, 3), np.float32)
        tri_verts[:n_refs] = verts[bvh.order]
        materials = np.zeros((tcap, 4), np.float32)
        materials[:n_refs] = mats[bvh.order]
        host = dict(
            node_min=np.full((mcap, 3), _BIG, np.float32),
            node_max=np.full((mcap, 3), -_BIG, np.float32),
            node_tri=np.zeros(mcap, np.int32),
            node_skip=np.full(mcap, bvh.num_nodes, np.int32),
            node_data=np.full(mcap, -1, np.int32),
            node_count=np.full(mcap, -1, np.int32))
        for k in host:
            host[k][:bvh.num_nodes] = getattr(bvh, k)
        num_tris, num_nodes = n_refs, bvh.num_nodes
    put = _put(device)
    scene = GpuScene(bvh=FlatBVH(**{k: put(v) for k, v in host.items()}),
                     tri_verts=put(tri_verts), materials=put(materials),
                     num_triangles=int(num_tris), num_nodes=int(num_nodes))
    _log.info("scene built: %d tris, %d nodes (caps %d/%d) in %.1f ms",
              num_tris, num_nodes, tcap, mcap,
              (time.perf_counter() - t0) * 1e3)
    return scene


def gpu_scene_from_numpy(leaves: dict, device="cuda") -> GpuScene:
    """The JAX package's GpuScene leaves (``FlatBVH`` field names, plus
    ``tri_verts``, ``materials``, ``num_triangles``, ``num_nodes``; each
    np.asarray'd) -> the port's GpuScene on ``device``."""
    put = lambda k, dt: torch.from_numpy(np.array(leaves[k], dt)).to(device)
    return GpuScene(
        bvh=FlatBVH(node_min=put("node_min", np.float32),
                    node_max=put("node_max", np.float32),
                    **{k: put(k, np.int32) for k in (
                        "node_tri", "node_skip", "node_data",
                        "node_count")}),
        tri_verts=put("tri_verts", np.float32),
        materials=put("materials", np.float32),
        num_triangles=int(leaves["num_triangles"]),
        num_nodes=int(leaves["num_nodes"]))


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


def _host_tables(verts: np.ndarray, mats: np.ndarray, cluster_size: int,
                 wide_width: int):
    """NumPy tables (nodes8, clusters, nodes4, num_nodes, num_nodes4) of
    the layout (``cluster_size``, ``wide_width``)."""
    n = verts.shape[0]
    if n == 0:
        mcap = _MIN_CAPACITY
        nodes8 = np.zeros((mcap, 8), np.float32)
        nodes8[:, 0:3] = _BIG
        nodes8[:, 3:6] = -_BIG
        nodes8[:, 6] = np.full((), 1, np.int32).view(np.float32)  # skip
        nodes8[:, 7] = np.full((), 0, np.int32).view(np.float32)  # leaf 0
        # The minimum bucket's table shape: _MIN_CAPACITY leaves.
        clusters = np.zeros((_MIN_CAPACITY * cluster_size // ROW_TRIS,
                             CLUSTER_ROW), np.float32)
        num_nodes = 1
        counts = np.ones(1, np.int32)
    else:
        bvh = build_bvh(verts, leaf_size=cluster_size)
        m = bvh.num_nodes
        mcap = bucket(m)
        leaf_mask = bvh.node_tri >= 0
        num_leaves = int(leaf_mask.sum())
        lcap = bucket(num_leaves)

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

        # One leaf of cluster_size records a row, regrouped below into
        # 128-float table rows (8 / cluster_size leaves a row; lcap is a
        # power of two >= 64, so it divides). Padding triangles stay
        # all-zero (det == 0, never hit).
        clusters = np.zeros((lcap, cluster_size * TRI_STRIDE), np.float32)
        if knobs.native():
            native_bridge.pack_clusters(verts, mats, bvh.order,
                                        bvh.node_tri, bvh.node_ntri,
                                        clusters, cluster_size, TRI_STRIDE)
        else:
            records = pack_tri_records(verts[bvh.order].reshape(-1, 9),
                                       mats[bvh.order])
            for li, node in enumerate(np.nonzero(leaf_mask)[0]):
                start = int(bvh.node_tri[node])
                count = int(bvh.node_ntri[node])
                row = clusters[li].reshape(cluster_size, TRI_STRIDE)
                row[:count] = records[start:start + count]
        clusters = clusters.reshape(-1, CLUSTER_ROW)
        num_nodes = m
        counts = bvh.node_ntri[leaf_mask].astype(np.int32)

    nodes4, n4 = collapse4(nodes8, num_nodes, cluster_counts=(
        counts if knobs.leaf_counts() else None), cluster_size=cluster_size,
        width=wide_width)
    r4cap = bucket(nodes4.shape[0])
    if nodes4.shape[0] < r4cap:
        nodes4 = np.concatenate(
            [nodes4, np.zeros((r4cap - nodes4.shape[0], CLUSTER_ROW),
                              np.float32)])
    return nodes8, clusters, nodes4, num_nodes, n4


def build_fast_scene(instances: Sequence[ModelInstance],
                     device="cuda") -> FastScene:
    """Instances -> the packet path's FastScene on ``device``."""
    verts, mats = gather_triangles(instances)
    return build_fast_scene_from_arrays(verts, mats, device=device)


def build_fast_scene_from_arrays(verts: np.ndarray, mats: np.ndarray,
                                 device="cuda") -> FastScene:
    """Pack a triangle soup (f32[T,3,3] verts, f32[T,4] rgb+type mats)
    into a FastScene on ``device``, in the layout of ``knobs.layout()``."""
    t0 = time.perf_counter()
    verts = np.asarray(verts, np.float32)
    mats = np.asarray(mats, np.float32)
    cs, ww = knobs.layout()
    nodes8, clusters, nodes4, num_nodes, n4 = _host_tables(verts, mats, cs,
                                                           ww)
    put = _put(device)
    fs = FastScene(nodes8=put(nodes8), clusters=put(clusters),
                   nodes4=put(nodes4), num_nodes=int(num_nodes),
                   num_triangles=int(verts.shape[0]), num_nodes4=int(n4),
                   cluster_size=cs, wide_width=ww)
    _log.info("fast scene packed: %d tris, %d nodes in %.1f ms",
              verts.shape[0], num_nodes, (time.perf_counter() - t0) * 1e3)
    return fs


def fast_scene_from_numpy(leaves: dict, device="cuda",
                          layout: tuple[int, int] | None = None
                          ) -> FastScene:
    """The JAX package's FastScene leaves (name -> np.asarray(leaf); no
    ``nodes4`` / ``num_nodes4`` where that scene has no wide table) ->
    the port's FastScene on ``device``, in ``layout`` (cluster size, wide
    width; default ``knobs.layout()``, the knobs the tables were built
    under). Refuses a ``nodes4`` whose walk could push more than the
    kernels' STACK_CAP stack slots (a depth pass, as ``collapse4`` checks
    the trees it builds)."""
    cs, ww = knobs.layout() if layout is None else layout
    nodes4 = leaves.get("nodes4")
    if nodes4 is not None:
        need = nodes4_stack_need(np.asarray(nodes4), ww)
        if need > STACK_CAP:
            raise ValueError(f"nodes4 would need {need} stack slots > "
                             f"STACK_CAP {STACK_CAP}")
    put = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return FastScene(nodes8=put(leaves["nodes8"]),
                     clusters=put(leaves["clusters"]),
                     nodes4=None if nodes4 is None else put(nodes4),
                     num_nodes=int(leaves["num_nodes"]),
                     num_triangles=int(leaves["num_triangles"]),
                     num_nodes4=(None if nodes4 is None
                                 else int(leaves["num_nodes4"])),
                     cluster_size=cs, wide_width=ww)


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

"""Two-level instanced BVH: cached per-mesh SAH trees (BLAS) and a TLAS
combine program, as PyTorch tensor code on the BLAS tensors' device.

The port of ``raytracer_tpu/scene/instanced.py``. Each distinct mesh gets
one host SAH build in mesh space (``prep_mesh_blas``, cached by the
caller and resident on the device). An edit runs ``combine_instanced``:
per instance it scales and translates the node boxes (an axis-aligned
scale + translate maps a box to a box exactly, so tree quality is the
host SAH path's), re-bakes colour and material into the triangle
records, offsets the link columns and grafts the instance tables under a
small top level. No sort and no hierarchy build per edit.

Both table layouts are emitted, as in the JAX package:

* binary ``nodes8``: instance blocks in pre-order behind a right-leaning
  chain of K-1 top nodes T_0..T_{K-2} (T_j's left child is instance j,
  its right child T_{j+1}), so T_j's left child is the next row and
  every local skip, the past-the-end sentinel M_j included, maps to
  global as ``skip + off_j``;
* wide ``nodes4``: the instance tables behind one top node (K <= W, the
  wide width) or a root node and ceil(K/W) group nodes (K <= 64), slot
  metas offset per instance (internal ids by the node offset, leaf
  cluster ids by the cluster offset).

The layout is the BLASes' (``knobs.layout()`` when ``prep_mesh_blas``
built them): W-wide nodes of W / 8 table rows each, and leaves of
``cluster_size`` records regrouped into 128-float cluster rows.

Link columns are offset in i32 and viewed as f32 once; wide metas are
float-encoded exact ints (|meta| < 2^23), converted (not bitcast) to i32,
offset and converted back. Every count is a host int known before the
program runs (from the BLAS), so a combine reads nothing back from the
card; its constants (the top rows' metas) go up in one non-blocking copy.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from raytracer_tpu_torch.bvh.build import build_bvh
from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.bvh.bvh4 import STACK_CAP, collapse4, stack_need
from raytracer_tpu_torch.bvh.lbvh import tri_normals
from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, LEAF_CID_BITS,
                                                 LEAF_CID_MASK, TRI_STRIDE,
                                                 FastScene)
from raytracer_tpu_torch.core.types import to_device
from raytracer_tpu_torch.scene.builder import bucket

MAX_INSTANCES = 64  # 2 TLAS levels; beyond this use another build


@dataclasses.dataclass(frozen=True)
class MeshBLAS:
    """Device-resident mesh-space acceleration tables (built once)."""

    bin_lo: torch.Tensor     # f32[M, 3]
    bin_hi: torch.Tensor     # f32[M, 3]
    bin_skip: torch.Tensor   # i32[M] local skip (sentinel M = leave mesh)
    bin_col7: torch.Tensor   # i32[M] local leaf cid >= 0 / -(left+1)
    wide: torch.Tensor       # f32[W, width, 16] mesh-space wide table
    rec: torch.Tensor        # f32[L, cluster_size, 9] v0|e1|e2 records
    num_nodes: int           # M
    num_wide: int            # W
    num_clusters: int        # L
    num_triangles: int
    wide_depth: int          # wide-tree depth (stack-bound bookkeeping)

    TENSORS = ("bin_lo", "bin_hi", "bin_skip", "bin_col7", "wide", "rec")
    COUNTS = ("num_nodes", "num_wide", "num_clusters", "num_triangles",
              "wide_depth")

    @property
    def layout(self) -> tuple[int, int]:
        """(cluster_size, wide_width) of the tables."""
        return self.rec.shape[1], self.wide.shape[1]


def prep_mesh_blas(verts: np.ndarray, device="cuda") -> MeshBLAS:
    """One host SAH build of a mesh-space BLAS, put on ``device``, in the
    layout of ``knobs.layout()``."""
    verts = np.asarray(verts, np.float32)
    if verts.shape[0] == 0:
        raise ValueError("prep_mesh_blas needs a non-empty mesh")
    cs, ww = knobs.layout()
    bvh = build_bvh(verts, leaf_size=cs)
    m = bvh.num_nodes

    leaf_mask = bvh.node_tri >= 0
    num_leaves = int(leaf_mask.sum())
    leaf_ids = np.empty(m, np.int32)
    leaf_ids[leaf_mask] = np.arange(num_leaves, dtype=np.int32)
    internal = np.nonzero(~leaf_mask)[0]
    leaf_ids[internal] = -(internal.astype(np.int32) + 1 + 1)

    nodes8 = np.zeros((m, 8), np.float32)
    nodes8[:, 0:3] = bvh.node_min
    nodes8[:, 3:6] = bvh.node_max
    nodes8[:, 6] = bvh.node_skip.astype(np.int32).view(np.float32)
    nodes8[:, 7] = leaf_ids.view(np.float32)
    counts = bvh.node_ntri[leaf_mask].astype(np.int32)
    wide, n_wide, depth = collapse4(nodes8, m, cluster_counts=counts,
                                    cluster_size=cs, width=ww,
                                    return_depth=True)

    # Mesh-space records v0 | e1 | e2 in leaf order, padded to
    # cluster_size a cluster with zero (degenerate, never hit) rows; the
    # combine bakes the instance material and the normals.
    ordered = verts[bvh.order].reshape(-1, 9)
    rec = np.zeros((num_leaves, cs, 9), np.float32)
    for li, node in enumerate(np.nonzero(leaf_mask)[0]):
        start = int(bvh.node_tri[node])
        v9 = ordered[start:start + int(bvh.node_ntri[node])]
        rec[li, :len(v9), 0:3] = v9[:, 0:3]
        rec[li, :len(v9), 3:6] = v9[:, 3:6] - v9[:, 0:3]
        rec[li, :len(v9), 6:9] = v9[:, 6:9] - v9[:, 0:3]
    return mesh_blas_from_numpy(dict(
        bin_lo=bvh.node_min, bin_hi=bvh.node_max,
        bin_skip=bvh.node_skip.astype(np.int32), bin_col7=leaf_ids,
        wide=wide.reshape(-1, ww, 16)[:n_wide], rec=rec,
        num_nodes=m, num_wide=n_wide, num_clusters=num_leaves,
        num_triangles=verts.shape[0], wide_depth=depth), device)


def mesh_blas_from_numpy(leaves: dict, device="cuda") -> MeshBLAS:
    """A MeshBLAS from NumPy leaves (the port's own, or the JAX
    package's taken with ``np.asarray``), on ``device``."""
    return MeshBLAS(
        **{k: torch.from_numpy(np.array(leaves[k])).to(device)
           for k in MeshBLAS.TENSORS},
        **{k: int(leaves[k]) for k in MeshBLAS.COUNTS})


def _tlas_plan(k: int, width: int):
    """Static wide-TLAS shape -> (n_top_nodes, groups): one top node
    whose slots are the instance roots (k <= width), or a root node over
    ceil(k/width) group nodes (k <= 64); groups[g] lists instance
    indices."""
    if k <= width:
        return 1, [list(range(k))]
    groups = [list(range(g, min(g + width, k)))
              for g in range(0, k, width)]
    if len(groups) > width:
        raise ValueError(f"{k} instances > MAX_INSTANCES {MAX_INSTANCES}")
    return 1 + len(groups), groups


def _transform_bounds(lo, hi, scale, pos):
    """Exact AABB image under x -> x * scale + pos (sign-safe)."""
    a = lo * scale
    b = hi * scale
    return torch.minimum(a, b) + pos, torch.maximum(a, b) + pos


def _instance_tables(blas: MeshBLAS, p, boff, woff, cloff):
    """One instance's transformed pieces: (binary lo, hi, skip, col7,
    wide rows f32[W * width / 8, 128], leaf records f32[L, cluster_size
    * 16]). ``p`` f32[10] = scale3 pos3 color3 mtype; ``boff`` / ``woff``
    / ``cloff`` its binary row, wide node and cluster offsets."""
    scale, pos, color, mtype = p[0:3], p[3:6], p[6:9], p[9:10]
    lo, hi = _transform_bounds(blas.bin_lo, blas.bin_hi, scale, pos)
    # Local skip -> global: + block offset (the sentinel M_j lands on
    # T_{j+1} / the global end by construction). col7: a leaf cid moves
    # by the cluster offset, an internal -(left+1) by the block offset.
    skip = blas.bin_skip + boff
    col7 = torch.where(blas.bin_col7 >= 0, blas.bin_col7 + cloff,
                       blas.bin_col7 - boff)

    wide = blas.wide
    w, width = wide.shape[0], wide.shape[1]
    wlo, whi = _transform_bounds(wide[:, :, 0:3], wide[:, :, 3:6], scale,
                                 pos)
    meta = wide[:, :, 6].to(torch.int32)
    enc = -meta - 1
    leaf_meta = -(((enc & LEAF_CID_MASK) + cloff)
                  | (enc & ~LEAF_CID_MASK)) - 1
    meta_g = torch.where(meta > 0, meta + woff,
                         torch.where(meta < 0, leaf_meta, 0))
    wide_rows = torch.cat([
        wlo, whi, meta_g.to(torch.float32)[:, :, None],
        torch.zeros((w, width, 9), device=wide.device)], 2
    ).reshape(-1, CLUSTER_ROW)

    # Records v0*s+p | e1*s | e2*s | albedo | type | normal; padding rows
    # have e1 == e2 == 0 and stay degenerate.
    cs = blas.rec.shape[1]
    n = blas.rec.shape[0] * cs
    flat = blas.rec.reshape(n, 9)
    v0 = flat[:, 0:3] * scale + pos
    e1 = flat[:, 3:6] * scale
    e2 = flat[:, 6:9] * scale
    row16 = torch.cat([v0, e1, e2, color.expand(n, 3), mtype.expand(n, 1),
                       tri_normals(e1, e2)], 1)
    return (lo, hi, skip, col7, wide_rows,
            row16.reshape(-1, cs * TRI_STRIDE))


def _wide_row(child_lo, child_hi, metas):
    """One top node: up to ``width`` child boxes (zero-padded) and metas
    f32[width] -> f32[width / 8, 128]."""
    width = metas.shape[0]
    pad = torch.zeros((width - child_lo.shape[0], 3),
                      device=child_lo.device)
    return torch.cat([
        torch.cat([child_lo, pad]), torch.cat([child_hi, pad]),
        metas[:, None], torch.zeros((width, 9), device=pad.device)],
        1).reshape(-1, CLUSTER_ROW)


def combine_instanced(blases: Sequence[MeshBLAS],
                      params: torch.Tensor) -> FastScene:
    """BLASes + per-instance params f32[K, 10] (scale3 pos3 color3 mtype,
    on the BLASes' device) -> FastScene in the BLASes' layout, tables
    padded to power-of-two capacities as the JAX combine pads them."""
    k = len(blases)
    if not 1 <= k <= MAX_INSTANCES:
        raise ValueError(f"combine_instanced takes 1..{MAX_INSTANCES} "
                         f"instances, got {k}")
    layouts = {b.layout for b in blases}
    if len(layouts) != 1:
        raise ValueError(f"BLASes of different layouts {sorted(layouts)}")
    cs, width = layouts.pop()
    n_top_wide, groups = _tlas_plan(k, width)
    # Stack bound: the TLAS adds 1-2 wide levels above every BLAS.
    worst = stack_need(max(b.wide_depth for b in blases) + n_top_wide - 1,
                       width)
    if worst > STACK_CAP:
        raise ValueError(f"instanced wide depth needs {worst} stack slots "
                         f"> STACK_CAP {STACK_CAP}")
    dev = params.device

    # Offsets. Binary: T_0, B_0, T_1, B_1, ..., T_{k-2}, B_{k-2}, B_{k-1}.
    boffs, woffs, cloffs = [], [], []
    row, wrow, crow = 0, n_top_wide, 0
    for j, b in enumerate(blases):
        row += 1 if j <= k - 2 else 0
        boffs.append(row)
        woffs.append(wrow)
        cloffs.append(crow)
        row += b.num_nodes
        wrow += b.num_wide
        crow += b.num_clusters
    m_total, w_total, l_total = row, wrow, crow
    if l_total > (1 << LEAF_CID_BITS):
        raise ValueError(f"{l_total} clusters > 2^{LEAF_CID_BITS}")

    parts = [_instance_tables(b, params[j], boffs[j], woffs[j], cloffs[j])
             for j, b in enumerate(blases)]
    root_lo = torch.stack([p[0][0] for p in parts])
    root_hi = torch.stack([p[1][0] for p in parts])

    # Binary TLAS chain: T_j covers instances j..K-1 (suffix unions),
    # skips to the global end, its left child is the next row.
    suf_lo, suf_hi = [root_lo[k - 1]], [root_hi[k - 1]]
    for j in range(k - 2, -1, -1):
        suf_lo.append(torch.minimum(root_lo[j], suf_lo[-1]))
        suf_hi.append(torch.maximum(root_hi[j], suf_hi[-1]))
    suf_lo, suf_hi = suf_lo[::-1], suf_hi[::-1]

    i32 = dict(dtype=torch.int32, device=dev)
    rows8 = []
    for j, (lo, hi, skip, col7, _, _) in enumerate(parts):
        if j <= k - 2:
            rows8.append(torch.cat([
                suf_lo[j].view(torch.int32), suf_hi[j].view(torch.int32),
                torch.full((1,), m_total, **i32),
                torch.full((1,), -(boffs[j] + 1), **i32)])[None])
        rows8.append(torch.cat([lo.view(torch.int32), hi.view(torch.int32),
                                skip[:, None], col7[:, None]], 1))
    pad = bucket(m_total) - m_total
    if pad:
        big = torch.full((pad, 3), 1e30, device=dev)
        rows8.append(torch.cat([
            big.view(torch.int32), (-big).view(torch.int32),
            torch.full((pad, 1), m_total, **i32),
            torch.zeros((pad, 1), **i32)], 1))
    nodes8 = torch.cat(rows8).view(torch.float32)

    # Wide TLAS rows; their metas are static, one copy to the device.
    top_meta = np.zeros((n_top_wide, width), np.float32)
    if n_top_wide == 1:
        top_meta[0, :k] = [woffs[j] + 1 for j in range(k)]
    else:
        top_meta[0, :len(groups)] = [1 + g + 1 for g in range(len(groups))]
        for g, members in enumerate(groups):
            top_meta[1 + g, :len(members)] = [woffs[j] + 1
                                              for j in members]
    top_meta = to_device(top_meta, dev)
    if n_top_wide == 1:
        top_rows = [_wide_row(root_lo, root_hi, top_meta[0])]
    else:
        spans = [(g[0], g[-1] + 1) for g in groups]
        top_rows = [_wide_row(
            torch.stack([root_lo[a:b].amin(0) for a, b in spans]),
            torch.stack([root_hi[a:b].amax(0) for a, b in spans]),
            top_meta[0])]
        top_rows += [_wide_row(root_lo[a:b], root_hi[a:b], top_meta[1 + g])
                     for g, (a, b) in enumerate(spans)]
    wpad = bucket(w_total) - w_total
    nodes4 = torch.cat(top_rows + [p[4] for p in parts] + [torch.zeros(
        (wpad * width * 16 // CLUSTER_ROW, CLUSTER_ROW), device=dev)])

    # Leaf records in global cid order, regrouped into 128-float rows
    # (the cluster capacity is a power of two >= 64, so they divide).
    cpad = bucket(l_total) - l_total
    clusters = torch.cat(
        [p[5] for p in parts]
        + [torch.zeros((cpad, cs * TRI_STRIDE), device=dev)]
    ).reshape(-1, CLUSTER_ROW)
    return FastScene(nodes8=nodes8, clusters=clusters, nodes4=nodes4,
                     num_nodes=m_total,
                     num_triangles=sum(b.num_triangles for b in blases),
                     num_nodes4=w_total, cluster_size=cs, wide_width=width)


def pack_params(params) -> np.ndarray:
    """[(scale3, pos3, color3, mtype), ...] -> f32[I, 10]."""
    out = np.zeros((len(params), 10), np.float32)
    for i, (scale, pos, color, mtype) in enumerate(params):
        out[i, 0:3] = np.asarray(scale, np.float32).reshape(3)
        out[i, 3:6] = np.asarray(pos, np.float32).reshape(3)
        out[i, 6:9] = np.asarray(color, np.float32).reshape(3)
        out[i, 9] = np.float32(np.asarray(mtype).reshape(()))
    return out

"""Per-edit device BVH refit over a fixed captured topology, as PyTorch
tensor code on the capture's device.

The port of ``raytracer_tpu/scene/refit.py``:

* **capture** (host, once per instance set): one good tree over the
  transformed soup (host PLOC or SAH, ``RAYTPU_REFIT_TOPO``), and from it
  every static table the edit program needs: the triangle -> leaf-slot
  assignment, the pre-order skip / col7 link columns, the leaf-rank range
  [first, last] under every node row, and the wide table's per-slot
  binary-row map and static metas;
* **refit** (device, per edit): transform the base-space slot vertices
  with the new instance params, recompute leaf boxes, answer every node
  box as a sparse-table range min/max over leaf ranks (``lbvh.
  _range_minmax``) and reassemble the node and cluster tables. No sort
  and no tree build: topology is data.

Ranges work for any host tree: a pre-order flatten with skip links puts
node row i's subtree at rows [i, skip[i]), whose leaves are contiguous in
leaf-rank order. Every count is a host int fixed at capture, so a refit
reads nothing back from the card; its params go up in one non-blocking
copy.

The capture reads the table layout (``knobs.layout()``): leaves of
``RAYTPU_CLUSTER`` records, and 8-wide nodes only. Under
``RAYTPU_WIDE=16`` it refuses with a ``ValueError`` (the JAX capture
asserts width 8, ``raytracer_tpu/scene/refit.py:282``), which the device
builder takes as "no capture" and builds an LBVH instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.bvh.build import AABB_EPS, build_bvh
from raytracer_tpu_torch.bvh.bvh4 import collapse4
from raytracer_tpu_torch.bvh.lbvh import _range_minmax, tri_normals
from raytracer_tpu_torch.core.fast_types import CLUSTER_ROW, FastScene
from raytracer_tpu_torch.core.types import to_device
from raytracer_tpu_torch.scene.builder import bucket
from raytracer_tpu_torch.scene.instanced import pack_params
from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("srt")

_BIG = np.float32(1e30)

# The capture's device tables, in ``_refit_program``'s argument order.
TABLES = ("v_base", "inst_slot", "slot_valid", "skip_col", "col7_col",
          "first", "last", "row_valid", "wide_rows", "wide_meta")
COUNTS = ("num_nodes", "n_wide", "num_tris")
WIDTH = 8   # the wide tables a capture emits


def _refit_program(v_base, inst_slot, slot_valid, skip_col, col7_col,
                   first, last, row_valid, wide_rows, wide_meta, params,
                   num_nodes: int, n_wide: int, num_tris: int,
                   cluster_size: int) -> FastScene:
    """One edit -> FastScene. Static tables (uploaded once per capture):
    v_base f32[S, 9] base-space slot vertices (S = lcap * cluster_size),
    inst_slot
    i64[S], slot_valid f32[S], skip / col7 i32[mcap], first / last
    i64[mcap] leaf-rank ranges, row_valid f32[mcap], wide_rows
    i64[R4, 8], wide_meta f32[R4, 8]; ``params`` f32[I, 10] = scale3
    pos3 color3 mtype."""
    s = v_base.shape[0]
    lcap = s // cluster_size
    mcap = skip_col.shape[0]

    p = params[inst_slot]
    sc, po, col, mt = p[:, 0:3], p[:, 3:6], p[:, 6:9], p[:, 9]
    v = v_base.reshape(s, 3, 3) * sc[:, None, :] + po[:, None, :]

    # Per-triangle boxes (epsilon-padded thin axes); empty slots are the
    # neutral elements of the leaf min / max.
    lo_t = v.amin(1)
    hi_t = v.amax(1)
    thin = (hi_t - lo_t) < AABB_EPS
    lo_t = torch.where(thin, lo_t - AABB_EPS, lo_t)
    hi_t = torch.where(thin, hi_t + AABB_EPS, hi_t)
    live = slot_valid[:, None] > 0.0
    lo_t = torch.where(live, lo_t, float(_BIG))
    hi_t = torch.where(live, hi_t, float(-_BIG))
    leaf_lo = lo_t.reshape(lcap, cluster_size, 3).amin(1)
    leaf_hi = hi_t.reshape(lcap, cluster_size, 3).amax(1)

    # Every node row's box is a range min / max over leaf ranks (a leaf
    # row covers its own rank).
    axes = [_range_minmax(leaf_lo[:, ax], leaf_hi[:, ax], first, last)
            for ax in range(3)]
    rv = row_valid[:, None] > 0.0
    row_lo = torch.where(rv, torch.stack([a[0] for a in axes], 1),
                         float(_BIG))
    row_hi = torch.where(rv, torch.stack([a[1] for a in axes], 1),
                         float(-_BIG))
    nodes8 = torch.cat([row_lo.view(torch.int32), row_hi.view(torch.int32),
                        skip_col[:, None], col7_col[:, None]], 1
                       ).view(torch.float32)

    # Wide slot boxes gather through the static binary-row map; metas are
    # static (leaf counts do not change under a refit).
    r4 = wide_rows.shape[0]
    wr = wide_rows.clamp(0, mcap - 1)
    wv = (wide_rows >= 0).to(torch.float32)[:, :, None]
    nodes4 = torch.cat([
        row_lo[wr] * wv, row_hi[wr] * wv, wide_meta[:, :, None],
        torch.zeros((r4, WIDTH, 9), device=v_base.device)], 2
    ).reshape(r4, CLUSTER_ROW)

    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    row16 = torch.cat([v0, e1, e2, col, mt[:, None], tri_normals(e1, e2)],
                      1) * slot_valid[:, None]
    return FastScene(nodes8=nodes8, clusters=row16.reshape(-1, CLUSTER_ROW),
                     nodes4=nodes4, num_nodes=num_nodes,
                     num_triangles=num_tris, num_nodes4=n_wide,
                     cluster_size=cluster_size, wide_width=WIDTH)


@dataclasses.dataclass
class RefitScene:
    """Captured topology + device tables; ``refit(params)`` per edit."""

    tables: dict             # TABLES -> device tensors
    counts: dict             # COUNTS -> host ints
    n_instances: int
    num_triangles: int
    cluster_size: int        # the leaves' records (the table layout)
    edits: int = 0           # refits served since capture (refresh)

    @property
    def device(self) -> torch.device:
        return self.tables["v_base"].device

    def refit(self, params) -> FastScene:
        """params: per-instance (scale3, pos3, color3, mtype) tuples, or
        f32[I, 10] already on the device, in the captured order."""
        if not isinstance(params, torch.Tensor):
            params = to_device(pack_params(params), self.device)
        if params.shape[0] != self.n_instances:
            raise ValueError(f"refit of {params.shape[0]} instances, "
                             f"captured {self.n_instances}")
        self.edits += 1
        return _refit_program(*(self.tables[k] for k in TABLES), params,
                              *(self.counts[k] for k in COUNTS),
                              self.cluster_size)


def refit_scene_from_numpy(leaves: dict, device="cuda") -> RefitScene:
    """A RefitScene from NumPy leaves (TABLES, COUNTS, ``n_instances``
    and ``cluster_size``; the port's capture, or the JAX package's taken
    with ``np.asarray``, whose cluster size is ``knobs.layout()``'s when
    the leaves carry none), on ``device``. Index tables become int64
    (torch's index dtype)."""
    idx = ("inst_slot", "first", "last", "wide_rows")
    tables = {}
    for k in TABLES:
        a = np.array(leaves[k])
        tables[k] = torch.from_numpy(
            a.astype(np.int64) if k in idx else a).to(device)
    counts = {k: int(leaves[k]) for k in COUNTS}
    cs = (int(leaves["cluster_size"]) if "cluster_size" in leaves
          else knobs.layout()[0])
    return RefitScene(tables=tables, counts=counts,
                      n_instances=int(leaves["n_instances"]),
                      num_triangles=counts["num_tris"], cluster_size=cs)


def capture_tables(meshes: Sequence[np.ndarray], params,
                   method: str | None = None) -> dict:
    """Host topology capture -> NumPy leaves for
    ``refit_scene_from_numpy``.

    meshes: per-instance base-space f32[Ti, 3, 3]; params: per-instance
    (scale3, pos3, color3, mtype) at capture time (tree quality is
    anchored to this pose); method: the host tree, default
    ``RAYTPU_REFIT_TOPO`` ("ploc"; "sah" costs more to capture and walks
    best). Raises ValueError for an empty scene, one under 2 leaves, or
    the 16-wide layout."""
    if method is None:
        method = knobs.refit_topo()
    cs, ww = knobs.layout()
    if ww != WIDTH:
        raise ValueError(f"RAYTPU_WIDE={ww}: the refit capture emits "
                         f"{WIDTH}-wide tables only")
    counts = [int(m.shape[0]) for m in meshes]
    n = int(sum(counts))
    if n == 0:
        raise ValueError("refit capture needs a non-empty scene")
    base = np.concatenate([np.asarray(m, np.float32).reshape(-1, 3, 3)
                           for m in meshes])
    tri_inst = np.repeat(np.arange(len(meshes), dtype=np.int32), counts)
    p = pack_params(params)
    verts0 = (base * p[tri_inst, 0:3][:, None, :]
              + p[tri_inst, 3:6][:, None, :]).astype(np.float32)

    bvh = build_bvh(verts0, leaf_size=cs, method=method)
    m = bvh.num_nodes
    leaf_mask = bvh.node_tri >= 0
    num_leaves = int(leaf_mask.sum())
    if num_leaves < 2:
        raise ValueError("refit capture needs >= 2 leaves")
    mcap = bucket(m)
    lcap = bucket(num_leaves)

    # Static link columns (the host builder's encoding).
    skip_col = np.full(mcap, m, np.int32)
    skip_col[:m] = bvh.node_skip
    col7_col = np.zeros(mcap, np.int32)
    internal = np.nonzero(~leaf_mask)[0]
    col7_col[:m][leaf_mask] = np.arange(num_leaves, dtype=np.int32)
    col7_col[:m][internal] = -(internal.astype(np.int32) + 1 + 1)
    row_valid = np.zeros(mcap, np.float32)
    row_valid[:m] = 1.0

    # Leaf-rank ranges: a node's pre-order subtree is rows [i, skip[i]),
    # its leaves contiguous in rank; a leaf row covers itself.
    prefix = np.cumsum(leaf_mask.astype(np.int64))
    rank = (prefix - 1).astype(np.int32)
    skip_idx = np.clip(bvh.node_skip.astype(np.int64) - 1, 0, m - 1)
    first = np.zeros(mcap, np.int32)
    last = np.zeros(mcap, np.int32)
    first[:m] = np.where(leaf_mask, rank, prefix.astype(np.int32))
    last[:m] = np.where(leaf_mask, rank,
                        (prefix[skip_idx] - 1).astype(np.int32))

    # Triangle -> leaf slot (cluster rows in leaf-rank order, the host
    # packers' cid order).
    slot_tri = np.full(lcap * cs, -1, np.int64)
    leaf_rows = np.nonzero(leaf_mask)[0]
    starts = bvh.node_tri[leaf_rows].astype(np.int64)
    ntris = bvh.node_ntri[leaf_rows].astype(np.int64)
    for t in range(cs):
        has = ntris > t
        slot_tri[np.arange(num_leaves) * cs + t] = np.where(
            has, bvh.order[np.where(has, starts + t, 0)], -1)
    valid = slot_tri >= 0
    safe = np.where(valid, slot_tri, 0)

    # Wide statics from the host collapse, with each slot's binary row.
    nodes8 = np.zeros((mcap, 8), np.float32)
    nodes8[:, 0:3] = _BIG
    nodes8[:, 3:6] = -_BIG
    nodes8[:m, 0:3] = bvh.node_min
    nodes8[:m, 3:6] = bvh.node_max
    nodes8[:, 6] = skip_col.view(np.float32)
    nodes8[:, 7] = col7_col.view(np.float32)
    nodes4, n4, slot_rows = collapse4(
        nodes8, m, cluster_counts=(bvh.node_ntri[leaf_mask].astype(np.int32)
                                   if knobs.leaf_counts() else None),
        cluster_size=cs, width=WIDTH, return_slots=True)
    r4cap = bucket(nodes4.shape[0])
    wide_rows = np.full((r4cap, WIDTH), -1, np.int32)
    wide_rows[:n4] = slot_rows
    wide_meta = np.zeros((r4cap, WIDTH), np.float32)
    wide_meta[:nodes4.shape[0]] = nodes4.reshape(-1, WIDTH, 16)[:, :, 6]
    return dict(
        v_base=(base.reshape(-1, 9)[safe] * valid[:, None]).astype(
            np.float32),
        inst_slot=np.where(valid, tri_inst[safe], 0).astype(np.int32),
        slot_valid=valid.astype(np.float32), skip_col=skip_col,
        col7_col=col7_col, first=first, last=last, row_valid=row_valid,
        wide_rows=wide_rows, wide_meta=wide_meta, num_nodes=m, n_wide=n4,
        num_tris=n, n_instances=len(meshes), cluster_size=cs)


def capture_refit(meshes: Sequence[np.ndarray], params,
                  method: str | None = None, device="cuda") -> RefitScene:
    """``capture_tables`` put on ``device`` as a RefitScene."""
    t0 = time.perf_counter()
    leaves = capture_tables(meshes, params, method)
    rs = refit_scene_from_numpy(leaves, device)
    _log.info("refit capture (%s): %d tris, %d nodes, %d wide in %.1f ms",
              method or knobs.refit_topo(), leaves["num_tris"],
              leaves["num_nodes"], leaves["n_wide"],
              (time.perf_counter() - t0) * 1e3)
    return rs

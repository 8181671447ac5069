"""On-device LBVH: Morton codes, sort, Karras radix tree, as PyTorch tensor
code on the tensors' device.

The port of ``raytracer_tpu/bvh/lbvh.py``: the whole scene build of a
triangle soup (per-triangle boxes, 30-bit Morton codes of their centroids,
a stable sort, the Karras 2012 binary radix tree over runs of
``cluster_size`` sorted triangles, range-min/max node boxes from a sparse
table, escape links by pointer doubling, the 8-wide emit and the cluster
records) runs as dense tensor ops, so a live edit never round-trips
geometry through the host. The tables are the JAX package's, byte for
byte on the CPU (normals to 2 ulp), in the layout of ``knobs.layout()``:
leaves of ``RAYTPU_CLUSTER`` sorted triangles (subclusters of the
128-float cluster rows below 8), and under ``RAYTPU_WIDE=16`` no wide
table at all (the emit is 8-wide only; JAX ``lbvh.py:423-430``), so the
frame walks the binary table.

What differs from the JAX code, and why the result does not:

* u32 arithmetic (Morton interleave, clz, the index tie-break) runs in
  int64 with ``& 0xFFFFFFFF``: torch has no u32 multiply or shift on the
  CPU. Codes are < 2^30, so every masked int64 result equals the u32 one.
* The Karras searches (``fori_loop`` of 32 and two ``while_loop``s on
  ``any(t > 0)``) run ``_search_steps(l)`` fixed steps: a step with
  ``t == 0`` (or a range that stopped growing) changes nothing, and
  ``l.bit_length() + 2`` steps reach that state for every lane (see
  ``_search_steps``), so there is no host read per step.
* The wide table's ``.at[...].set(rows, mode="drop")`` becomes an
  ``index_copy_`` into one extra dump row that is then cut off (torch has
  no drop mode; a masked select would read its size on the host).
* Link columns are assembled in i32 and viewed as f32 once.

``build_fast_scene_device`` reads two device scalars on the host, once
per build and in one copy: the wide node count (the port's ``FastScene``
holds host counts) and the wide tree's depth, for the stack bound the
host builders check in ``collapse4`` (none at width 16: no wide table).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.bvh.build import AABB_EPS
from raytracer_tpu_torch.bvh.bvh4 import STACK_CAP, stack_need
from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, LEAF_CID_BITS,
                                                 ROW_TRIS, FastScene)

_U32 = 0xFFFFFFFF
WIDTH = 8   # the wide emit's width


def _full(cluster_size: int) -> int:
    """Count-encoded meta bits of a full LBVH leaf (count ==
    cluster_size)."""
    return (cluster_size - 1) << LEAF_CID_BITS


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each
    (int64 holding u32 values)."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton30(x, y, z) -> torch.Tensor:
    """x/y/z f32 in [0, 1) -> interleaved 30-bit Morton codes (int64)."""
    def q(a):
        return torch.clamp(a * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q(x)) << 2) | (_expand_bits(q(y)) << 1)
            | _expand_bits(q(z)))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 values (int64 in [0, 2^32)) by bit smear and
    SWAR popcount."""
    x = x.to(torch.int64) & _U32
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pop = ((x * 0x01010101) & _U32) >> 24
    return 32 - pop


def _search_steps(l: int) -> int:
    """Fixed step count of the Karras searches over l keys. The growth
    of ``lmax`` (from 2, doubling) stops once ``idx + lmax * d`` leaves
    [0, l), so it doubles at most bit_length(l) times and ends below 2l;
    the length search halves t0 = lmax // 2 < 2^bit_length(l) to 0, and
    the split search ceil-halves t0 <= l to 1 then 0: bit_length(l) + 1
    steps each. Further steps change nothing."""
    return l.bit_length() + 2


def build_lbvh_tables(codes: torch.Tensor):
    """Karras binary radix tree over L sorted keys (ties broken by index)
    -> (left, right, first, last, parent), int64. Global node ids:
    internal 0..L-2, leaf k -> (L-1) + k; ``parent`` covers all 2L-1."""
    l = codes.shape[0]
    dev = codes.device
    codes = codes.to(torch.int64)
    idx = torch.arange(l - 1, dtype=torch.int64, device=dev)
    ci = codes[:l - 1]

    def delta(j):
        """Common-prefix length of keys idx and j; -1 out of range;
        equal codes tie-break on index (32 + clz(i ^ j))."""
        valid = (j >= 0) & (j < l)
        j_s = j.clamp(0, l - 1)
        cj = codes[j_s]
        d = _clz32(ci ^ cj)
        d = torch.where(ci == cj, 32 + _clz32(idx ^ j_s), d)
        return torch.where(valid, d, -1)

    d = torch.sign(delta(idx + 1) - delta(idx - 1))
    d = torch.where(d == 0, 1, d)
    steps = _search_steps(l)

    delta_min = delta(idx - d)
    lmax = torch.full_like(idx, 2)
    for _ in range(steps):
        lmax = torch.where(delta(idx + lmax * d) > delta_min, lmax * 2, lmax)

    length = torch.zeros_like(idx)
    t = lmax // 2
    for _ in range(steps):
        ok = delta(idx + (length + t) * d) > delta_min
        length = torch.where(ok, length + t, length)
        t = t // 2
    j = idx + length * d

    delta_node = delta(j)
    s = torch.zeros_like(idx)
    t = (length + 1) // 2
    for _ in range(steps):
        ok = delta(idx + (s + t) * d) > delta_node
        s = torch.where(ok, s + t, s)
        t = (t + 1) // 2 * (t > 1)
    gamma = idx + s * d + torch.clamp_max(d, 0)

    first = torch.minimum(idx, j)
    last = torch.maximum(idx, j)
    left = torch.where(first == gamma, (l - 1) + gamma, gamma)
    right = torch.where(gamma + 1 == last, (l - 1) + gamma + 1, gamma + 1)
    parent = torch.full((2 * l - 1,), -1, dtype=torch.int64, device=dev)
    parent.index_copy_(0, left, idx)
    parent.index_copy_(0, right, idx)
    return left, right, first, last, parent


def _range_minmax(lo, hi, first, last):
    """Sparse-table range min/max over leaf boxes of ONE axis: lo/hi
    f32[L], inclusive ranges first/last -> (min, max) per range."""
    l = lo.shape[0]
    levels = max(1, (l - 1).bit_length())
    mins, maxs = [lo], [hi]
    for k in range(1, levels + 1):
        half = 1 << (k - 1)
        pad_min = torch.full((half,), float("inf"), dtype=lo.dtype,
                             device=lo.device)
        mins.append(torch.minimum(
            mins[-1], torch.cat([mins[-1][half:], pad_min])))
        maxs.append(torch.maximum(
            maxs[-1], torch.cat([maxs[-1][half:], -pad_min])))
    span = last - first + 1
    k = torch.where(span > 1, 31 - _clz32(span), 0).clamp(0, levels)
    table_min = torch.stack(mins)
    table_max = torch.stack(maxs)
    b = torch.maximum(last - (torch.ones_like(k) << k) + 1, first)
    return (torch.minimum(table_min[k, first], table_min[k, b]),
            torch.maximum(table_max[k, first], table_max[k, b]))


def emit_wide_device(left, right, parent, all_lo, all_hi, l: int, *,
                     cluster_size: int):
    """The 8-wide table from the Karras tree by dense ops: a binary
    internal node is a wide node iff its depth % 3 == 0, and its 8 slots
    are the descendants 3 left/right steps down given by the slot bits (a
    leaf reached early fills only the slot whose remaining bits are 0).
    Rows are indexed by wide id (a cumsum over the wide mask), root row
    0. -> (table f32[L-1, 128], n_wide i64 device scalar, depth i64[2L-1]
    of every binary node). Rows past n_wide are zero."""
    leaf_base = l - 1
    dev = left.device

    # Depth of every node by pointer doubling over parent links (2^7 >=
    # any Karras depth over 30-bit codes with index tie-breaks).
    jump = parent
    depth = (parent >= 0).to(torch.int64)
    for _ in range(7):
        safe = jump.clamp_min(0)
        depth = depth + torch.where(jump >= 0, depth[safe], 0)
        jump = torch.where(jump >= 0, jump[safe], -1)

    ids = torch.arange(leaf_base, dtype=torch.int64, device=dev)
    w = depth[:leaf_base] % 3 == 0
    wide_id = torch.cumsum(w.to(torch.int64), 0) - 1

    slot_cols = []
    pad9 = torch.zeros((leaf_base, 9), dtype=torch.float32, device=dev)
    for s in range(8):
        cur = ids
        at_leaf = torch.zeros(leaf_base, dtype=torch.bool, device=dev)
        valid = torch.ones(leaf_base, dtype=torch.bool, device=dev)
        for k in (2, 1, 0):
            bit = (s >> k) & 1
            if bit:
                valid = valid & ~at_leaf
            safe = cur.clamp(0, leaf_base - 1)
            child = right[safe] if bit else left[safe]
            cur = torch.where(at_leaf, cur, child)
            at_leaf = cur >= leaf_base
        meta = torch.where(at_leaf,
                           -((cur - leaf_base) | _full(cluster_size)) - 1,
                           wide_id[cur.clamp(0, leaf_base - 1)] + 1)
        meta = torch.where(valid, meta, 0).to(torch.float32)
        slot_cols.append(torch.cat(
            [all_lo[cur], all_hi[cur], meta[:, None], pad9], 1))
    rows = torch.stack(slot_cols, 1).reshape(leaf_base, 128)
    dest = torch.where(w, wide_id, leaf_base)
    table = torch.zeros((leaf_base + 1, 128), dtype=torch.float32,
                        device=dev).index_copy_(0, dest, rows)[:leaf_base]
    return table, w.sum(), depth


def tri_normals(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Unit geometric normals normalize(cross(e1, e2)) of [N, 3] edges, 0
    for a degenerate triangle: the JAX package's ``jnp.cross`` formulas
    and sum order, each product its own op (no fused multiply-add on
    the card)."""
    a0, a1, a2 = e1.unbind(1)
    b0, b1, b2 = e2.unbind(1)
    n = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0], 1)
    sq = n * n
    nlen = torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])[:, None]
    pos = nlen > 0.0
    return torch.where(pos, n / torch.where(pos, nlen, 1.0), 0.0)


def _as_i32(f: torch.Tensor) -> torch.Tensor:
    return f.contiguous().view(torch.int32)


def device_tables(verts: torch.Tensor, mats: torch.Tensor,
                  cluster_size: int):
    """[T,3,3] verts + [T,4] mats (T a multiple of ROW_TRIS) -> (nodes8
    f32[2L-1, 8] over L = T / cluster_size leaves, clusters f32[T/8,
    128], nodes4 f32[max(L-1, 1), 128], n_wide and wide depth as device
    scalars). No host read."""
    t = verts.shape[0]
    if t % ROW_TRIS:
        raise ValueError("pad the triangle count to a cluster-row "
                         "multiple (pad_to_cluster_multiple)")
    dev = verts.device
    cs = cluster_size
    l = t // cs

    lo = verts.amin(1)
    hi = verts.amax(1)
    thin = (hi - lo) < AABB_EPS
    lo = torch.where(thin, lo - AABB_EPS, lo)
    hi = torch.where(thin, hi + AABB_EPS, hi)
    center = (lo + hi) * 0.5
    scene_lo = lo.amin(0)
    extent = torch.clamp_min(hi.amax(0) - scene_lo, 1e-12)
    u = (center - scene_lo) / extent
    codes = morton30(u[:, 0], u[:, 1], u[:, 2])

    order = torch.argsort(codes, stable=True)
    lo_s, hi_s = lo[order], hi[order]
    cl_lo = lo_s.reshape(l, cs, 3).amin(1)
    cl_hi = hi_s.reshape(l, cs, 3).amax(1)
    cl_code = codes[order].reshape(l, cs)[:, 0]

    i32 = dict(dtype=torch.int32, device=dev)
    if l == 1:
        # One cluster: a single leaf node; the wide table's one node has
        # leaf cluster 0 in slot 0.
        nodes8_i = torch.cat([_as_i32(cl_lo), _as_i32(cl_hi),
                              torch.ones((1, 1), **i32),
                              torch.zeros((1, 1), **i32)], 1)
        nodes_wide = torch.cat([
            cl_lo[0], cl_hi[0],
            torch.full((1,), float(-_full(cs) - 1), device=dev),
            torch.zeros(121, device=dev)])[None]
        n_wide = torch.ones((), dtype=torch.int64, device=dev)
        wide_depth = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        m = 2 * l - 1
        left, right, first, last, parent = build_lbvh_tables(cl_code)
        axes = [_range_minmax(cl_lo[:, ax], cl_hi[:, ax], first, last)
                for ax in range(3)]
        all_lo = torch.cat([torch.stack([a[0] for a in axes], 1), cl_lo])
        all_hi = torch.cat([torch.stack([a[1] for a in axes], 1), cl_hi])

        # Escape links (internal 0..L-2, leaves L-1..2L-2): a left child
        # escapes to its parent's right child, a right child to its
        # parent's escape; pointer doubling, 7 passes (depth <= 128).
        node_right = torch.cat([right, torch.zeros(l, dtype=torch.int64,
                                                   device=dev)])
        is_left = torch.zeros(m, dtype=torch.bool,
                              device=dev).index_fill_(0, left, True)
        escape = torch.where(is_left, node_right[parent.clamp_min(0)], m)
        jump = torch.where(is_left | (parent < 0), -1, parent)
        for _ in range(7):
            j = jump.clamp_min(0)
            live = jump >= 0
            take = live & (jump[j] < 0)
            escape = torch.where(take, escape[j], escape)
            jump = torch.where(live, torch.where(take, -1, jump[j]), -1)

        leaf_col = torch.cat([-(left + 1), torch.arange(
            l, dtype=torch.int64, device=dev)])
        nodes8_i = torch.cat([_as_i32(all_lo), _as_i32(all_hi),
                              escape[:, None].to(torch.int32),
                              leaf_col[:, None].to(torch.int32)], 1)
        nodes_wide, n_wide, depth = emit_wide_device(
            left, right, parent, all_lo, all_hi, l, cluster_size=cs)
        wide_depth = torch.where(depth[:l - 1] % 3 == 0,
                                 depth[:l - 1], 0).amax() // 3

    # Cluster records (v0 e1 e2 albedo type unit-normal) in sorted order.
    v_s = verts.reshape(t, 9)[order]
    v0 = v_s[:, 0:3]
    e1 = v_s[:, 3:6] - v0
    e2 = v_s[:, 6:9] - v0
    row16 = torch.cat([v0, e1, e2, mats[order], tri_normals(e1, e2)], 1)
    clusters = row16.reshape(t // ROW_TRIS, CLUSTER_ROW)
    return (nodes8_i.view(torch.float32), clusters, nodes_wide, n_wide,
            wide_depth)


def build_fast_scene_device(verts: torch.Tensor,
                            mats: torch.Tensor) -> FastScene:
    """[T,3,3] verts + [T,4] mats on a device (T a multiple of ROW_TRIS:
    ``pad_to_cluster_multiple``) -> FastScene on that device, in the
    layout of ``knobs.layout()``. One host read (the wide node count and
    depth; none under ``RAYTPU_WIDE=16``, where the scene has no wide
    table); refuses a wide tree whose walk could need more than STACK_CAP
    stack slots."""
    cs, ww = knobs.layout()
    nodes8, clusters, nodes4, n_wide, wide_depth = device_tables(verts,
                                                                 mats, cs)
    scene = dict(nodes8=nodes8, clusters=clusters, num_nodes=nodes8.shape[0],
                 num_triangles=verts.shape[0], cluster_size=cs,
                 wide_width=ww)
    if ww != WIDTH:
        return FastScene(**scene)
    n4, depth = torch.stack([n_wide, wide_depth]).tolist()
    need = stack_need(depth, WIDTH)
    if need > STACK_CAP:
        raise ValueError(f"LBVH wide depth {depth + 1} would need {need} "
                         f"stack slots > STACK_CAP {STACK_CAP}")
    return FastScene(nodes4=nodes4, num_nodes4=int(n4), **scene)


def pad_to_cluster_multiple(verts: np.ndarray, mats: np.ndarray):
    """Host helper: pad a triangle soup with zero triangles (never hit)
    so T % ROW_TRIS == 0."""
    pad = (-verts.shape[0]) % ROW_TRIS
    if pad:
        verts = np.concatenate([verts, np.zeros((pad, 3, 3), np.float32)])
        mats = np.concatenate([mats, np.zeros((pad, 4), np.float32)])
    return verts, mats

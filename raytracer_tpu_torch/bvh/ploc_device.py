"""On-device PLOC scene build: agglomerative BVH for live edits, as
PyTorch tensor code on the tensors' device.

The port of ``raytracer_tpu/bvh/ploc_device.py``. Triangles sort by
Morton code once; then each round every cluster proposes its
lowest-union-surface-area neighbour within WINDOW slots and mutual pairs
merge (PLOC, Meister & Bittner 2018). Phase 1 merges triangles while a
pair fits in one CLUSTER_SIZE leaf (variable-fill leaves), a force-fit
valve guarantees at most LCAP = T // 4 leaves, and phase 2 merges the
leaves up to the root, recording internal nodes so that the root is node 0
(the LBVH numbering: internal 0..L-2, leaf k at row (L-1)+k). The tables
are the JAX package's, word for word on the CPU (normals to 2 ulp).

What differs from the JAX code, and why the result does not:

* Each ``while_loop`` (phase 1, the force valve, phase 2) runs its
  bound of fixed steps (``_MAX_CAPPED`` 40, ``_MAX_FORCE`` 64,
  ``_MAX_ROOT`` 96). A step computes the loop body and keeps its result
  only where the loop condition, evaluated on the device from the
  current carry, holds (``torch.where`` over the whole carry). The
  condition depends on the carry alone, so once it is false the carry is
  frozen and it stays false: the steps past JAX's exit change nothing,
  and the iteration counters (``it`` of each loop, the force valve's
  starting again at 0 and picking pairs by its parity; phase 2's forced
  halving from ``it >= _FORCE_AFTER`` or when no mutual pair exists)
  count exactly the steps JAX ran. No host read per step.
* ``_window_best`` prices all 2 * WINDOW candidates of a slot at once
  and takes the first minimum in the JAX test order (+1, -1, +2, -2,
  ...): JAX's running strict ``<`` keeps the first candidate that
  reaches the minimum, which is what ``min(dim)`` returns (a NaN cost,
  never chosen by ``<``, becomes inf). Every cost is the JAX expression
  ``d0*d1 + d1*d2 + d2*d0`` in that order, one op each (no FMA).
* ``.at[...].set(..., mode="drop")`` becomes an index copy into one
  extra dump row that is then cut off (as in ``bvh/lbvh.py``); the
  compacted columns of a carry move in one copy per dtype.
* Counts JAX keeps traced (the live leaves L, the wide node count) are
  read on the host once at the end of the build, with the wide tree's
  depth, in one copy: the port's ``FastScene`` holds host counts, and a
  wide depth whose walk needs more than ``bvh4.STACK_CAP`` slots is
  refused, as ``lbvh.build_fast_scene_device`` does.

The fixed steps make a rebuild some 15,000 small launches on the card;
a fused window-search kernel or a CUDA graph of one step would cut that.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.bvh.build import AABB_EPS
from raytracer_tpu_torch.bvh.bvh4 import STACK_CAP, stack_need
from raytracer_tpu_torch.bvh.lbvh import _as_i32, morton30, tri_normals
from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, LEAF_CID_BITS,
                                                 ROW_TRIS, FastScene)

# The one layout the device PLOC builds: 8-slot leaves, 8-wide nodes (the
# JAX build asserts both, ploc_device.py:121-122).
CLUSTER_SIZE = 8
WIDE_WIDTH = 8

_BIG = 3.0e38
_INF = float("inf")
# A count that never fits: the neighbour past the last slot.
_NO_FIT = 1 << 20

# Iteration bounds of the JAX loops (ploc_device.py:37-45).
_MAX_CAPPED = 40
_MAX_FORCE = 64
_FORCE_AFTER = 48   # phase 2: SA-driven iterations before forced halving
_MAX_ROOT = 96
WINDOW = 8


def _sa(lo, hi):
    """Surface-area proxy of boxes [..., 3] (the JAX operation order)."""
    d = torch.clamp_min(hi - lo, 0.0)
    return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
            + d[..., 2] * d[..., 0])


def _shift_up(a, dlt: int, fill):
    """a[i] -> a[i+dlt], tail filled."""
    pad = torch.full((dlt,) + a.shape[1:], fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a[dlt:], pad])


def _window_best(lo, hi, n, cnt=None, cap: int = 0):
    """best_j[i] = lowest-union-SA neighbour of slot i within WINDOW among
    the first n slots (with ``cnt``, only pairs whose counts sum to at
    most ``cap``); -1 = none. Ties go to the first candidate in the
    order +1, -1, +2, -2, ... (the JAX loop's strict ``<``)."""
    t = lo.shape[0]
    dev = lo.device
    idx = torch.arange(t, device=dev)
    dl = torch.arange(1, WINDOW + 1, device=dev)[:, None]
    up = idx + dl                                         # [WINDOW, t]
    inside = up < t
    upc = up.clamp_max(t - 1)
    nb_lo = torch.where(inside[..., None], lo[upc], _BIG)
    nb_hi = torch.where(inside[..., None], hi[upc], -_BIG)
    c = _sa(torch.minimum(lo, nb_lo), torch.maximum(hi, nb_hi))
    ok = up < n
    if cnt is not None:
        ok = ok & ((cnt + torch.where(inside, cnt[upc], _NO_FIT)) <= cap)
    c = torch.where(ok & (c == c), c, _INF)
    # Pair (i - dlt, i) costs what slot i - dlt priced for +dlt.
    down = idx - dl
    cb = torch.where(down >= 0, c.gather(1, down.clamp_min(0)), _INF)
    cost = torch.stack([c, cb], 1).reshape(2 * WINDOW, t)
    cand = torch.stack([up, down], 1).reshape(2 * WINDOW, t)
    best, arg = cost.min(0)
    return torch.where(best < _INF, cand.gather(0, arg[None])[0], -1)


def _mutual_left(best_j, n):
    """Mask of positions i that are the LEFT partner of a mutual best
    pair (i, best_j[i])."""
    t = best_j.shape[0]
    idx = torch.arange(t, device=best_j.device)
    bj = best_j.clamp(0, t - 1)
    return ((best_j >= 0) & (best_j[bj] == idx) & (idx < best_j)
            & (idx < n))


def _compact(keep, arrs):
    """Scatter-compact each array to the prefix of kept slots (dropped
    slots become zeros)."""
    t = keep.shape[0]
    new_pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    tgt = torch.where(keep, new_pos, t)
    return [torch.zeros((t + 1,) + a.shape[1:], dtype=a.dtype,
                        device=a.device).index_copy_(0, tgt, a)[:t]
            for a in arrs]


def _union(box, other):
    """Union of [N, 6] (lo | hi) boxes."""
    return torch.cat([torch.minimum(box[:, :3], other[:, :3]),
                      torch.maximum(box[:, 3:], other[:, 3:])], 1)


def _gated(go, new, old):
    """The loop step's carry where ``go`` (a device bool) holds, else the
    carry unchanged."""
    return tuple(torch.where(go, a, b) for a, b in zip(new, old))


def _merge_leaves(n, mutual, partner, box, ints, nxt):
    """Merge each mutual left slot i with slot ``partner[i]`` (phase 1
    and the force valve): member lists append, counts add, boxes unite,
    the partner's slot dies and the survivors compact. ``ints`` holds
    (count, list head, list tail) per slot; ``nxt`` is the intrusive
    member list over item ids with a dump row. -> (n, box, ints, nxt)."""
    t = box.shape[0]
    idx = torch.arange(t, device=box.device)
    bj = partner.clamp(0, t - 1)
    other = ints[bj]
    nxt = nxt.index_copy(0, torch.where(mutual, ints[:, 2], t), other[:, 1])
    m = mutual[:, None]
    box = torch.where(m, _union(box, box[bj]), box)
    ints = torch.where(m, torch.stack(
        [ints[:, 0] + other[:, 0], ints[:, 1], other[:, 2]], 1), ints)
    dead = torch.zeros(t + 1, dtype=torch.bool, device=box.device)
    dead.index_fill_(0, torch.where(mutual, partner, t), True)
    keep = (idx < n) & ~dead[:t]
    box, ints = _compact(keep, (box, ints))
    return keep.sum(), box, ints, nxt


def _cluster_leaves(lo_s, hi_s, lcap: int):
    """Phase 1 and the force-fit valve over the sorted triangle boxes ->
    (live leaf count L (device scalar), leaf boxes f32[T, 6], ints
    i64[T, 3] (count, head, tail), member links i64[T + 1])."""
    t = lo_s.shape[0]
    dev = lo_s.device
    idx = torch.arange(t, device=dev)

    def scalar(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    box = torch.cat([lo_s, hi_s], 1)
    ints = torch.stack([torch.ones_like(idx), idx, idx], 1)
    nxt = torch.full((t + 1,), -1, dtype=torch.int64, device=dev)
    n, k, it = scalar(t), scalar(1), scalar(0)
    for _ in range(_MAX_CAPPED):
        go = (n > 1) & (k > 0) & (it < _MAX_CAPPED)
        best_j = _window_best(box[:, :3], box[:, 3:], n, cnt=ints[:, 0],
                              cap=CLUSTER_SIZE)
        mutual = _mutual_left(best_j, n)
        n2, box2, ints2, nxt2 = _merge_leaves(n, mutual, best_j, box, ints,
                                              nxt)
        n, k, it, box, ints, nxt = _gated(
            go, (n2, mutual.sum(), it + 1, box2, ints2, nxt2),
            (n, k, it, box, ints, nxt))

    # Force-fit valve: while n > LCAP, merge adjacent fitting pairs at
    # alternating parity (the counter starts at 0 again).
    it = scalar(0)
    for _ in range(_MAX_FORCE):
        go = (n > lcap) & (it < _MAX_FORCE)
        cnt = ints[:, 0]
        fits = (cnt + _shift_up(cnt, 1, _NO_FIT)) <= CLUSTER_SIZE
        mutual = ((idx % 2 == (it & 1)) & ((idx + 1) < n) & fits
                  & (idx < n))
        n2, box2, ints2, nxt2 = _merge_leaves(n, mutual, idx + 1, box, ints,
                                              nxt)
        n, it, box, ints, nxt = _gated(go, (n2, it + 1, box2, ints2, nxt2),
                                       (n, it, box, ints, nxt))
    return n, box, ints, nxt


def _merge_to_root(lc, leaf_box, lcap: int):
    """Phase 2: unrestricted PLOC over the leaves up to the root, each
    merge recorded at its creation index -> (children i64[lcap, 2] and
    boxes f32[lcap, 6] by creation index, then as device scalars the
    steps run and the steps whose SA round found no mutual pair).
    Children are creation ids (< L-1) or leaf ids ((L-1)+k)."""
    dev = leaf_box.device
    idx = torch.arange(lcap, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n, it, created, stalls = lc, zero, zero, zero
    node_id, box = (lc - 1) + idx, leaf_box
    rec_lr = torch.zeros((lcap + 1, 2), dtype=torch.int64, device=dev)
    rec_box = torch.zeros((lcap + 1, 6), dtype=torch.float32, device=dev)
    for _ in range(_MAX_ROOT):
        go = (n > 1) & (it < _MAX_ROOT)
        best_j = _window_best(box[:, :3], box[:, 3:], n)
        mutual = _mutual_left(best_j, n)
        # Tie-stall / convergence valve: after _FORCE_AFTER SA rounds, or
        # when no mutual pair emerged, merge adjacent pairs by parity.
        stalled = mutual.sum() == 0
        forced = stalled | (it >= _FORCE_AFTER)
        fmask = (idx % 2 == (it & 1)) & ((idx + 1) < n) & (idx < n)
        mutual = torch.where(forced, fmask, mutual)
        best_j = torch.where(forced, idx + 1, best_j)
        bj = best_j.clamp(0, lcap - 1)
        cidx = created + torch.cumsum(mutual.to(torch.int64), 0) - 1
        tgt = torch.where(mutual, cidx, lcap)
        u_box = _union(box, box[bj])
        rec_lr2 = rec_lr.index_copy(0, tgt,
                                    torch.stack([node_id, node_id[bj]], 1))
        rec_box2 = rec_box.index_copy(0, tgt, u_box)
        created2 = created + mutual.sum()
        node_id2 = torch.where(mutual, cidx, node_id)
        box2 = torch.where(mutual[:, None], u_box, box)
        dead = torch.zeros(lcap + 1, dtype=torch.bool, device=dev)
        dead.index_fill_(0, torch.where(mutual, best_j, lcap), True)
        keep = (idx < n) & ~dead[:lcap]
        node_id2, box2 = _compact(keep, (node_id2, box2))
        n, it, stalls, node_id, box, created, rec_lr, rec_box = _gated(
            go, (keep.sum(), it + 1, stalls + stalled.to(torch.int64),
                 node_id2, box2, created2, rec_lr2, rec_box2),
            (n, it, stalls, node_id, box, created, rec_lr, rec_box))
    return rec_lr[:lcap], rec_box[:lcap], it, stalls


def _sorted_boxes(verts: torch.Tensor):
    """Triangle AABBs (thin axes padded by AABB_EPS) in Morton order ->
    (lo f32[T, 3], hi f32[T, 3], order i64[T])."""
    lo = verts.amin(1)
    hi = verts.amax(1)
    thin = (hi - lo) < AABB_EPS
    lo = torch.where(thin, lo - AABB_EPS, lo)
    hi = torch.where(thin, hi + AABB_EPS, hi)
    center = (lo + hi) * 0.5
    scene_lo = lo.amin(0)
    extent = torch.clamp_min(hi.amax(0) - scene_lo, 1e-12)
    u = (center - scene_lo) / extent
    order = torch.argsort(morton30(u[:, 0], u[:, 1], u[:, 2]), stable=True)
    return lo[order], hi[order], order


def device_tables_ploc(verts: torch.Tensor, mats: torch.Tensor):
    """[T,3,3] verts + [T,4] mats (T a multiple of ROW_TRIS, at least 16)
    -> (nodes8 f32[2*LCAP, 8], clusters f32[LCAP, 128], nodes4
    f32[LCAP, 128], then as device scalars the live leaf count L, the
    wide node count and the wide tree's depth). No host read."""
    t = verts.shape[0]
    if t % ROW_TRIS:
        raise ValueError("pad the triangle count to a cluster-row "
                         "multiple (pad_to_cluster_multiple)")
    lcap = max(t // 4, 16)
    if lcap > t:
        raise ValueError(f"device PLOC needs at least 16 triangles, got {t}")
    dev = verts.device
    i64 = dict(dtype=torch.int64, device=dev)

    # --- AABBs + Morton sort (as bvh/lbvh.py) ---
    lo_s, hi_s, order = _sorted_boxes(verts)
    lc, c_box, c_ints, c_nxt = _cluster_leaves(lo_s, hi_s, lcap)

    # --- leaf members: chains are <= CLUSTER_SIZE long ---
    members = []
    cur = c_ints[:lcap, 1]
    alive = torch.arange(lcap, device=dev) < lc
    for _ in range(CLUSTER_SIZE):
        members.append(torch.where(alive & (cur >= 0), cur, -1))
        cur = torch.where(cur >= 0, c_nxt[cur.clamp(0, t - 1)], -1)
    memidx = torch.stack(members, 1)                        # [lcap, 8]

    # --- cluster rows: MT records (v0 e1 e2 albedo type unit-normal) in
    # leaf order; empty member slots are the record times 0 ---
    v_s = verts.reshape(t, 9)[order]
    v0 = v_s[:, 0:3]
    e1 = v_s[:, 3:6] - v0
    e2 = v_s[:, 6:9] - v0
    row16 = torch.cat([v0, e1, e2, mats[order], tri_normals(e1, e2)], 1)
    rec = row16[memidx.clamp(0, t - 1)] * (memidx >= 0).to(
        torch.float32)[:, :, None]
    clusters = rec.reshape(lcap, CLUSTER_ROW)

    leaf_box = c_box[:lcap]
    leaf_cnt = c_ints[:lcap, 0].clamp(1, CLUSTER_SIZE)

    rec_lr, rec_box, _, _ = _merge_to_root(lc, leaf_box, lcap)

    # Remap creation index c -> internal id (L-2) - c (root = 0).
    idx_l = torch.arange(lcap, device=dev)
    remapped = torch.where(rec_lr >= lc - 1, rec_lr, (lc - 2) - rec_lr)
    validc = idx_l < (lc - 1)
    tgt = torch.where(validc, (lc - 2) - idx_l, lcap)
    lr = torch.zeros((lcap + 1, 2), **i64).index_copy_(0, tgt,
                                                       remapped)[:lcap]
    int_box = torch.zeros((lcap + 1, 6), dtype=torch.float32,
                          device=dev).index_copy_(0, tgt, rec_box)[:lcap]
    left, right = lr[:, 0], lr[:, 1]

    # --- binary node table (internal 0..L-2, leaves (L-1)+k; buffers
    # sized mcap with a dump row) ---
    mcap = 2 * lcap
    m_live = 2 * lc - 1
    idx_m = torch.arange(mcap, device=dev)
    parent = torch.full((mcap + 1,), -1, **i64)
    parent.index_copy_(0, torch.where(validc, left, mcap), idx_l)
    parent.index_copy_(0, torch.where(validc, right, mcap), idx_l)
    parent = parent[:mcap]

    # Escape links by pointer doubling (as bvh/lbvh.py), 7 passes.
    node_right = torch.cat([right, torch.zeros(mcap - lcap, **i64)])
    is_left = torch.zeros(mcap + 1, dtype=torch.bool, device=dev)
    is_left = is_left.index_fill_(0, torch.where(validc, left, mcap),
                                  True)[:mcap]
    escape = torch.where(is_left, node_right[parent.clamp(0, mcap - 1)],
                         m_live)
    jump = torch.where(is_left | (parent < 0), -1, parent)
    for _ in range(7):
        j = jump.clamp(0, mcap - 1)
        live = jump >= 0
        take = live & (jump[j] < 0)
        escape = torch.where(take, escape[j], escape)
        jump = torch.where(live, torch.where(take, -1, jump[j]), -1)

    # Bounds and col7 per node id: internal i at row i, leaf k at row
    # (L-1)+k (a dynamic scatter).
    all_lo = torch.full((mcap + 1, 3), _BIG, dtype=torch.float32,
                        device=dev)
    all_hi = torch.full((mcap + 1, 3), -_BIG, dtype=torch.float32,
                        device=dev)
    all_lo[:lcap] = torch.where(validc[:, None], int_box[:, :3], _BIG)
    all_hi[:lcap] = torch.where(validc[:, None], int_box[:, 3:], -_BIG)
    leaf_rows = torch.where(idx_l < lc, (lc - 1) + idx_l, mcap)
    all_lo = all_lo.index_copy_(0, leaf_rows, leaf_box[:, :3])[:mcap]
    all_hi = all_hi.index_copy_(0, leaf_rows, leaf_box[:, 3:])[:mcap]
    col7 = torch.zeros(mcap + 1, **i64)
    col7[:lcap] = -(left + 1)
    col7 = col7.index_copy_(0, leaf_rows, idx_l)[:mcap]
    escape = torch.where(idx_m < m_live, escape, m_live)
    # i32 assembly, one f32 view (f32 ops would corrupt link bits).
    nodes8_i = torch.cat([_as_i32(all_lo), _as_i32(all_hi),
                          escape[:, None].to(torch.int32),
                          col7[:, None].to(torch.int32)], 1)

    # --- 8-wide emit (lbvh.emit_wide_device with a device leaf base and
    # count-encoded leaf metas) ---
    jump = parent
    depth = (parent >= 0).to(torch.int64)
    for _ in range(7):
        safe = jump.clamp(0, mcap - 1)
        depth = depth + torch.where(jump >= 0, depth[safe], 0)
        jump = torch.where(jump >= 0, jump[safe], -1)
    w = (depth[:lcap] % 3 == 0) & validc
    wide_id = torch.cumsum(w.to(torch.int64), 0) - 1
    leaf_base = lc - 1

    slot_cols = []
    pad9 = torch.zeros((lcap, 9), dtype=torch.float32, device=dev)
    for s in range(WIDE_WIDTH):
        cur = idx_l
        at_leaf = torch.zeros(lcap, dtype=torch.bool, device=dev)
        valid = torch.ones(lcap, dtype=torch.bool, device=dev)
        for kbit in (2, 1, 0):
            bit = (s >> kbit) & 1
            if bit:
                valid = valid & ~at_leaf
            safe = cur.clamp(0, lcap - 1)
            child = right[safe] if bit else left[safe]
            cur = torch.where(at_leaf, cur, child)
            at_leaf = cur >= leaf_base
        cid = cur - leaf_base
        cnt_enc = (leaf_cnt[cid.clamp(0, lcap - 1)] - 1) << LEAF_CID_BITS
        meta = torch.where(at_leaf, -(cid | cnt_enc) - 1,
                           wide_id[cur.clamp(0, lcap - 1)] + 1)
        meta = torch.where(valid, meta, 0).to(torch.float32)
        row = cur.clamp(0, mcap - 1)
        slot_cols.append(torch.cat([all_lo[row], all_hi[row],
                                    meta[:, None], pad9], 1))
    rows = torch.stack(slot_cols, 1).reshape(lcap, 128)
    nodes_wide = torch.zeros((lcap + 1, 128), dtype=torch.float32,
                             device=dev).index_copy_(
        0, torch.where(w, wide_id, lcap), rows)[:lcap]
    wide_depth = torch.where(w, depth[:lcap], 0).amax() // 3
    return (nodes8_i.view(torch.float32), clusters, nodes_wide, lc, w.sum(),
            wide_depth)


def build_fast_scene_device_ploc(verts: torch.Tensor,
                                 mats: torch.Tensor) -> FastScene:
    """[T,3,3] verts + [T,4] mats on a device (T a multiple of ROW_TRIS:
    ``lbvh.pad_to_cluster_multiple``) -> FastScene with variable-fill
    leaves on that device. One host read (the leaf and wide node counts
    and the wide depth); refuses a wide tree whose walk could need more
    than STACK_CAP stack slots, and any table layout but the default
    (``NotImplementedError`` naming the knob, as the JAX build asserts
    it)."""
    layout = knobs.layout()
    if layout != (CLUSTER_SIZE, WIDE_WIDTH):
        raise NotImplementedError(
            f"RAYTPU_DEVICE_TREE=ploc builds {CLUSTER_SIZE}-triangle leaves "
            f"and {WIDE_WIDTH}-wide nodes only: unset RAYTPU_CLUSTER="
            f"{layout[0]} / RAYTPU_WIDE={layout[1]}")
    nodes8, clusters, nodes4, lc, n_wide, wide_depth = device_tables_ploc(
        verts, mats)
    lc, n4, depth = torch.stack([lc, n_wide, wide_depth]).tolist()
    need = stack_need(depth, WIDE_WIDTH)
    if need > STACK_CAP:
        raise ValueError(f"PLOC wide depth {depth + 1} would need {need} "
                         f"stack slots > STACK_CAP {STACK_CAP}")
    return FastScene(nodes8=nodes8, clusters=clusters, nodes4=nodes4,
                     num_nodes=2 * lc - 1, num_triangles=verts.shape[0],
                     num_nodes4=int(n4))

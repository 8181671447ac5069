"""Host PLOC builder in NumPy: agglomerative BVH with capped leaves.

The port's copy of ``raytracer_tpu/bvh/ploc.py``, the JAX package's NumPy
PLOC, for ``RAYTPU_BVH=ploc`` with ``RAYTPU_NATIVE=0`` (the native
library's ``rt_build_bvh_ploc`` emits the same tree). PLOC (Meister and
Bittner 2018, "Parallel Locally-Ordered Clustering for Bounding Volume
Hierarchy Construction") builds bottom-up: items sort by Morton code
once, then every round each active cluster proposes its
lowest-union-surface-area neighbour inside a sliding window and mutual
pairs merge. Two phases:

  1. *capped* phase over triangles: merges allowed only while the
     combined triangle count stays <= leaf_size; when no allowed mutual
     pair remains, the surviving clusters become the LEAVES (variable
     fill);
  2. unrestricted phase over the leaf AABBs up to the root.

Same ``HostBVH`` pre-order flat output as ``bvh/build.py``, so every
downstream consumer (wide collapse, cluster packers, kernels) is
unchanged.
"""

from __future__ import annotations

import time

import numpy as np

from raytracer_tpu_torch.bvh.build import HostBVH, triangle_aabbs
from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("bvh")


def _sa(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def _expand_bits64(v: np.ndarray) -> np.ndarray:
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_order(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Stable argsort of AABB centroids by 30-bit Morton code."""
    ctr = (lo + hi) * 0.5
    smin = lo.min(axis=0)
    ext = np.maximum(hi.max(axis=0) - smin, 1e-12)
    u = (ctr - smin) / ext
    q = lambda a: np.clip(a * 1024.0, 0.0, 1023.0).astype(np.uint64)
    code = ((_expand_bits64(q(u[:, 0])) << np.uint64(2))
            | (_expand_bits64(q(u[:, 1])) << np.uint64(1))
            | _expand_bits64(q(u[:, 2])))
    return np.argsort(code, kind="stable")


def build_bvh_ploc(tris: np.ndarray, leaf_size: int = 8,
                   window: int = 8) -> HostBVH:
    """PLOC build + pre-order flatten. Leaves hold 1..leaf_size tris."""
    t0 = time.perf_counter()
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH from empty triangle list")
    lo, hi = triangle_aabbs(tris)
    mo = morton_order(lo, hi)
    lo_s, hi_s = lo[mo], hi[mo]

    if n == 1:
        return HostBVH(lo_s, hi_s, np.zeros(1, np.int32),
                       np.ones(1, np.int32), np.ones(1, np.int32),
                       np.array([-1], np.int32), np.array([-1], np.int32),
                       mo.astype(np.int64))

    # --- phase 1: capped agglomeration -> leaves -----------------------
    # members tracked via linked lists (head/next/tail per active slot):
    # O(1) merge, no python list churn.
    nxt = np.full(n, -1, np.int64)
    head = np.arange(n, dtype=np.int64)
    tail = np.arange(n, dtype=np.int64)
    cnt = np.ones(n, np.int64)
    cur_lo = lo_s.copy()
    cur_hi = hi_s.copy()
    m_act = n
    while m_act > 1:
        best_cost = np.full(m_act, np.inf, np.float32)
        best_j = np.full(m_act, -1, np.int64)
        w = min(window, m_act - 1)
        for dlt in range(1, w + 1):
            u_lo = np.minimum(cur_lo[:m_act - dlt], cur_lo[dlt:m_act])
            u_hi = np.maximum(cur_hi[:m_act - dlt], cur_hi[dlt:m_act])
            c = _sa(u_lo, u_hi)
            fits = (cnt[:m_act - dlt] + cnt[dlt:m_act]) <= leaf_size
            c = np.where(fits, c, np.inf)
            m1 = c < best_cost[:m_act - dlt]
            best_cost[:m_act - dlt][m1] = c[m1]
            best_j[:m_act - dlt][m1] = np.arange(dlt, m_act)[m1]
            m2 = c < best_cost[dlt:m_act]
            best_cost[dlt:m_act][m2] = c[m2]
            best_j[dlt:m_act][m2] = np.arange(0, m_act - dlt)[m2]
        i_arr = np.arange(m_act)
        has = best_j >= 0
        bj = np.where(has, best_j, 0)
        mutual = has & (best_j[bj] == i_arr) & (i_arr < best_j)
        idx_i = i_arr[mutual]
        idx_j = best_j[mutual]
        if idx_i.shape[0] == 0:
            break  # no allowed merges remain: leaves are final
        # Append j's member list to i's.
        nxt[tail[idx_i]] = head[idx_j]
        tail[idx_i] = tail[idx_j]
        cnt[idx_i] += cnt[idx_j]
        cur_lo[idx_i] = np.minimum(cur_lo[idx_i], cur_lo[idx_j])
        cur_hi[idx_i] = np.maximum(cur_hi[idx_i], cur_hi[idx_j])
        keep = np.ones(m_act, bool)
        keep[idx_j] = False
        m_new = int(keep.sum())
        for arr in (head, tail, cnt):
            arr[:m_new] = arr[:m_act][keep]
        cur_lo[:m_new] = cur_lo[:m_act][keep]
        cur_hi[:m_new] = cur_hi[:m_act][keep]
        m_act = m_new

    l = m_act  # leaf count
    leaf_lo = cur_lo[:l].copy()
    leaf_hi = cur_hi[:l].copy()
    leaf_cnt = cnt[:l].astype(np.int32)
    # Resolve member lists -> flattened triangle order (leaf-major).
    order = np.empty(n, np.int64)
    leaf_start = np.zeros(l, np.int64)
    at = 0
    for i in range(l):
        leaf_start[i] = at
        node = head[i]
        while node >= 0:
            order[at] = mo[node]
            at += 1
            node = nxt[node]
    assert at == n

    if l == 1:
        return HostBVH(leaf_lo, leaf_hi, np.zeros(1, np.int32),
                       np.full(1, n, np.int32), np.ones(1, np.int32),
                       np.array([-1], np.int32), np.array([-1], np.int32),
                       order)

    # --- phase 2: unrestricted PLOC over the leaves to the root --------
    node_id = np.arange(l, dtype=np.int64) + (l - 1)  # leaf global ids
    left = np.zeros(l - 1, np.int64)
    right = np.zeros(l - 1, np.int64)
    int_lo = np.zeros((l - 1, 3), np.float32)
    int_hi = np.zeros((l - 1, 3), np.float32)
    created = 0
    cur_lo = leaf_lo.copy()
    cur_hi = leaf_hi.copy()
    m_act = l
    while m_act > 1:
        best_cost = np.full(m_act, np.inf, np.float32)
        best_j = np.full(m_act, -1, np.int64)
        w = min(window, m_act - 1)
        for dlt in range(1, w + 1):
            u_lo = np.minimum(cur_lo[:m_act - dlt], cur_lo[dlt:m_act])
            u_hi = np.maximum(cur_hi[:m_act - dlt], cur_hi[dlt:m_act])
            c = _sa(u_lo, u_hi)
            m1 = c < best_cost[:m_act - dlt]
            best_cost[:m_act - dlt][m1] = c[m1]
            best_j[:m_act - dlt][m1] = np.arange(dlt, m_act)[m1]
            m2 = c < best_cost[dlt:m_act]
            best_cost[dlt:m_act][m2] = c[m2]
            best_j[dlt:m_act][m2] = np.arange(0, m_act - dlt)[m2]
        i_arr = np.arange(m_act)
        mutual = (best_j[best_j] == i_arr) & (i_arr < best_j)
        idx_i = i_arr[mutual]
        idx_j = best_j[mutual]
        assert idx_i.shape[0] > 0, "global min pair is always mutual"
        cidx = created + np.arange(idx_i.shape[0])
        left[cidx] = node_id[idx_i]
        right[cidx] = node_id[idx_j]
        int_lo[cidx] = np.minimum(cur_lo[idx_i], cur_lo[idx_j])
        int_hi[cidx] = np.maximum(cur_hi[idx_i], cur_hi[idx_j])
        created += idx_i.shape[0]
        node_id[idx_i] = cidx  # creation ids (< l-1) are disjoint from
        cur_lo[idx_i] = int_lo[cidx]  # leaf ids (>= l-1)
        cur_hi[idx_i] = int_hi[cidx]
        keep = np.ones(m_act, bool)
        keep[idx_j] = False
        m_new = int(keep.sum())
        node_id[:m_new] = node_id[:m_act][keep]
        cur_lo[:m_new] = cur_lo[:m_act][keep]
        cur_hi[:m_new] = cur_hi[:m_act][keep]
        m_act = m_new
    # Remap creation index c -> internal id (l-2) - c so the root is 0.
    remap = lambda x: np.where(x >= l - 1, x, (l - 2) - x)
    fin = (l - 2) - np.arange(l - 1)
    fl = np.zeros(l - 1, np.int64)
    fr = np.zeros(l - 1, np.int64)
    flo = np.zeros((l - 1, 3), np.float32)
    fhi = np.zeros((l - 1, 3), np.float32)
    fl[fin] = remap(left)
    fr[fin] = remap(right)
    flo[fin] = int_lo
    fhi[fin] = int_hi

    # --- pre-order flatten with skip links ------------------------------
    # Subtree sizes by fixpoint over the child arrays (<= depth passes).
    known = np.zeros(l - 1, bool)
    sz = np.zeros(l - 1, np.int64)

    def child_size(c):
        cc = np.minimum(np.maximum(c, 0), l - 2)
        return np.where(c >= l - 1, 1, np.where(known[cc], sz[cc], -1))

    for _ in range(l):
        if known.all():
            break
        ls = child_size(fl)
        rs = child_size(fr)
        ok = (~known) & (ls > 0) & (rs > 0)
        if not ok.any():
            break
        sz[ok] = ls[ok] + rs[ok] + 1
        known |= ok
    assert known.all(), "subtree-size fixpoint did not converge"

    m = 2 * l - 1
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    node_tri = np.full(m, -1, np.int32)
    node_ntri = np.zeros(m, np.int32)
    node_skip = np.empty(m, np.int32)
    node_data = np.empty(m, np.int32)
    node_count = np.empty(m, np.int32)
    out = 0
    stack = [(0, m)]
    while stack:
        g, sk = stack.pop()
        my = out
        out += 1
        node_skip[my] = sk
        if g >= l - 1:  # leaf
            li = g - (l - 1)
            node_min[my] = leaf_lo[li]
            node_max[my] = leaf_hi[li]
            node_tri[my] = leaf_start[li]
            node_ntri[my] = leaf_cnt[li]
            node_data[my] = -(int(leaf_start[li]) + 1)
            node_count[my] = -1
        else:
            node_min[my] = flo[g]
            node_max[my] = fhi[g]
            lsz = 1 if fl[g] >= l - 1 else int(sz[fl[g]])
            right_at = my + 1 + lsz
            node_data[my] = my + 1
            node_count[my] = right_at
            stack.append((int(fr[g]), sk))       # right inherits my skip
            stack.append((int(fl[g]), right_at))  # left escapes to right
    assert out == m
    _log.debug("PLOC build: %d tris -> %d leaves, %d nodes in %.1f ms",
               n, l, m, (time.perf_counter() - t0) * 1e3)
    return HostBVH(node_min, node_max, node_tri, node_ntri, node_skip,
                   node_data, node_count, order)

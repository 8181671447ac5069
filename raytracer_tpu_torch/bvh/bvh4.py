"""Binary BVH -> 8-wide BVH collapse (host side, NumPy).

The same construction and table as ``raytracer_tpu.bvh.bvh4.collapse4`` at
width 8: take a binary internal node's two children and repeatedly expand
the largest-surface-area internal slot until 8 slots are filled or all
are leaves. One wide node = one 128-float row = 8 children x [min(3)
max(3) meta pad(9)]; meta is a float-encoded exact int (> 0 internal wide
id + 1, < 0 leaf -((cid | (count-1) << 20) + 1), 0 empty slot).
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch.core.fast_types import (CLUSTER_SIZE,
                                                 LEAF_CID_BITS, WIDE_WIDTH)

# Traversal stack bound of kernels A and B: each visit pops 1 and pushes at
# most WIDE_WIDTH entries, so the stack never exceeds (WIDE_WIDTH-1) *
# depth + 1 (``stack_need``). The collapse refuses to build a tree that
# would need more than STACK_CAP slots, and ``fast_scene_from_numpy``
# refuses such a table built elsewhere.
STACK_CAP = 256


def stack_need(max_depth: int) -> int:
    """Stack slots a walk of a wide tree of this maximum node depth (root
    at 0) can reach."""
    return (WIDE_WIDTH - 1) * (max_depth + 1) + 1


def nodes4_stack_need(nodes4: np.ndarray) -> int:
    """``stack_need`` of a wide table, from a depth pass over its internal
    children (meta > 0) from the root row. Stops at the first depth whose
    need passes STACK_CAP, so a table with a cycle ends too."""
    meta = np.asarray(nodes4, np.float32).reshape(
        nodes4.shape[0], WIDE_WIDTH, 16)[:, :, 6]
    level, depth = np.zeros(1, np.int64), 0
    while stack_need(depth) <= STACK_CAP:
        m = meta[level]
        level = np.unique(m[m > 0]).astype(np.int64) - 1
        if level.size == 0:
            break
        depth += 1
    return stack_need(depth)


def collapse4(nodes8: np.ndarray, num_nodes: int,
              cluster_counts: np.ndarray) -> tuple[np.ndarray, int]:
    """Collapse pre-order binary ``nodes8`` (bounds + bitcast-i32 skip /
    col7 links) into the 8-wide table -> (f32[n_wide, 128], n_wide).

    ``cluster_counts``: i32[L] live-triangle count per cluster id, encoded
    into the leaf metas so the kernels skip padded half-clusters.
    """
    width = WIDE_WIDTH
    nodes = np.asarray(nodes8)[:num_nodes]
    links = nodes[:, 6:8].view(np.int32)
    skip, col7 = links[:, 0], links[:, 1]

    def area(b):
        d = np.maximum(b[3:6] - b[0:3], 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    out = []      # wide id -> list of ('leaf'|'int', id, bounds)
    b2q = {}      # binary internal id -> wide id
    depth = {}    # binary internal id -> wide-tree depth
    max_depth = 0
    pending = []

    def create(b):
        nonlocal max_depth
        my = len(out)
        b2q[b] = my
        d_my = depth.get(b, 0)
        max_depth = max(max_depth, d_my)
        left = b + 1
        slots = [left, skip[left]]
        while len(slots) < width:
            best, best_a = -1, -1.0
            for i, s in enumerate(slots):
                if col7[s] < 0 and area(nodes[s]) > best_a:
                    best, best_a = i, area(nodes[s])
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend([s + 1, skip[s + 1]])
        ent = []
        for s in slots:
            if col7[s] >= 0:
                ent.append(("leaf", int(col7[s]), nodes[s, :6]))
            else:
                ent.append(("int", int(s), nodes[s, :6]))
                depth[int(s)] = d_my + 1
                pending.append(int(s))
        out.append(ent)

    if col7[0] >= 0:
        out.append([("leaf", int(col7[0]), nodes[0, :6])])
    else:
        create(0)
        while pending:
            create(pending.pop())

    worst_sp = stack_need(max_depth)
    if worst_sp > STACK_CAP:
        raise ValueError(
            f"wide-BVH depth {max_depth + 1} would need {worst_sp} stack "
            f"slots > STACK_CAP {STACK_CAP}")

    def leaf_meta(cid):
        cnt = int(cluster_counts[cid])
        if not (1 <= cnt <= CLUSTER_SIZE and cid < (1 << LEAF_CID_BITS)):
            raise ValueError(f"bad cluster {cid} (count {cnt})")
        return -((cid | ((cnt - 1) << LEAF_CID_BITS)) + 1)

    n4 = len(out)
    arr = np.zeros((n4, 16 * width), np.float32)
    for qid, ent in enumerate(out):
        for c, (kind, ident, bounds) in enumerate(ent):
            base = 16 * c
            arr[qid, base:base + 6] = bounds
            arr[qid, base + 6] = (leaf_meta(ident) if kind == "leaf"
                                  else b2q[ident] + 1)
    return arr, n4

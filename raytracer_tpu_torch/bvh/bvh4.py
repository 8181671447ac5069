"""Binary BVH -> wide BVH collapse (host side, NumPy).

The same construction and table as ``raytracer_tpu.bvh.bvh4.collapse4`` at
width 8 or 16: take a binary internal node's two children and repeatedly
expand the largest-surface-area internal slot until ``width`` slots are
filled or all are leaves. One wide node = ``width`` children x [min(3)
max(3) meta pad(9)]: one 128-float row at width 8, two consecutive rows
at width 16 (node i at rows 2i, 2i + 1). meta is a float-encoded exact
int (> 0 internal wide id + 1, < 0 leaf -((cid | (count-1) << 20) + 1),
0 empty slot).
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch.core.fast_types import (CLUSTER_ROW, LEAF_CID_BITS,
                                                 check_layout)

# Traversal stack bound of kernels A and B: each visit pops 1 and pushes at
# most ``width`` entries, so the stack never exceeds (width - 1) * depth +
# 1 (``stack_need``). The collapse refuses to build a tree that
# would need more than STACK_CAP slots, and ``fast_scene_from_numpy``
# refuses such a table built elsewhere.
STACK_CAP = 256


def stack_need(max_depth: int, width: int) -> int:
    """Stack slots a walk of a ``width``-wide tree of this maximum node
    depth (root at 0) can reach."""
    return (width - 1) * (max_depth + 1) + 1


def nodes4_stack_need(nodes4: np.ndarray, width: int) -> int:
    """``stack_need`` of a ``width``-wide table, from a depth pass over its
    internal children (meta > 0) from the root node. Stops at the first
    depth whose need passes STACK_CAP, so a table with a cycle ends
    too."""
    meta = np.asarray(nodes4, np.float32).reshape(-1, width, 16)[:, :, 6]
    level, depth = np.zeros(1, np.int64), 0
    while stack_need(depth, width) <= STACK_CAP:
        m = meta[level]
        level = np.unique(m[m > 0]).astype(np.int64) - 1
        if level.size == 0:
            break
        depth += 1
    return stack_need(depth, width)


def collapse4(nodes8: np.ndarray, num_nodes: int,
              cluster_counts: np.ndarray | None, *, cluster_size: int,
              width: int, return_depth: bool = False,
              return_slots: bool = False):
    """Collapse pre-order binary ``nodes8`` (bounds + bitcast-i32 skip /
    col7 links) into the ``width``-wide table (8 or 16) -> (f32[n_wide *
    width / 8, 128], n_wide [, depth][, slot_rows]).

    ``cluster_counts``: i32[L] live-triangle count per cluster id (1 ..
    ``cluster_size``), encoded into the leaf metas so the kernels skip
    padded half-clusters; None encodes full counts
    (``RAYTPU_LEAF_COUNTS=0``).
    ``return_depth`` adds the wide tree's depth (max node depth + 1), so a
    caller that grafts the table under more levels (the instanced TLAS,
    ``scene/instanced.py``) can check the stack bound again;
    ``return_slots`` adds i32[n_wide, width], the binary row each slot's
    bounds came from (-1 empty), the map the device refit gathers fresh
    boxes through (``scene/refit.py``).
    """
    check_layout(cluster_size, width)
    nodes = np.asarray(nodes8)[:num_nodes]
    links = nodes[:, 6:8].view(np.int32)
    skip, col7 = links[:, 0], links[:, 1]

    def area(b):
        d = np.maximum(b[3:6] - b[0:3], 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    out = []      # wide id -> list of ('leaf'|'int', id, bounds, row)
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
                ent.append(("leaf", int(col7[s]), nodes[s, :6], int(s)))
            else:
                ent.append(("int", int(s), nodes[s, :6], int(s)))
                depth[int(s)] = d_my + 1
                pending.append(int(s))
        out.append(ent)

    if col7[0] >= 0:
        out.append([("leaf", int(col7[0]), nodes[0, :6], 0)])
    else:
        create(0)
        while pending:
            create(pending.pop())

    worst_sp = stack_need(max_depth, width)
    if worst_sp > STACK_CAP:
        raise ValueError(
            f"wide-BVH depth {max_depth + 1} would need {worst_sp} stack "
            f"slots > STACK_CAP {STACK_CAP}")

    def leaf_meta(cid):
        cnt = (cluster_size if cluster_counts is None
               else int(cluster_counts[cid]))
        if not (1 <= cnt <= cluster_size and cid < (1 << LEAF_CID_BITS)):
            raise ValueError(f"bad cluster {cid} (count {cnt})")
        return -((cid | ((cnt - 1) << LEAF_CID_BITS)) + 1)

    n4 = len(out)
    arr = np.zeros((n4, 16 * width), np.float32)
    for qid, ent in enumerate(out):
        for c, (kind, ident, bounds, _) in enumerate(ent):
            base = 16 * c
            arr[qid, base:base + 6] = bounds
            arr[qid, base + 6] = (leaf_meta(ident) if kind == "leaf"
                                  else b2q[ident] + 1)
    ret = (arr.reshape(-1, CLUSTER_ROW), n4)
    if return_depth:
        ret += (max_depth + 1,)
    if return_slots:
        slot_rows = np.full((n4, width), -1, np.int32)
        for qid, ent in enumerate(out):
            for c, e in enumerate(ent):
                slot_rows[qid, c] = e[3]
        ret += (slot_rows,)
    return ret

"""Kernels A and 5: closest hit over the 8-wide BVH (``csrc/trace4.cu``)
and over the binary BVH (``csrc/trace2.cu``).

Replaces the Pallas kernel ``raytracer_tpu/kernels/pallas_trace.py``
``_trace4_kernel`` (reached through ``_trace4_call`` and
``pallas_traverse``). The TPU kernel walks one shared node stack per
1024-ray tile and orders child pushes by the tile's mean direction; here
each ray walks its own stack and orders pushes by its own direction. The
slab test, Möller–Trumbore on precomputed edges, strict ``t < closest``,
the half-cluster skip and the deferred normal flip are the same, so the
closest ``t`` is the same; on an exact equal-t tie the winning triangle
(normal, albedo, type, cluster id) may differ. The flip is skipped for the
fixed-light tier, whose shading wants the raw geometric normal.

Kernel 5 (``trace2``) replaces ``pallas_trace.py`` ``_trace_kernel``: the
stackless skip-link walk of the binary ``nodes8`` table in pre-order (a hit
internal node goes to its left child, anything else to its skip link).
The TPU tile walk and a per-ray walk visit a ray's leaves in the same
order (a child box lies inside its parent's, so a ray that hits the child
hits the parent), so closest hit and winner agree bit for bit, ties
included. It has two designs on the card: one thread per ray
(``rt_trace2``, for the split rounds) and one node id per warp
(``rt_trace2_warp``, the union walk, for coherent primaries); the caller
says which (``coherent``). ``traverse`` picks kernel A or 5 by the path
knobs (``raytracer_tpu_torch/knobs.py``), as ``pallas_traverse`` does.

``walk_plain`` is the plain PyTorch version of the per-ray walk, shared
with kernel B's plain version (``kernels/bounce.py``). It advances every
unfinished ray by one node visit per step and is bit-equal to the CUDA
walk: the same comparator network orders the pushes, and the leaf phase
picks, per ray, the first strict minimum in (child, triangle) order, which
is what the kernel's sequential ``t < closest`` updates keep.

Every walk takes the table layout from the scene (``FastScene.layout``):
it reads nodes through ``node_rows`` (one ``wide_width``-wide node a row,
two table rows at width 16) and leaves through ``leaf_rows`` (one leaf of
``cluster_size`` records a row), and its kernel comes from the library
built for that layout (``cuda_build.library``; the binary walks, which
read no wide node, the library of ``cuda_build.leaf_layout``), booked
under the layout's name (``cuda_build.kernel_name``: "trace4_c4",
"trace2_c2", ...). A scene with no wide table (``nodes4`` None) walks
the binary one.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.bvh.bvh4 import STACK_CAP
from raytracer_tpu_torch.core.fast_types import (FastScene, LEAF_CID_BITS,
                                                 LEAF_CID_MASK)
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import cuda_build, launches
from raytracer_tpu_torch.kernels.tracer import TraversalResult

BLOCK_LANES = 128
BLOCK = 8 * BLOCK_LANES    # primary tile: rays per compact pixel tile
BBLOCK = 16 * BLOCK_LANES  # bounce-round grain: every width is a multiple

# Push-ordering comparator network of an 8-wide node (19 comparators),
# the JAX package's ``pallas_trace._HIST8``: sorts (key, meta, push) by
# descending key.
NET8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
        (2, 4), (3, 5), (3, 4))


def batcher_network(n: int) -> tuple[tuple[int, int], ...]:
    """Batcher odd-even mergesort comparators for n a power of two (63
    at n = 16), in the order of the JAX package's
    ``pallas_trace.batcher_network``, which orders a 16-wide node's
    pushes: the order decides equal-key ties."""
    net = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        net.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(net)


def pick_tile(h: int, w: int, block: int = BLOCK):
    """Most compact (th, tw) pixel tile of ``block`` rays dividing the
    frame, or None."""
    th = 1
    while th * th < block:
        th *= 2
    while th >= 1:
        tw = block // th
        if h % th == 0 and w % tw == 0:
            return th, tw
        th //= 2
    return None


def _mt_candidates(tri, o, d, closest, full, t_min, det_eps):
    """Möller–Trumbore of q rays against their q clusters of cs
    triangles (tri f32[q, cs, 16]; o, d 3 x f32[q]) -> t f32[q, cs], inf
    where the triangle is not a hit closer than ``closest``; the second
    half of the cluster only where ``full``."""
    c = lambda j: tri[:, :, j]
    v0x, v0y, v0z = c(0), c(1), c(2)
    e1x, e1y, e1z = c(3), c(4), c(5)
    e2x, e2y, e2z = c(6), c(7), c(8)
    rox, roy, roz = (a[:, None] for a in o)
    rdx, rdy, rdz = (a[:, None] for a in d)
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = ~((det > -det_eps) & (det < det_eps))
    invd = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = rox - v0x, roy - v0y, roz - v0z
    u = invd * (sx * pvx + sy * pvy + sz * pvz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = invd * (rdx * qx + rdy * qy + rdz * qz)
    tt = invd * (e2x * qx + e2y * qy + e2z * qz)
    ok &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    ok &= (tt > t_min) & (tt < closest[:, None])
    # The second half-cluster only counts when the leaf holds > cs / 2.
    cs = tri.shape[1]
    half = torch.arange(cs, device=tri.device) < cs // 2
    ok &= half[None, :] | full[:, None]
    return torch.where(ok, tt, torch.inf)


def _face_ray(out: torch.Tensor, ray_d, flip: bool) -> None:
    """The deferred flip: the winner's normal faces the ray (no-hit lanes
    hold n == 0 and stay so). In place on out f32[8, P]."""
    if flip:
        dot = ray_d[0] * out[1] + ray_d[1] * out[2] + ray_d[2] * out[3]
        out[1:4] = torch.where(dot > 0.0, -1.0, 1.0) * out[1:4]


def walk_plain(node_rows: torch.Tensor, leaf_rows: torch.Tensor, ray_o,
               ray_d, active: torch.Tensor, t_min: float, t_max: float,
               det_eps: float, flip: bool = True, ordered: bool = True):
    """Per-ray stack walk, plain torch, over the wide table as one node a
    row (``FastScene.node_rows``, f32[N, W * 16], W = 8 or 16) and the
    cluster table as one leaf a row (``FastScene.leaf_rows``, f32[L, cs *
    16]). Returns (out f32[8, P] = t, normal xyz, albedo rgb, material
    type; cid i32[P] = winner cluster id, 0 on a miss or for inactive
    rays). ``ordered=False`` pushes a visit's hit internal children in
    slot order, without the near-first network (the JAX kernel's
    ``ordered=False``, ``pallas_mega.py:264-266``). Counts in
    ``launches.work`` the work the walk needs: node visits (``visits4``),
    slab tests and keys of live child slots (``slots4``), visits that push
    two children or more and so need the sorting network (``nets4`` at
    width 8, ``nets16`` at 16; the ordered walk only), and tests of live
    triangles (``tris``, each hit leaf's count); keeps the largest stack
    depth reached as ``stack4_max``."""
    dev = active.device
    p = active.shape[0]
    width = node_rows.shape[1] // 16
    cs = leaf_rows.shape[1] // 16
    # The push order: NET8 at width 8, batcher_network(16) at 16 (the JAX
    # package's pallas_trace._NET8), each run counted under its own key.
    net, net_key = ((NET8, "nets4") if width == 8
                    else (batcher_network(width), "nets16"))
    out = torch.zeros((8, p), dtype=torch.float32, device=dev)
    out[0] = t_max
    cid_out = torch.zeros(p, dtype=torch.int32, device=dev)
    ids = torch.nonzero(active).squeeze(1)
    n = ids.numel()
    if n:
        o = torch.stack([c[ids] for c in ray_o])          # [3, n]
        d = torch.stack([c[ids] for c in ray_d])
        iv = 1.0 / d
        best = torch.zeros((8, n), dtype=torch.float32, device=dev)
        best[0] = t_max
        bcid = torch.zeros(n, dtype=torch.int32, device=dev)
        # One spare column: a non-pushing child writes (and never reads)
        # the slot just above the top, which may be index STACK_CAP.
        stack = torch.zeros((n, STACK_CAP + 1), dtype=torch.int32,
                            device=dev)
        sp = torch.zeros(n, dtype=torch.int64, device=dev)
        nid = torch.zeros(n, dtype=torch.int64, device=dev)
        li = torch.arange(n, device=dev)                  # walking rays
        while li.numel():
            m = li.numel()
            launches.work["visits4"] += m
            oo, dd, ii = o[:, li], d[:, li], iv[:, li]
            node = node_rows.index_select(0, nid[li]).view(m, width, 16)
            lo = (node[:, :, 0:3] - oo.T[:, None, :]) * ii.T[:, None, :]
            hi = (node[:, :, 3:6] - oo.T[:, None, :]) * ii.T[:, None, :]
            mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
            t_en = torch.maximum(mn[..., 0], torch.maximum(mn[..., 1],
                                                           mn[..., 2]))
            t_ex = torch.minimum(mx[..., 0], torch.minimum(mx[..., 1],
                                                           mx[..., 2]))
            closest = best[0, li]
            hit = ((t_ex > t_en) & (t_ex > t_min)
                   & (t_en < closest[:, None]))            # [m, W]
            meta = node[:, :, 6].to(torch.int32)
            launches.work["slots4"] += int((meta != 0).sum())
            key = ((node[:, :, 0] + node[:, :, 3]) * dd[0][:, None]
                   + (node[:, :, 1] + node[:, :, 4]) * dd[1][:, None]
                   + (node[:, :, 2] + node[:, :, 5]) * dd[2][:, None])

            # Far-first push order (or slot order), then push the hit
            # internal children.
            ks = [key[:, c] for c in range(width)]
            ms = [meta[:, c] for c in range(width)]
            push = hit & (meta > 0)
            ps = [push[:, c] for c in range(width)]
            if ordered:
                launches.work[net_key] += int((push.sum(1) >= 2).sum())
                for i, j in net:
                    sw = ks[j] > ks[i]
                    for f in (ks, ms, ps):
                        f[i], f[j] = (torch.where(sw, f[j], f[i]),
                                      torch.where(sw, f[i], f[j]))
            lsp = sp[li]
            for c in range(width):
                stack[li, lsp] = ms[c] - 1
                lsp = lsp + ps[c]
            launches.work["stack4_max"] = max(launches.work["stack4_max"],
                                              int(lsp.max()))

            # Leaf children, in child order.
            pr, pc = torch.nonzero(hit & (meta < 0), as_tuple=True)
            if pr.numel():
                lid = -meta[pr, pc] - 1
                cidp = lid & LEAF_CID_MASK
                full = (lid >> LEAF_CID_BITS) >= cs // 2
                launches.work["tris"] += int((lid >> LEAF_CID_BITS).sum()
                                             + pr.numel())
                tri = leaf_rows.index_select(0, cidp.to(torch.int64)).view(
                    -1, cs, 16)
                cand = _mt_candidates(
                    tri, [oo[a, pr] for a in range(3)],
                    [dd[a, pr] for a in range(3)], closest[pr], full,
                    t_min, det_eps).reshape(-1)
                owner = pr.repeat_interleave(cs)
                mins = torch.full((m,), torch.inf, device=dev).scatter_reduce(
                    0, owner, cand, "amin")
                pos = torch.arange(cand.numel(), device=dev)
                win = (cand == mins[owner]) & (cand < torch.inf)
                first = torch.full((m,), cand.numel(), device=dev,
                                   dtype=torch.int64).scatter_reduce(
                    0, owner[win], pos[win], "amin")
                has = first < cand.numel()
                wpos = first[has]
                row, k = wpos // cs, wpos % cs
                rec = tri[row, k]                         # [h, 16]
                upd = li[has]
                best[0, upd] = cand[wpos]
                best[1:4, upd] = rec[:, 13:16].T
                best[4:7, upd] = rec[:, 9:12].T
                best[7, upd] = rec[:, 12]
                bcid[upd] = cidp[row]

            have = lsp > 0
            lsp = torch.where(have, lsp - 1, lsp)
            sp[li] = lsp
            nid[li] = stack[li, lsp].to(torch.int64)
            li = li[have]
        out[:, ids] = best
        cid_out[ids] = bcid
    _face_ray(out, ray_d, flip)
    return out, cid_out


def walk2_plain(nodes8: torch.Tensor, num_nodes: int,
                leaf_rows: torch.Tensor, counts: torch.Tensor, ray_o,
                ray_d, active: torch.Tensor, t_min: float, t_max: float,
                det_eps: float, flip: bool):
    """Per-ray skip-link walk of the binary table, plain torch -> out
    f32[8, P] (t, normal xyz, albedo rgb, type). Every unfinished ray
    visits one node per step; a leaf it hits tests all cs triangles of its
    cluster (``leaf_rows`` f32[L, cs * 16], one leaf a row) in order
    (strict ``t < closest``: the first strict minimum wins). Counts node
    visits and the tests of live triangles (``counts``, i32[L] per leaf;
    the rest never hit) in ``launches.work``."""
    dev = active.device
    p = active.shape[0]
    cs = leaf_rows.shape[1] // 16
    out = torch.zeros((8, p), dtype=torch.float32, device=dev)
    out[0] = t_max
    ids = torch.nonzero(active).squeeze(1)
    n = ids.numel()
    if n:
        o = torch.stack([c[ids] for c in ray_o])          # [3, n]
        d = torch.stack([c[ids] for c in ray_d])
        iv = 1.0 / d
        best = torch.zeros((8, n), dtype=torch.float32, device=dev)
        best[0] = t_max
        # Columns 6-7 are i32 bits: skip link, and the leaf's cluster id
        # (>= 0) or -(left child + 1) for an internal node.
        links = nodes8[:, 6:8].contiguous().view(torch.int32)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        li = torch.arange(n, device=dev)                  # walking rays
        while li.numel():
            launches.work["visits2"] += li.numel()
            nid = node[li]
            row = nodes8.index_select(0, nid)               # [m, 8]
            oo, dd, ii = o[:, li].T, d[:, li].T, iv[:, li].T
            lo = (row[:, 0:3] - oo) * ii
            hi = (row[:, 3:6] - oo) * ii
            mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
            t_en = torch.maximum(mn[:, 0], torch.maximum(mn[:, 1], mn[:, 2]))
            t_ex = torch.minimum(mx[:, 0], torch.minimum(mx[:, 1], mx[:, 2]))
            closest = best[0, li]
            hit = (t_ex > t_en) & (t_ex > t_min) & (t_en < closest)
            skip, col7 = links[nid, 0], links[nid, 1]
            leaf = torch.nonzero(hit & (col7 >= 0)).squeeze(1)
            q = leaf.numel()
            if q:
                cids = col7[leaf].to(torch.int64)
                launches.work["tris"] += int(counts[cids].sum())
                tri = leaf_rows.index_select(0, cids).view(-1, cs, 16)
                cand = _mt_candidates(
                    tri, list(oo[leaf].T), list(dd[leaf].T), closest[leaf],
                    torch.ones(q, dtype=torch.bool, device=dev), t_min,
                    det_eps)
                mins = cand.min(1).values
                k = (cand == mins[:, None]).to(torch.int8).argmax(1)
                has = mins < torch.inf
                rec = tri[torch.arange(q, device=dev), k][has]
                upd = li[leaf[has]]
                best[0, upd] = mins[has]
                best[1:4, upd] = rec[:, 13:16].T
                best[4:7, upd] = rec[:, 9:12].T
                best[7, upd] = rec[:, 12]
            nxt = torch.where(hit & (col7 < 0), -col7 - 1, skip)
            node[li] = nxt.to(torch.int64)
            li = li[nxt < num_nodes]
        out[:, ids] = best
    _face_ray(out, ray_d, flip)
    return out


def _check_table(scene: FastScene, name: str, cols: int,
                 device: torch.device) -> None:
    t = getattr(scene, name)
    if (t.device != device or t.dtype != torch.float32
            or not t.is_contiguous() or t.dim() != 2 or t.shape[1] != cols
            or (t.is_cuda and t.data_ptr() % 16)):
        raise ValueError(f"scene.{name} must be contiguous f32[R, {cols}] "
                         f"on {device} (16-byte aligned on CUDA)")


def _check_scene(scene: FastScene, device: torch.device) -> None:
    if scene.nodes4 is None:
        raise ValueError("the scene has no wide table (nodes4 is None): "
                         "walk the binary one")
    _check_table(scene, "nodes4", 128, device)
    _check_table(scene, "clusters", 128, device)


def _check_rays(rays: torch.Tensor, active: torch.Tensor) -> None:
    if (rays.dtype != torch.float32 or rays.dim() != 2
            or rays.shape[0] != 6 or not rays.is_contiguous()):
        raise ValueError("rays must be contiguous f32[6, P]")
    if (active.dtype != torch.bool or active.shape != rays.shape[1:]
            or active.device != rays.device):
        raise ValueError("active must be bool[P] on the rays' device")


def _flip(cfg: RenderConfig) -> bool:
    """Normals face the ray except in the fixed-light tier."""
    return cfg.shading != "fixed_light"


def trace4_plain(scene: FastScene, rays: torch.Tensor, active: torch.Tensor,
                 cfg: RenderConfig) -> torch.Tensor:
    """Plain version of kernel A: rays f32[6, P] (origin xyz, direction
    xyz), active bool[P] -> f32[8, P] (t, normal xyz, albedo rgb, type)."""
    _check_scene(scene, rays.device)
    _check_rays(rays, active)
    launches.plain[cuda_build.kernel_name("trace4", scene.layout)] += 1
    out, _ = walk_plain(scene.node_rows, scene.leaf_rows, rays[0:3],
                        rays[3:6], active, cfg.t_min, cfg.t_max, cfg.det_eps,
                        _flip(cfg))
    return out


def trace4(scene: FastScene, rays: torch.Tensor, active: torch.Tensor,
           cfg: RenderConfig) -> torch.Tensor:
    """Kernel A on CUDA tensors, its plain version on CPU tensors (same
    arguments and result as ``trace4_plain``)."""
    if rays.device.type == "cpu":
        return trace4_plain(scene, rays, active, cfg)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    _check_scene(scene, rays.device)
    _check_rays(rays, active)
    p = rays.shape[1]
    out = torch.empty((8, p), dtype=torch.float32, device=rays.device)
    act = active.to(torch.uint8)
    lib = cuda_build.library(scene.layout)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.check(lib.rt_trace4(
        scene.nodes4.data_ptr(), scene.clusters.data_ptr(), rays.data_ptr(),
        act.data_ptr(), out.data_ptr(), p, cfg.t_min, cfg.t_max,
        cfg.det_eps, int(_flip(cfg)), stream), "rt_trace4")
    launches.kernel[cuda_build.kernel_name("trace4", scene.layout)] += 1
    return out


def _check_scene2(scene: FastScene, device: torch.device) -> None:
    _check_table(scene, "nodes8", 8, device)
    _check_table(scene, "clusters", 128, device)
    if not 0 < scene.num_nodes <= scene.nodes8.shape[0]:
        raise ValueError("scene.num_nodes out of range")
    c = scene.cluster_counts
    if (c.device != device or c.dtype != torch.int32
            or c.shape != scene.leaf_rows.shape[:1]
            or not c.is_contiguous()):
        raise ValueError("scene.cluster_counts must be contiguous i32[L], "
                         "one count a leaf of scene.clusters")


def trace2_plain(scene: FastScene, rays: torch.Tensor, active: torch.Tensor,
                 cfg: RenderConfig, coherent: bool = False) -> torch.Tensor:
    """Plain version of kernel 5 (binary walk), of both its designs
    (``coherent`` changes nothing here); arguments and result as
    ``trace4_plain``."""
    _check_scene2(scene, rays.device)
    _check_rays(rays, active)
    launches.plain[cuda_build.leaf_kernel_name("trace2", scene.layout)] += 1
    return walk2_plain(scene.nodes8, scene.num_nodes, scene.leaf_rows,
                       scene.cluster_counts, rays[0:3], rays[3:6], active,
                       cfg.t_min, cfg.t_max, cfg.det_eps, _flip(cfg))


def trace2(scene: FastScene, rays: torch.Tensor, active: torch.Tensor,
           cfg: RenderConfig, coherent: bool = False) -> torch.Tensor:
    """Kernel 5 on CUDA tensors, its plain version on CPU tensors (same
    arguments and result as ``trace2_plain``). ``coherent``: the rays of
    a warp are neighbouring primaries, so the warp walks the union of
    their paths (``trace2_warp``); else each thread walks its own ray
    (``trace2``). Both give the same result bit for bit."""
    if rays.device.type == "cpu":
        return trace2_plain(scene, rays, active, cfg)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    _check_scene2(scene, rays.device)
    _check_rays(rays, active)
    p = rays.shape[1]
    out = torch.empty((8, p), dtype=torch.float32, device=rays.device)
    act = active.to(torch.uint8)
    name = "trace2_warp" if coherent else "trace2"
    layout = cuda_build.leaf_layout(scene.layout)
    lib = cuda_build.library(layout)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.check(getattr(lib, f"rt_{name}")(
        scene.nodes8.data_ptr(), scene.clusters.data_ptr(),
        scene.cluster_counts.data_ptr(), rays.data_ptr(), act.data_ptr(),
        out.data_ptr(), p, scene.num_nodes, cfg.t_min, cfg.t_max,
        cfg.det_eps, int(_flip(cfg)), stream), f"rt_{name}")
    launches.kernel[cuda_build.kernel_name(name, layout)] += 1
    return out


def traverse(scene: FastScene, ray_o, ray_d, active, cfg: RenderConfig,
             coherent: bool = False) -> TraversalResult:
    """Closest hit for flat [P] SoA rays: kernel A over the wide table, or
    kernel 5 over the binary table when the knobs ask for it or the scene
    has no wide table (JAX ``pallas_traverse``; its warp design for
    ``coherent`` rays: tile-major primaries)."""
    return traverse_rays(scene, torch.stack([*ray_o, *ray_d]), active, cfg,
                         coherent)


def traverse_rays(scene: FastScene, rays: torch.Tensor, active,
                  cfg: RenderConfig, coherent: bool = False
                  ) -> TraversalResult:
    """``traverse`` of rays already in the walks' layout, f32[6, P]
    (origin xyz, direction xyz), as the ray-gen kernel writes them."""
    if knobs.binary_traverse() or scene.nodes4 is None:
        out = trace2(scene, rays, active, cfg, coherent)
    else:
        out = trace4(scene, rays, active, cfg)
    return TraversalResult(out[0], out[0] < cfg.t_max,
                           (out[1], out[2], out[3]),
                           (out[4], out[5], out[6]), out[7])

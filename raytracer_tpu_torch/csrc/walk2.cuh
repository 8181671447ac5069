// Per-ray skip-link walk of the binary BVH: walk2, kernel 5's per-ray
// design (trace2.cu, which also takes the slab test for its warp design),
// and its step form (Walk2, walk2_step), the mega kernel's (mega.cu).
//
// Table (core/fast_types.py): nodes8 f32[M, 8], one node per row, read as
// two 16-byte parts: (min xyz, max x), (max yz, skip, col7), the last two
// i32 bits (read with __float_as_int, never as values): the skip link, and
// col7 = cluster id >= 0 for a leaf or -(left + 1) for an internal node.
// Rows >= num_nodes are padding; the walk ends when the node id reaches
// num_nodes. clusters: leaves of kClusterSize records in cid order (the
// build's layout, walk.cuh), leaf cid at float cid * kLeafFloats.
// counts i32[L]: each leaf's live triangles (FastScene.cluster_counts);
// the records past them are all zero and never hit.
//
// The walk is the GLSL reference's pre-order, and that of the JAX
// package's XLA walks (kernels/packet.py ray_traverse_fast, packet_traverse
// and megakernel_bounces' traversal sub-step): a hit internal node goes to
// its left child, anything else (a miss, or a leaf after its triangles) to
// its skip link; a leaf's triangles are tested in slot order with strict
// t < closest, so the first strict minimum wins, as the JAX argmin over a
// cluster's 8 slots keeps the lowest slot on a tie.
#pragma once

#include "walk.cuh"

namespace rt {

// Slab test of one nodes8 row against the ray's closest t.
__device__ __forceinline__ bool slab_hit(const float4& a, const float4& b,
                                         const Ray& r, float ivx, float ivy,
                                         float ivz, float t_min,
                                         float closest) {
  const float lo0 = (a.x - r.ox) * ivx, hi0 = (a.w - r.ox) * ivx;
  const float lo1 = (a.y - r.oy) * ivy, hi1 = (b.x - r.oy) * ivy;
  const float lo2 = (a.z - r.oz) * ivz, hi2 = (b.y - r.oz) * ivz;
  const float t_en =
      max_nan(min_nan(lo0, hi0), max_nan(min_nan(lo1, hi1), min_nan(lo2, hi2)));
  const float t_ex =
      min_nan(max_nan(lo0, hi0), min_nan(max_nan(lo1, hi1), max_nan(lo2, hi2)));
  return (t_ex > t_en) && (t_ex > t_min) && (t_en < closest);
}

// Closest hit of one ray (no normal flip): t = t_max and zeros on a miss.
// One thread walks one ray with postponed leaves (the "while-while" loop
// of Aila and Laine, Understanding the Efficiency of Ray Traversal on
// GPUs, HPG 2009): a lane that hits a leaf parks it and stops; the others
// keep walking until each has parked one or finished, then the warp tests
// its parked leaves together, each lane only its leaf's live triangles. A
// lane tests its parked leaf before it visits again, so each ray keeps its
// own visit and test order.
__device__ __forceinline__ Hit walk2(const float4* __restrict__ nodes,
                                     const float* __restrict__ clusters,
                                     const int* __restrict__ counts,
                                     int num_nodes, const Ray& r, float t_min,
                                     float t_max, float det_eps) {
  Hit h = {t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  const float ivx = 1.0f / r.dx, ivy = 1.0f / r.dy, ivz = 1.0f / r.dz;
  int node = 0;
  int leaf = -1;  // the parked leaf's cluster id
  while (true) {
    while (leaf < 0 && node < num_nodes) {
      const float4 lo = __ldg(nodes + 2 * node);
      const float4 hi = __ldg(nodes + 2 * node + 1);
      const bool hit = slab_hit(lo, hi, r, ivx, ivy, ivz, t_min, h.t);
      const int col7 = __float_as_int(hi.w);
      if (hit && col7 >= 0) leaf = col7;
      node = (hit && col7 < 0) ? -col7 - 1 : __float_as_int(hi.z);
    }
    if (leaf < 0) break;
    mt_tris(clusters + (size_t)leaf * kLeafFloats, 0, __ldg(counts + leaf), r,
            t_min, det_eps, leaf, h);
    leaf = -1;
  }
  return h;
}

// The same walk in step form, for a loop that runs one step of each
// lane's walk a trip (the mega kernel). A step visits nodes until the
// walk parks a leaf or ends, then tests the parked leaf, so the walk
// between steps holds no parked leaf; it has ended (closest hit in h)
// once node >= num_nodes. A walk run step after step to its end visits,
// tests and keeps its hit exactly as walk2 does.
struct Walk2 {
  int node;
  Hit h;
  float ivx, ivy, ivz;
};

__device__ __forceinline__ void walk2_start(Walk2& w, const Ray& r,
                                            float t_max) {
  w.node = 0;
  w.h = {t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  w.ivx = 1.0f / r.dx;
  w.ivy = 1.0f / r.dy;
  w.ivz = 1.0f / r.dz;
}

// count: the tallies of a counting build (LaneCount), or NoCount.
template <class C>
__device__ __forceinline__ void walk2_step(Walk2& w,
                                           const float4* __restrict__ nodes,
                                           const float* __restrict__ clusters,
                                           const int* __restrict__ counts,
                                           int num_nodes, const Ray& r,
                                           float t_min, float det_eps,
                                           C& count) {
  int leaf = -1;
  while (leaf < 0 && w.node < num_nodes) {
    count.visit();
    const float4 lo = __ldg(nodes + 2 * w.node);
    const float4 hi = __ldg(nodes + 2 * w.node + 1);
    const bool hit = slab_hit(lo, hi, r, w.ivx, w.ivy, w.ivz, t_min, w.h.t);
    const int col7 = __float_as_int(hi.w);
    if (hit && col7 >= 0) leaf = col7;
    w.node = (hit && col7 < 0) ? -col7 - 1 : __float_as_int(hi.z);
  }
  if (leaf >= 0) {
    count.leaf();
    mt_tris(clusters + (size_t)leaf * kLeafFloats, 0, __ldg(counts + leaf),
            r, t_min, det_eps, leaf, w.h);
  }
}

}  // namespace rt

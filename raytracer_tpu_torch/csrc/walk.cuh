// Per-ray closest-hit walk of the wide BVH, shared by kernel A
// (trace4.cu) and kernel B (bounce12.cu); the triangle test and the
// normal flip are shared with the binary walk (trace2.cu) too.
//
// Tables (core/fast_types.py), in the layout the library is built for
// (RT_CLUSTER, RT_WIDE; kernels/cuda_build.py builds one library a
// layout): nodes4 f32[R, 128], one wide node of kWide children every
// kWide / 8 rows (node i at rows 2i, 2i + 1 at width 16), each child
// [min xyz, max xyz, meta, pad x9]; clusters f32[R, 128], leaves of
// kClusterSize triangles x [v0, e1, e2, albedo rgb, type, unit normal]
// packed consecutively in cid order, so leaf cid starts at float
// cid * kClusterSize * 16 (128 / (kClusterSize * 16) leaves a row).
// meta > 0: internal child, wide id + 1; meta < 0: leaf,
// -((cid | (count - 1) << 20) + 1); meta == 0: empty slot.
//
// Semantics of raytracer_tpu/kernels/pallas_trace.py _trace4_kernel, per
// ray instead of per tile: kWide slab tests against the closest t at
// visit start, hit internal children pushed far-first by the comparator
// network on (min + max) . d with the ray's own direction (19 comparators
// at width 8, the JAX _HIST8; 63 at width 16, batcher_network(16)), leaf
// children in child order with Moller-Trumbore on the precomputed edges
// (det_eps, strict t < closest) over the leaf's live triangles, and the
// winner's normal flipped against the ray at the end when asked (the
// path-shading rule; the fixed-light tier keeps the raw normal).
//
// What bounds it on an H100 (PERF.md, measured on the flagship): issued
// instructions and the lanes of a warp that wait on each other, not
// memory. The tables (1.7 MB of nodes, 4.2 MB of clusters) stay in the
// 50 MB L2, a walk's loads hit L1 or L2, and the 1 KB stack in local memory
// measured as fast as the same stack in shared memory. What made the walk
// 2.9x (kernel A) and 3.7x (kernel B) faster than its first version was
// less work per visit and less divergence (see walk()): one instruction
// per NaN-propagating min / max instead of four, leaf tests over a bit
// mask of the hit leaves, only live triangles, and no sorting network
// for a ray that pushes fewer than two children. With that, kernel A uses
// about 58 registers and kernel B 66, for 8 and 7 resident 128-thread
// blocks per SM; 64- or 256-thread blocks and a register cap that buys
// more blocks (it spills) were not faster. Postponed leaves (walk<true>)
// made kernel B 3.5% slower (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// they add more visit trips than they save leaf trips; with warps that
// refill lanes in mid-walk they paid on one band's round and not on
// another's (bounce12.cu, bounce_packed_kernel).
//
// Build with -fmad=false and without fast math: every product, sum,
// division and square root rounds as in the plain PyTorch version.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace rt {

// The table layout of this build: triangles a leaf and children a wide
// node. The default build passes neither.
#ifndef RT_CLUSTER
#define RT_CLUSTER 8
#endif
#ifndef RT_WIDE
#define RT_WIDE 8
#endif
constexpr int kClusterSize = RT_CLUSTER;
constexpr int kWide = RT_WIDE;
constexpr int kLeafFloats = kClusterSize * 16;
constexpr int kNodeFloats = kWide * 16;
static_assert(kClusterSize == 2 || kClusterSize == 4 || kClusterSize == 8,
              "leaves of 2, 4 or 8 triangles");
static_assert(kWide == 8 || kWide == 16, "wide nodes of 8 or 16 children");

// The walk's stack, in local memory: bvh/bvh4.py STACK_CAP. collapse4 and
// fast_scene_from_numpy refuse a tree whose walk could push more
// ((kWide - 1) * (depth + 1) + 1 slots).
constexpr int kStackCap = 256;
constexpr int kLeafCidBits = 20;
constexpr int kLeafCidMask = (1 << kLeafCidBits) - 1;

// min / max that return NaN when either input is NaN, like jnp.minimum and
// torch.minimum (fminf / fmaxf drop it). A ray parallel to an axis has an
// infinite inverse direction, and (bound - origin) * inf is NaN when the
// origin lies on the slab plane: the slab test must then fail for the ray,
// as in the JAX and plain versions. One instruction each (min.NaN /
// max.NaN, sm_80 and later). They may give -0 where the plain version
// gives +0, but the walk only compares their results, and -0 == +0.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct Hit {
  float t, nx, ny, nz, ar, ag, ab, mt;
  int cid;  // winner cluster id, 0 on a miss
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// A 16-byte load: read-only through the L1 from global memory (kGlobal),
// or a plain load (a row staged in shared memory).
template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Moller-Trumbore against triangles [k0, k1) of one leaf, each record four
// 16-byte loads: (v0, e1.x), (e1.yz, e2.xy), (e2.z, albedo),
// and, for a win only, (type, normal).
template <bool kGlobal = true>
__device__ __forceinline__ void mt_tris(const float* __restrict__ cr, int k0,
                                        int k1, const Ray& r, float t_min,
                                        float det_eps, int cid, Hit& h) {
  const float4* __restrict__ rec = reinterpret_cast<const float4*>(cr);
  for (int k = k0; k < k1; ++k) {
    const float4 p = ld4<kGlobal>(rec + 4 * k);
    const float4 q = ld4<kGlobal>(rec + 4 * k + 1);
    const float4 u = ld4<kGlobal>(rec + 4 * k + 2);
    const float v0x = p.x, v0y = p.y, v0z = p.z;
    const float e1x = p.w, e1y = q.x, e1z = q.y;
    const float e2x = q.z, e2y = q.w, e2z = u.x;
    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    bool ok = !((det > -det_eps) && (det < det_eps));
    const float invd = 1.0f / (ok ? det : 1.0f);
    const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
    const float uu = invd * (sx * pvx + sy * pvy + sz * pvz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float vv = invd * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float tt = invd * (e2x * qx + e2y * qy + e2z * qz);
    ok = ok && (uu >= 0.0f) && (uu <= 1.0f) && (vv >= 0.0f) &&
         (uu + vv <= 1.0f) && (tt > t_min) && (tt < h.t);
    if (ok) {
      const float4 w = ld4<kGlobal>(rec + 4 * k + 3);
      h.t = tt;
      h.nx = w.y;
      h.ny = w.z;
      h.nz = w.w;
      h.ar = u.y;
      h.ag = u.z;
      h.ab = u.w;
      h.mt = w.x;
      h.cid = cid;
    }
  }
}

// The deferred flip: the winner's normal faces the ray. A miss holds
// n == 0: dot == 0, sgn == 1, unchanged.
__device__ __forceinline__ void face_ray(const Ray& r, Hit& h) {
  const float dot = r.dx * h.nx + r.dy * h.ny + r.dz * h.nz;
  const float sgn = dot > 0.0f ? -1.0f : 1.0f;
  h.nx = sgn * h.nx;
  h.ny = sgn * h.ny;
  h.nz = sgn * h.nz;
}

// Tallies of a counting build (LaneCount): the trips a warp makes through
// the walk's visit loop and through its leaf loop, and the lanes active
// in each, so that lanes / (32 x trips) is the loop's SIMD efficiency.
// Only the lowest active lane of a trip counts it. NoCount compiles away.
struct NoCount {
  static constexpr bool kOn = false;
  __device__ __forceinline__ void visit() {}
  __device__ __forceinline__ void leaf() {}
};

struct LaneCount {
  static constexpr bool kOn = true;
  unsigned visit_trips = 0, visit_lanes = 0, leaf_trips = 0, leaf_lanes = 0;
  __device__ __forceinline__ void visit() { tally(visit_trips, visit_lanes); }
  __device__ __forceinline__ void leaf() { tally(leaf_trips, leaf_lanes); }
  static __device__ __forceinline__ void tally(unsigned& trips,
                                               unsigned& lanes) {
    const unsigned m = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
      ++trips;
      lanes += __popc(m);
    }
  }
};

// What a counting build (rt_bounce_packed_count, rt_mega_count) writes:
// the walk's tallies summed over warps, u64[4] = visit trips, visit
// lanes, leaf trips, leaf lanes; and each block's first and last
// %globaltimer reading (ns), u64[2 * blocks].
struct CountOut {
  unsigned long long* tallies;
  unsigned long long* times;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every thread of the block reaches this.
template <class C>
__device__ __forceinline__ void count_out(const C& count, const CountOut& co,
                                          unsigned long long t0) {
  if constexpr (C::kOn) {
    const unsigned v[4] = {count.visit_trips, count.visit_lanes,
                           count.leaf_trips, count.leaf_lanes};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned sum = __reduce_add_sync(0xffffffffu, v[j]);
      if ((threadIdx.x & 31) == 0 && sum) {
        atomicAdd(&co.tallies[j], (unsigned long long)sum);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      co.times[2 * blockIdx.x] = t0;
      co.times[2 * blockIdx.x + 1] = globaltimer();
    }
  }
}

// One ray's walk: visit() one node, then test_leaves(), then pop() the
// next node, until the stack is empty. The stack is an array of its own
// beside the struct: a struct holding it would stay in local memory as a
// whole, its scalars too.
struct Walk {
  Ray r;
  float ivx, ivy, ivz;
  Hit h;
  int nid, sp;
  unsigned int leaves;  // hit leaf slots of node nid, not yet tested
};

__device__ __forceinline__ void walk_start(Walk& w, const Ray& r,
                                           float t_max) {
  w.r = r;
  w.h = {t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  w.ivx = 1.0f / r.dx;
  w.ivy = 1.0f / r.dy;
  w.ivz = 1.0f / r.dz;
  w.nid = 0;
  w.sp = 0;
  w.leaves = 0;
}

#define RT_CSWAP(i, j)                 \
  if (key[j] > key[i]) {               \
    const float tk = key[i];           \
    key[i] = key[j];                   \
    key[j] = tk;                       \
    const int tm = push[i];            \
    push[i] = push[j];                 \
    push[j] = tm;                      \
  }

// The push order of a visit: the comparator network on (key, push) pairs,
// descending key; its order decides equal keys.
__device__ __forceinline__ void sort_pushes(float (&key)[kWide],
                                            int (&push)[kWide]) {
#if RT_WIDE == 8
  RT_CSWAP(0, 1) RT_CSWAP(2, 3) RT_CSWAP(4, 5) RT_CSWAP(6, 7)
  RT_CSWAP(0, 2) RT_CSWAP(1, 3) RT_CSWAP(4, 6) RT_CSWAP(5, 7)
  RT_CSWAP(1, 2) RT_CSWAP(5, 6) RT_CSWAP(0, 4) RT_CSWAP(3, 7)
  RT_CSWAP(1, 5) RT_CSWAP(2, 6) RT_CSWAP(1, 4) RT_CSWAP(3, 6)
  RT_CSWAP(2, 4) RT_CSWAP(3, 5) RT_CSWAP(3, 4)
#else
  RT_CSWAP(0, 1) RT_CSWAP(2, 3) RT_CSWAP(4, 5) RT_CSWAP(6, 7)
  RT_CSWAP(8, 9) RT_CSWAP(10, 11) RT_CSWAP(12, 13) RT_CSWAP(14, 15)
  RT_CSWAP(0, 2) RT_CSWAP(1, 3) RT_CSWAP(4, 6) RT_CSWAP(5, 7)
  RT_CSWAP(8, 10) RT_CSWAP(9, 11) RT_CSWAP(12, 14) RT_CSWAP(13, 15)
  RT_CSWAP(1, 2) RT_CSWAP(5, 6) RT_CSWAP(9, 10) RT_CSWAP(13, 14)
  RT_CSWAP(0, 4) RT_CSWAP(1, 5) RT_CSWAP(2, 6) RT_CSWAP(3, 7)
  RT_CSWAP(8, 12) RT_CSWAP(9, 13) RT_CSWAP(10, 14) RT_CSWAP(11, 15)
  RT_CSWAP(2, 4) RT_CSWAP(3, 5) RT_CSWAP(10, 12) RT_CSWAP(11, 13)
  RT_CSWAP(1, 2) RT_CSWAP(3, 4) RT_CSWAP(5, 6) RT_CSWAP(9, 10)
  RT_CSWAP(11, 12) RT_CSWAP(13, 14) RT_CSWAP(0, 8) RT_CSWAP(1, 9)
  RT_CSWAP(2, 10) RT_CSWAP(3, 11) RT_CSWAP(4, 12) RT_CSWAP(5, 13)
  RT_CSWAP(6, 14) RT_CSWAP(7, 15) RT_CSWAP(4, 8) RT_CSWAP(5, 9)
  RT_CSWAP(6, 10) RT_CSWAP(7, 11) RT_CSWAP(2, 4) RT_CSWAP(3, 5)
  RT_CSWAP(6, 8) RT_CSWAP(7, 9) RT_CSWAP(10, 12) RT_CSWAP(11, 13)
  RT_CSWAP(1, 2) RT_CSWAP(3, 4) RT_CSWAP(5, 6) RT_CSWAP(7, 8)
  RT_CSWAP(9, 10) RT_CSWAP(11, 12) RT_CSWAP(13, 14)
#endif
}

// Visit node w.nid against the closest t so far: push its hit internal
// children far-first (kOrdered) or in slot order, and set w.leaves to its
// hit leaf slots.
//
// Each step does only the work that can change the result, in the order
// of the full test:
// - A visit reads each child as two 16-byte loads, (min xyz, max x) and
//   (max yz, meta, pad). An empty slot (meta 0, all-zero bounds) gets no
//   slab test and key +0: its own key would be (0 + 0) . d = +-0, which
//   compares equal to +0, and it is never hit.
// - The network sorts (key, push) pairs, push = the hit internal child's
//   meta or 0, and runs only when the ray pushes two children or more:
//   one push needs no order.
// - Without kOrdered (pallas_mega.py:264-266, the deep rounds of
//   RAYTPU_ORDER_MINW) there is no key and no network: the hit internal
//   children go on the stack in slot order, the highest slot on top. With
//   one fixed child order a ray's depth-first visits are the tile walk's
//   union order restricted to the nodes that ray hits (a child box lies
//   inside its parent's, so a ray that misses a node misses its whole
//   subtree), so the walk tests its leaves in the TPU's order, ties
//   included.
template <bool kOrdered = true>
__device__ __forceinline__ void visit(Walk& w, int* stack,
                                      const float* __restrict__ nodes4,
                                      float t_min) {
  const Ray& r = w.r;
  const float4* __restrict__ row =
      reinterpret_cast<const float4*>(nodes4) + (size_t)w.nid * (kWide * 4);
  const float closest = w.h.t;
  float key[kWide];
  int push[kWide];
  int npush = 0;
  unsigned int leaves = 0;
#pragma unroll
  for (int c = 0; c < kWide; ++c) {
    const float4 a = __ldg(row + 4 * c);
    const float4 b = __ldg(row + 4 * c + 1);
    const int meta = (int)b.z;
    key[c] = 0.0f;
    push[c] = 0;
    if (meta != 0) {
      const float lo0 = (a.x - r.ox) * w.ivx, hi0 = (a.w - r.ox) * w.ivx;
      const float lo1 = (a.y - r.oy) * w.ivy, hi1 = (b.x - r.oy) * w.ivy;
      const float lo2 = (a.z - r.oz) * w.ivz, hi2 = (b.y - r.oz) * w.ivz;
      const float t_en =
          max_nan(min_nan(lo0, hi0),
                  max_nan(min_nan(lo1, hi1), min_nan(lo2, hi2)));
      const float t_ex =
          min_nan(max_nan(lo0, hi0),
                  min_nan(max_nan(lo1, hi1), max_nan(lo2, hi2)));
      const bool hit = (t_ex > t_en) && (t_ex > t_min) && (t_en < closest);
      if constexpr (kOrdered) {
        key[c] = (a.x + a.w) * r.dx + (a.y + b.x) * r.dy + (a.z + b.y) * r.dz;
      }
      if (hit && meta > 0) {
        push[c] = meta;
        ++npush;
      }
      if (hit && meta < 0) leaves |= 1u << c;
    }
  }
  if (kOrdered && npush > 1) sort_pushes(key, push);
#pragma unroll
  for (int c = 0; c < kWide; ++c) {
    if (push[c]) stack[w.sp++] = push[c] - 1;
  }
  w.leaves = leaves;
}

// Test node w.nid's hit leaves, then clear them.
// - The hit leaves are a bit mask, taken lowest child first, so the lanes
//   of a warp test their k-th hit leaves together, whatever slots those
//   sit in (a loop over the kWide slots runs every slot any lane hits).
// - A leaf tests its count live triangles, where the JAX kernel tests
//   whole half-leaves (pallas_trace.py:476-487: the second half only when
//   count - 1 >= kClusterSize / 2). The records past the count are all
//   zero (the packers pad so), which no ray hits (det 0), so both give
//   the same result.
template <class C>
__device__ __forceinline__ void test_leaves(Walk& w,
                                            const float* __restrict__ nodes4,
                                            const float* __restrict__ clusters,
                                            float t_min, float det_eps,
                                            C& count) {
  while (w.leaves) {
    count.leaf();
    const int c = __ffs(w.leaves) - 1;
    w.leaves &= w.leaves - 1;
    const int lid =
        -(int)__ldg(nodes4 + (size_t)w.nid * kNodeFloats + 16 * c + 6) - 1;
    const int cid = lid & kLeafCidMask;
    mt_tris(clusters + (size_t)cid * kLeafFloats, 0,
            (lid >> kLeafCidBits) + 1, w.r, t_min, det_eps, cid, w.h);
  }
}

// The next node off the stack; false when the walk has ended.
__device__ __forceinline__ bool pop(Walk& w, const int* stack) {
  if (w.sp == 0) return false;
  w.nid = stack[--w.sp];
  return true;
}

// One step of the walk: a visit and its leaves, or with kPostpone visits
// until one hits a leaf, then its leaves (see walk()). False when the walk
// has ended.
template <bool kPostpone, bool kOrdered, class C>
__device__ __forceinline__ bool walk_step(Walk& w, int* stack,
                                          const float* __restrict__ nodes4,
                                          const float* __restrict__ clusters,
                                          float t_min, float det_eps,
                                          C& count) {
  if constexpr (kPostpone) {
    bool more = true;
    while (more && !w.leaves) {
      count.visit();
      visit<kOrdered>(w, stack, nodes4, t_min);
      if (!w.leaves) more = pop(w, stack);
    }
    if (!w.leaves) return false;
  } else {
    count.visit();
    visit<kOrdered>(w, stack, nodes4, t_min);
  }
  test_leaves(w, nodes4, clusters, t_min, det_eps, count);
  return pop(w, stack);
}

// Closest hit of one ray. Returns t = t_max and zeros on a miss.
//
// kPostpone: postponed leaves (the "while-while" loop of Aila and Laine,
// HPG 2009). A lane whose visit hits a leaf parks it and stops; the other
// lanes visit on until each has parked leaves or ended, then the warp
// tests its parked leaves together. A lane tests a visit's leaves before
// it visits again, so each ray keeps its own visit and test order, and
// its result is the same bit for bit.
// kOrdered: near-first pushes (the default), or slot order (see visit).
// count: the tallies of a counting build (LaneCount), or NoCount.
template <bool kPostpone, bool kOrdered = true, class C>
__device__ __forceinline__ Hit walk(const float* __restrict__ nodes4,
                                    const float* __restrict__ clusters,
                                    const Ray& r, float t_min, float t_max,
                                    float det_eps, bool flip, C& count) {
  Walk w;
  int stack[kStackCap];
  walk_start(w, r, t_max);
  while (walk_step<kPostpone, kOrdered>(w, stack, nodes4, clusters, t_min,
                                        det_eps, count)) {
  }
  if (flip) face_ray(r, w.h);
  return w.h;
}

template <bool kPostpone = false, bool kOrdered = true>
__device__ __forceinline__ Hit walk(const float* __restrict__ nodes4,
                                    const float* __restrict__ clusters,
                                    const Ray& r, float t_min, float t_max,
                                    float det_eps, bool flip) {
  NoCount count;
  return walk<kPostpone, kOrdered>(nodes4, clusters, r, t_min, t_max,
                                   det_eps, flip, count);
}

#undef RT_CSWAP

// Registers and local memory bytes a thread, static shared bytes a
// block, resident blocks per SM and threads a block, of `kernel` launched
// with `threads` threads a block -> out[0..4].
template <typename Kernel>
int kernel_attrs(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  out[4] = threads;
  return 0;
}

// Blocks of a persistent launch (the pmega call, the mega kernel): as
// many blocks of `threads` threads of `kernel` as stay resident on the
// card, from the occupancy calculator, asked once a kernel. Static: each
// source file of each layout's library keeps a table of its own (an
// inline function's table would be one for every library loaded).
static inline cudaError_t resident_blocks(const void* kernel, int threads,
                                          int* blocks) {
  constexpr int kKernels = 16;
  static std::mutex lock;
  static const void* kernels[kKernels] = {};
  static int resident[kKernels] = {};
  std::lock_guard<std::mutex> guard(lock);
  int k = 0;
  while (k < kKernels && kernels[k] && kernels[k] != kernel) ++k;
  if (k == kKernels) return cudaErrorInvalidValue;
  if (!kernels[k]) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (err != cudaSuccess) return err;
    resident[k] = sms * per_sm;
    kernels[k] = kernel;
  }
  *blocks = resident[k];
  return cudaSuccess;
}

}  // namespace rt

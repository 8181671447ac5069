// Per-ray closest-hit walk of the 8-wide BVH, shared by kernel A
// (trace4.cu) and kernel B (bounce12.cu); the triangle test and the
// normal flip are shared with the binary walk (trace2.cu) too.
//
// Tables (core/fast_types.py): nodes4 f32[R, 128], one wide node per row,
// 8 children x [min xyz, max xyz, meta, pad x9]; clusters f32[L, 128], one
// leaf per row, 8 triangles x [v0, e1, e2, albedo rgb, type, unit normal].
// meta > 0: internal child, wide id + 1; meta < 0: leaf,
// -((cid | (count - 1) << 20) + 1); meta == 0: empty slot.
//
// Semantics of raytracer_tpu/kernels/pallas_trace.py _trace4_kernel, per
// ray instead of per tile: 8 slab tests against the closest t at visit
// start, hit internal children pushed far-first by the 19-comparator
// network on (min + max) . d with the ray's own direction, leaf children in
// child order with Moller-Trumbore on the precomputed edges (det_eps,
// strict t < closest), the second half-cluster only when count > 4, and
// the winner's normal flipped against the ray at the end when asked (the
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
// more blocks (it spills) were not faster.
//
// Build with -fmad=false and without fast math: every product, sum,
// division and square root rounds as in the plain PyTorch version.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

// The walk's stack, in local memory: bvh/bvh4.py STACK_CAP. collapse4 and
// fast_scene_from_numpy refuse a tree whose walk could push more.
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

// Moller-Trumbore against triangles [k0, k1) of one cluster row, each
// record four 16-byte loads: (v0, e1.x), (e1.yz, e2.xy), (e2.z, albedo),
// and, for a win only, (type, normal).
__device__ __forceinline__ void mt_tris(const float* __restrict__ cr, int k0,
                                        int k1, const Ray& r, float t_min,
                                        float det_eps, int cid, Hit& h) {
  const float4* __restrict__ rec = reinterpret_cast<const float4*>(cr);
  for (int k = k0; k < k1; ++k) {
    const float4 p = __ldg(rec + 4 * k);
    const float4 q = __ldg(rec + 4 * k + 1);
    const float4 u = __ldg(rec + 4 * k + 2);
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
      const float4 w = __ldg(rec + 4 * k + 3);
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

#define RT_CSWAP(i, j)                 \
  if (key[j] > key[i]) {               \
    const float tk = key[i];           \
    key[i] = key[j];                   \
    key[j] = tk;                       \
    const int tm = push[i];            \
    push[i] = push[j];                 \
    push[j] = tm;                      \
  }

// Closest hit of one ray. Returns t = t_max and zeros on a miss.
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
// - The hit leaves are a bit mask, taken lowest child first, so the lanes
//   of a warp test their k-th hit leaves together, whatever slots those
//   sit in (a loop over the 8 slots runs every slot any lane hits).
// - A leaf tests its count live triangles. The slots past the count are
//   all zero (the packers pad so), which no ray hits (det 0), so this
//   keeps the result of testing whole half-clusters.
__device__ __forceinline__ Hit walk(const float* __restrict__ nodes4,
                                    const float* __restrict__ clusters,
                                    const Ray& r, float t_min, float t_max,
                                    float det_eps, bool flip) {
  Hit h = {t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  const float ivx = 1.0f / r.dx, ivy = 1.0f / r.dy, ivz = 1.0f / r.dz;
  int stack[kStackCap];
  int sp = 0;
  int nid = 0;
  while (true) {
    const float4* __restrict__ row =
        reinterpret_cast<const float4*>(nodes4) + (size_t)nid * 32;
    const float closest = h.t;
    float key[8];
    int push[8];
    int npush = 0;
    unsigned int leaves = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 a = __ldg(row + 4 * c);
      const float4 b = __ldg(row + 4 * c + 1);
      const int meta = (int)b.z;
      key[c] = 0.0f;
      push[c] = 0;
      if (meta != 0) {
        const float lo0 = (a.x - r.ox) * ivx, hi0 = (a.w - r.ox) * ivx;
        const float lo1 = (a.y - r.oy) * ivy, hi1 = (b.x - r.oy) * ivy;
        const float lo2 = (a.z - r.oz) * ivz, hi2 = (b.y - r.oz) * ivz;
        const float t_en =
            max_nan(min_nan(lo0, hi0),
                    max_nan(min_nan(lo1, hi1), min_nan(lo2, hi2)));
        const float t_ex =
            min_nan(max_nan(lo0, hi0),
                    min_nan(max_nan(lo1, hi1), max_nan(lo2, hi2)));
        const bool hit = (t_ex > t_en) && (t_ex > t_min) && (t_en < closest);
        key[c] = (a.x + a.w) * r.dx + (a.y + b.x) * r.dy + (a.z + b.y) * r.dz;
        if (hit && meta > 0) {
          push[c] = meta;
          ++npush;
        }
        if (hit && meta < 0) leaves |= 1u << c;
      }
    }
    if (npush > 1) {
      RT_CSWAP(0, 1) RT_CSWAP(2, 3) RT_CSWAP(4, 5) RT_CSWAP(6, 7)
      RT_CSWAP(0, 2) RT_CSWAP(1, 3) RT_CSWAP(4, 6) RT_CSWAP(5, 7)
      RT_CSWAP(1, 2) RT_CSWAP(5, 6) RT_CSWAP(0, 4) RT_CSWAP(3, 7)
      RT_CSWAP(1, 5) RT_CSWAP(2, 6) RT_CSWAP(1, 4) RT_CSWAP(3, 6)
      RT_CSWAP(2, 4) RT_CSWAP(3, 5) RT_CSWAP(3, 4)
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (push[c]) stack[sp++] = push[c] - 1;
    }
    while (leaves) {
      const int c = __ffs(leaves) - 1;
      leaves &= leaves - 1;
      const int lid = -(int)__ldg(nodes4 + (size_t)nid * 128 + 16 * c + 6) - 1;
      const int cid = lid & kLeafCidMask;
      mt_tris(clusters + (size_t)cid * 128, 0, (lid >> kLeafCidBits) + 1, r,
              t_min, det_eps, cid, h);
    }
    if (sp == 0) break;
    nid = stack[--sp];
  }
  if (flip) face_ray(r, h);
  return h;
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

}  // namespace rt

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
// Build with -fmad=false and without fast math: every product, sum,
// division and square root rounds as in the plain PyTorch version.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int kStackCap = 256;  // bvh/bvh4.py STACK_CAP
constexpr int kLeafCidBits = 20;
constexpr int kLeafCidMask = (1 << kLeafCidBits) - 1;

// min / max that return NaN when either input is NaN, like jnp.minimum and
// torch.minimum (fminf / fmaxf drop it). A ray parallel to an axis has an
// infinite inverse direction, and (bound - origin) * inf is NaN when the
// origin lies on the slab plane: the slab test must then fail for the ray,
// as in the JAX and plain versions.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

struct Hit {
  float t, nx, ny, nz, ar, ag, ab, mt;
  int cid;  // winner cluster id, 0 on a miss
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Moller-Trumbore against triangles [k0, k1) of one cluster row.
__device__ __forceinline__ void mt_tris(const float* __restrict__ cr, int k0,
                                        int k1, const Ray& r, float t_min,
                                        float det_eps, int cid, Hit& h) {
  for (int k = k0; k < k1; ++k) {
    const float* s = cr + 16 * k;
    const float v0x = __ldg(s + 0), v0y = __ldg(s + 1), v0z = __ldg(s + 2);
    const float e1x = __ldg(s + 3), e1y = __ldg(s + 4), e1z = __ldg(s + 5);
    const float e2x = __ldg(s + 6), e2y = __ldg(s + 7), e2z = __ldg(s + 8);
    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    bool ok = !((det > -det_eps) && (det < det_eps));
    const float invd = 1.0f / (ok ? det : 1.0f);
    const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
    const float u = invd * (sx * pvx + sy * pvy + sz * pvz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = invd * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float tt = invd * (e2x * qx + e2y * qy + e2z * qz);
    ok = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (tt > t_min) && (tt < h.t);
    if (ok) {
      h.t = tt;
      h.nx = __ldg(s + 13);
      h.ny = __ldg(s + 14);
      h.nz = __ldg(s + 15);
      h.ar = __ldg(s + 9);
      h.ag = __ldg(s + 10);
      h.ab = __ldg(s + 11);
      h.mt = __ldg(s + 12);
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
    const int tm = smeta[i];           \
    smeta[i] = smeta[j];               \
    smeta[j] = tm;                     \
    const bool tp = push[i];           \
    push[i] = push[j];                 \
    push[j] = tp;                      \
  }

// Closest hit of one ray. Returns t = t_max and zeros on a miss.
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
    const float* row = nodes4 + (size_t)nid * 128;
    const float closest = h.t;
    float key[8];
    int meta[8], smeta[8];
    bool hit[8], push[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float* g = row + 16 * c;
      const float g0 = __ldg(g + 0), g1 = __ldg(g + 1), g2 = __ldg(g + 2);
      const float g3 = __ldg(g + 3), g4 = __ldg(g + 4), g5 = __ldg(g + 5);
      meta[c] = (int)__ldg(g + 6);
      const float lo0 = (g0 - r.ox) * ivx, hi0 = (g3 - r.ox) * ivx;
      const float lo1 = (g1 - r.oy) * ivy, hi1 = (g4 - r.oy) * ivy;
      const float lo2 = (g2 - r.oz) * ivz, hi2 = (g5 - r.oz) * ivz;
      const float t_en =
          max_nan(min_nan(lo0, hi0),
                  max_nan(min_nan(lo1, hi1), min_nan(lo2, hi2)));
      const float t_ex =
          min_nan(max_nan(lo0, hi0),
                  min_nan(max_nan(lo1, hi1), max_nan(lo2, hi2)));
      hit[c] = (t_ex > t_en) && (t_ex > t_min) && (t_en < closest);
      key[c] = (g0 + g3) * r.dx + (g1 + g4) * r.dy + (g2 + g5) * r.dz;
      smeta[c] = meta[c];
      push[c] = hit[c] && meta[c] > 0;
    }
    RT_CSWAP(0, 1) RT_CSWAP(2, 3) RT_CSWAP(4, 5) RT_CSWAP(6, 7)
    RT_CSWAP(0, 2) RT_CSWAP(1, 3) RT_CSWAP(4, 6) RT_CSWAP(5, 7)
    RT_CSWAP(1, 2) RT_CSWAP(5, 6) RT_CSWAP(0, 4) RT_CSWAP(3, 7)
    RT_CSWAP(1, 5) RT_CSWAP(2, 6) RT_CSWAP(1, 4) RT_CSWAP(3, 6)
    RT_CSWAP(2, 4) RT_CSWAP(3, 5) RT_CSWAP(3, 4)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (push[c]) stack[sp++] = smeta[c] - 1;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (hit[c] && meta[c] < 0) {
        const int lid = -meta[c] - 1;
        const int cid = lid & kLeafCidMask;
        const float* cr = clusters + (size_t)cid * 128;
        mt_tris(cr, 0, 4, r, t_min, det_eps, cid, h);
        if ((lid >> kLeafCidBits) >= 4) mt_tris(cr, 4, 8, r, t_min, det_eps,
                                                cid, h);
      }
    }
    if (sp == 0) break;
    nid = stack[--sp];
  }
  if (flip) face_ray(r, h);
  return h;
}

#undef RT_CSWAP

}  // namespace rt

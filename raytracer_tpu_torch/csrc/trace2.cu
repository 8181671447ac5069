// Kernel 5: closest hit of flat SoA rays by the skip-link walk of the
// binary BVH.
//
// Replaces raytracer_tpu/kernels/pallas_trace.py _trace_kernel (via
// _trace_call and pallas_traverse under RAYTPU_TRAVERSE != bvh4 or
// RAYTPU_NODE_SRC=extract): bounce 0, the split rounds and the fixed-light
// tier on that knob. The TPU kernel walks one node pointer per 1024-ray
// tile through the union of its rays' paths; here each thread walks its
// own ray. The walk is stackless and in pre-order, the GLSL reference's own
// order: a hit internal node goes to its left child (-col7 - 1), anything
// else (a miss, or a leaf after its triangles) to its skip link. A child's
// box lies inside its parent's, so a ray that hits a child at some closest
// t also hits its parent: the per-ray walk tests the same leaves in the
// same order as the tile walk, and the closest hit and the winner on an
// equal-t tie are the same.
//
// Table (core/fast_types.py): nodes8 f32[M, 8], one node per row: box min
// xyz, max xyz, then two i32 columns stored as bits (read with
// __float_as_int, never as values): skip link, and col7 = cluster id >= 0
// for a leaf or -(left + 1) for an internal node. Rows >= num_nodes are
// padding; the walk ends when the node id reaches num_nodes (the empty
// scene has one all-miss node).
//
// What bounds it on an H100: dependent loads and divergence. A binary walk
// makes several times more visits than the 8-wide walk of trace4.cu (each
// a 32-byte row, the next id depending on the test), and a leaf reads a
// 512-byte cluster row. The flagship tables fit in the 50 MB L2. The design
// is the simplest right one: one thread per ray, no stack and no shared
// memory, read-only loads through the L1 (__ldg), rays in tile-major pixel
// order so a warp's primaries walk alike, blocks of 128 threads.
//
// Layout: rays f32[6, P] (origin xyz, direction xyz rows), active u8[P];
// out f32[8, P] = t, normal xyz, albedo rgb, material type (t = t_max and
// zeros on a miss or an inactive ray). flip != 0 turns the winner's normal
// to face the ray.
#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(128)
    trace2_kernel(const float* __restrict__ nodes8,
                  const float* __restrict__ clusters,
                  const float* __restrict__ rays,
                  const uint8_t* __restrict__ active, float* __restrict__ out,
                  int p, int num_nodes, float t_min, float t_max,
                  float det_eps, int flip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  rt::Hit h = {t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  if (active[i]) {
    const rt::Ray r = {rays[i],         rays[p + i],     rays[2 * p + i],
                       rays[3 * p + i], rays[4 * p + i], rays[5 * p + i]};
    const float ivx = 1.0f / r.dx, ivy = 1.0f / r.dy, ivz = 1.0f / r.dz;
    int node = 0;
    while (node < num_nodes) {
      const float* g = nodes8 + (size_t)node * 8;
      const float lo0 = (__ldg(g + 0) - r.ox) * ivx;
      const float hi0 = (__ldg(g + 3) - r.ox) * ivx;
      const float lo1 = (__ldg(g + 1) - r.oy) * ivy;
      const float hi1 = (__ldg(g + 4) - r.oy) * ivy;
      const float lo2 = (__ldg(g + 2) - r.oz) * ivz;
      const float hi2 = (__ldg(g + 5) - r.oz) * ivz;
      const float t_en =
          rt::max_nan(rt::min_nan(lo0, hi0),
                      rt::max_nan(rt::min_nan(lo1, hi1),
                                  rt::min_nan(lo2, hi2)));
      const float t_ex =
          rt::min_nan(rt::max_nan(lo0, hi0),
                      rt::min_nan(rt::max_nan(lo1, hi1),
                                  rt::max_nan(lo2, hi2)));
      const bool hit = (t_ex > t_en) && (t_ex > t_min) && (t_en < h.t);
      const int skip = __float_as_int(__ldg(g + 6));
      const int col7 = __float_as_int(__ldg(g + 7));
      if (hit && col7 >= 0) {
        rt::mt_tris(clusters + (size_t)col7 * 128, 0, 8, r, t_min, det_eps,
                    col7, h);
      }
      node = (hit && col7 < 0) ? -col7 - 1 : skip;
    }
    if (flip) rt::face_ray(r, h);
  }
  out[i] = h.t;
  out[p + i] = h.nx;
  out[2 * p + i] = h.ny;
  out[3 * p + i] = h.nz;
  out[4 * p + i] = h.ar;
  out[5 * p + i] = h.ag;
  out[6 * p + i] = h.ab;
  out[7 * p + i] = h.mt;
}

}  // namespace

extern "C" int rt_trace2(const void* nodes8, const void* clusters,
                         const void* rays, const void* active, void* out,
                         int p, int num_nodes, float t_min, float t_max,
                         float det_eps, int flip, void* stream) {
  if (p > 0) {
    const int threads = 128;
    const int blocks = (p + threads - 1) / threads;
    trace2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)nodes8, (const float*)clusters, (const float*)rays,
        (const uint8_t*)active, (float*)out, p, num_nodes, t_min, t_max,
        det_eps, flip);
  }
  return (int)cudaGetLastError();
}

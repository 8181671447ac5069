// Kernel 5: closest hit of flat SoA rays by the skip-link walk of the
// binary BVH, in two designs.
//
// Replaces raytracer_tpu/kernels/pallas_trace.py _trace_kernel (via
// _trace_call and pallas_traverse under RAYTPU_TRAVERSE != bvh4 or
// RAYTPU_NODE_SRC=extract): bounce 0, the split rounds and the fixed-light
// tier on that knob. The walk is stackless and in pre-order, the GLSL
// reference's own order: a hit internal node goes to its left child
// (-col7 - 1), anything else (a miss, or a leaf after its triangles) to
// its skip link. A child's box lies inside its parent's, and the slab
// terms are monotone in the bounds, so a ray that hits a child at some
// closest t also hits its parent: a walk of any union of rays' paths
// tests each ray's leaves in that ray's own order. That makes both
// designs, and the TPU kernel's tile walk, bit-equal to the per-ray walk,
// equal-t tie winners included.
//
// - trace2_ray_kernel (rt_trace2; the split rounds and the JAX XLA walk
//   ray_traverse_fast): one thread walks one ray, with postponed leaves
//   (walk2.cuh rt::walk2, shared with the mega kernel).
// - trace2_warp_kernel (rt_trace2_warp; bounce 0 and the fixed-light tier,
//   whose warps hold neighbouring primaries, and the JAX XLA group walk
//   packet_traverse of RAYTPU_B0=packet): one node id per warp, the
//   union walk of the TPU tile. A node is descended when any lane's ray
//   hits it, its row read once as a broadcast; at a leaf the warp stages
//   the leaf's kClusterSize records (512, 256 or 128 bytes, walk.cuh) in
//   shared memory with one coalesced load and every lane whose ray hit it
//   tests the live triangles from there.
//
// What bounds it on an H100 (PERF.md, flagship, 307,200 rays): issued
// instructions and divergence, not bytes (tables stay in the 50 MB L2).
// One thread per ray with a leaf test inside the walk loop ran ~20x its
// operation bound: a leaf's up to 8 Moller-Trumbore tests ran whenever
// any lane hit one, with the other lanes idle. Two 16-byte node loads cut
// the time by 3-4%, postponing leaves by a further 38% on primaries and
// 27% on a split round, testing only live triangles by 2-4% more. The
// union walk is 12% faster again on primaries but 57% slower on a split
// round, whose rays scatter in direction, so the caller picks the design.
// Prefetching a parked leaf into L1 or L2, and a register cap for 12
// blocks per SM, measured slower.
//
// Tables: walk2.cuh (the empty scene has one all-miss node).
//
// Layout: rays f32[6, P] (origin xyz, direction xyz rows), active u8[P];
// out f32[8, P] = t, normal xyz, albedo rgb, material type (t = t_max and
// zeros on a miss or an inactive ray). flip != 0 turns the winner's normal
// to face the ray.
#include "walk2.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLeafF4 = rt::kLeafFloats / 4;  // 16-byte parts of a leaf

struct Args {
  const float4* nodes;  // nodes8 rows as pairs of 16-byte parts
  const float* clusters;
  const int* counts;
  const float* rays;
  const uint8_t* active;
  float* out;
  int p, num_nodes, flip;
  float t_min, t_max, det_eps;
};

__device__ __forceinline__ rt::Ray load_ray(const Args& a, int i) {
  const float* r = a.rays;
  const int p = a.p;
  return {r[i],         r[p + i],     r[2 * p + i],
          r[3 * p + i], r[4 * p + i], r[5 * p + i]};
}

__device__ __forceinline__ void store_hit(const Args& a, int i,
                                          const rt::Hit& h) {
  float* o = a.out;
  const int p = a.p;
  o[i] = h.t;
  o[p + i] = h.nx;
  o[2 * p + i] = h.ny;
  o[3 * p + i] = h.nz;
  o[4 * p + i] = h.ar;
  o[5 * p + i] = h.ag;
  o[6 * p + i] = h.ab;
  o[7 * p + i] = h.mt;
}

__global__ void __launch_bounds__(kThreads) trace2_ray_kernel(Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.p) return;
  rt::Hit h = {a.t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  if (a.active[i]) {
    const rt::Ray r = load_ray(a, i);
    h = rt::walk2(a.nodes, a.clusters, a.counts, a.num_nodes, r, a.t_min,
                  a.t_max, a.det_eps);
    if (a.flip) rt::face_ray(r, h);
  }
  store_hit(a, i, h);
}

__global__ void __launch_bounds__(kThreads) trace2_warp_kernel(Args a) {
  __shared__ float4 stage[kThreads];  // one leaf per warp
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float4* row = stage + (threadIdx.x - lane);
  // Every lane of the warp takes part in the votes, rays or not.
  const bool act = i < a.p && a.active[i];
  rt::Hit h = {a.t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  rt::Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (act) r = load_ray(a, i);
  const float ivx = 1.0f / r.dx, ivy = 1.0f / r.dy, ivz = 1.0f / r.dz;
  int node = __any_sync(kFull, act) ? 0 : a.num_nodes;
  while (node < a.num_nodes) {
    const float4 lo = __ldg(a.nodes + 2 * node);
    const float4 hi = __ldg(a.nodes + 2 * node + 1);
    const bool hit =
        act && rt::slab_hit(lo, hi, r, ivx, ivy, ivz, a.t_min, h.t);
    const int col7 = __float_as_int(hi.w);
    const bool any = __any_sync(kFull, hit);
    if (col7 < 0) {
      node = any ? -col7 - 1 : __float_as_int(hi.z);
      continue;
    }
    if (any) {
      __syncwarp();
      if (lane < kLeafF4)
        row[lane] = __ldg(reinterpret_cast<const float4*>(a.clusters) +
                          (size_t)col7 * kLeafF4 + lane);
      __syncwarp();
      if (hit) {
        rt::mt_tris<false>(reinterpret_cast<const float*>(row), 0,
                           __ldg(a.counts + col7), r, a.t_min, a.det_eps,
                           col7, h);
      }
    }
    node = __float_as_int(hi.z);
  }
  if (i >= a.p) return;
  if (act && a.flip) rt::face_ray(r, h);
  store_hit(a, i, h);
}

template <typename Kernel>
int launch(Kernel kernel, const void* nodes8, const void* clusters,
           const void* counts, const void* rays, const void* active,
           void* out, int p, int num_nodes, float t_min, float t_max,
           float det_eps, int flip, void* stream) {
  if (p > 0) {
    const Args a = {(const float4*)nodes8, (const float*)clusters,
                    (const int*)counts,    (const float*)rays,
                    (const uint8_t*)active, (float*)out,
                    p,                     num_nodes,
                    flip,                  t_min,
                    t_max,                 det_eps};
    kernel<<<(p + kThreads - 1) / kThreads, kThreads, 0,
             (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_trace2(const void* nodes8, const void* clusters,
                         const void* counts, const void* rays,
                         const void* active, void* out, int p, int num_nodes,
                         float t_min, float t_max, float det_eps, int flip,
                         void* stream) {
  return launch(trace2_ray_kernel, nodes8, clusters, counts, rays, active,
                out, p, num_nodes, t_min, t_max, det_eps, flip, stream);
}

extern "C" int rt_trace2_warp(const void* nodes8, const void* clusters,
                              const void* counts, const void* rays,
                              const void* active, void* out, int p,
                              int num_nodes, float t_min, float t_max,
                              float det_eps, int flip, void* stream) {
  return launch(trace2_warp_kernel, nodes8, clusters, counts, rays, active,
                out, p, num_nodes, t_min, t_max, det_eps, flip, stream);
}

extern "C" int rt_trace2_attrs(int* out) {
  return rt::kernel_attrs(trace2_ray_kernel, kThreads, out);
}

extern "C" int rt_trace2_warp_attrs(int* out) {
  return rt::kernel_attrs(trace2_warp_kernel, kThreads, out);
}

// Kernel A: closest hit of flat SoA rays over the 8-wide BVH.
//
// Replaces raytracer_tpu/kernels/pallas_trace.py _trace4_kernel (via
// _trace4_call and pallas_traverse), the bounce-0 traversal of the main
// path. The TPU kernel walks one scalar node stack per 1024-ray tile with
// the tables resident in VMEM; this one gives every ray its own thread and
// its own stack (walk.cuh).
//
// What bounds it on an H100: dependent loads. Each visit reads a 512-byte
// node row, then 512-byte cluster rows for hit leaves, and the next node
// id depends on the result. The flagship tables (about 2 MB of nodes4 and
// 4 MB of clusters) stay in the 50 MB L2, so the loads are L2/L1 latency
// rather than HBM bandwidth, and warp divergence (lanes of a warp walking
// different paths) decides how many of them a warp waits on. The design
// answers this only simply for now: read-only loads through the L1
// (__ldg), rays in tile-major pixel order so a warp's primaries are
// coherent, the stack in thread-local memory (cached in L1), and small
// blocks (128 threads) for occupancy. Warp-coherent traversal, a
// shared-memory stack and persistent threads are later work.
//
// Layout: rays f32[6, P] (origin xyz, direction xyz rows), active u8[P];
// out f32[8, P] = t, normal xyz, albedo rgb, material type (t = t_max and
// zeros on a miss or an inactive ray). flip != 0 turns the winner's normal
// to face the ray (path shading); the fixed-light tier passes 0.
#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(128)
    trace4_kernel(const float* __restrict__ nodes4,
                  const float* __restrict__ clusters,
                  const float* __restrict__ rays,
                  const uint8_t* __restrict__ active, float* __restrict__ out,
                  int p, float t_min, float t_max, float det_eps,
                  int flip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  rt::Hit h = {t_max, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  if (active[i]) {
    const rt::Ray r = {rays[i],         rays[p + i],     rays[2 * p + i],
                       rays[3 * p + i], rays[4 * p + i], rays[5 * p + i]};
    h = rt::walk(nodes4, clusters, r, t_min, t_max, det_eps, flip != 0);
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

extern "C" int rt_trace4(const void* nodes4, const void* clusters,
                         const void* rays, const void* active, void* out,
                         int p, float t_min, float t_max, float det_eps,
                         int flip, void* stream) {
  if (p > 0) {
    const int threads = 128;
    const int blocks = (p + threads - 1) / threads;
    trace4_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)nodes4, (const float*)clusters, (const float*)rays,
        (const uint8_t*)active, (float*)out, p, t_min, t_max, det_eps,
        flip);
  }
  return (int)cudaGetLastError();
}

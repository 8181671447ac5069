// The mega kernel: every bounce of a ray in one thread, one launch a band.
//
// Replaces the JAX package's XLA megakernel,
// raytracer_tpu/kernels/packet.py megakernel_bounces (:281) and its
// _mega_level (:389), the fused per-ray loop that RAYTPU_BOUNCE=mega
// (from bounce 1, after kernel A), RAYTPU_B0=mega (from bounce 0) and
// RAYTPU_B0=packet (from bounce 1, after the group walk) run. It is no
// Pallas kernel there: an XLA while_loop over every ray of the band, whose
// step walks one node of the binary BVH per ray, shades the rays whose walk
// just ended and respawns the scattered ones into their next bounce.
//
// Each thread runs one ray to its end: the skip-link walk of nodes8
// (walk2.cuh, the same pre-order and leaf test as kernel 5), then the
// shade of kernels/tracer.py shade (sky on a miss, then scatter, emit,
// absorb), and it walks again while the ray scattered and bounce + 1 <
// max_bounces. Then it writes the ray's colour at its pixel id and adds
// its rays traced (1 for a live ray, and 1 for each respawn) into a
// counter, summed over the warp first, one atomic a warp.
//
// What the JAX loop does that changes no result, and the kernel does not
// do: its width levels (RAYTPU_COMPACT_FLOOR / RAYTPU_COMPACT_RATIO: live
// rays cumsum-compacted into a narrower loop, colours deposited at each
// level boundary) are a TPU schedule. A ray's path depends only on its own
// state, so the kernel runs every ray to its end in one launch (the JAX
// package's own test, tests/test_packet.py:231, shows the levels change
// no byte). What the kernel does to be bit-equal to that loop:
// - the draw is tracer.shade's (rng._to_unit_float): the direct u32 ->
//   f32 conversion, one rounding, not kernel B's two-step unit
//   (bounce12.cu unit_two_step);
// - the JAX loop selects the winner's normal, albedo and type with a
//   one-hot sum over the cluster's 8 slots, which turns a -0 of the record
//   into +0; the kernel adds +0 before the flip, as it does to the colour
//   it deposits (the JAX deposit adds into zeros);
// - a respawned ray resets its closest t and nothing else (JAX keeps the
//   stale hit state, which a shade reads only under a hit).
//
// What bounds it on an H100: the walk, as kernel 5's per-ray design
// (issued instructions and divergence; the tables stay in the 50 MB L2),
// plus a short integer-heavy shade per bounce. One thread a ray leaves a
// warp's lanes idle while its longest path runs (the lane occupancy in
// PERF.md). A faster design (a relaunch a level, persistent warps that
// refill idle lanes) is later work.
//
// Layout: state f32[12, P] (origin xyz, direction xyz, colour rgb, atten
// rgb rows), seed u32[P], alive u8[P], pix i32[P]; out f32[3, n_out],
// zero-filled by the caller: a ray with 0 <= pix < n_out writes its colour
// there (the pixel ids below n_out must be distinct), the rest are
// dropped; rays u64[1] += the rays traced.
//
// Build with -fmad=false and without fast math: every product, sum,
// division and square root rounds as in the plain PyTorch version.
#include "pcg.cuh"
#include "walk2.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRejectionRounds = 24;  // kernels/rng.py REJECTION_ROUNDS

struct Args {
  const float4* nodes;  // nodes8 rows as pairs of 16-byte parts
  const float* clusters;
  const int* counts;
  const float* state;
  const uint32_t* seed;
  const uint8_t* alive;
  const int* pix;
  float* out;
  unsigned long long* rays;
  int p, n_out, num_nodes, start_bounce, max_bounces, sky_on, emissive_emits;
  float fuzz, t_min, t_max, det_eps;
};

// rng._to_unit_float: float(u32) / float(0xFFFFFFFF), both rounded to
// nearest (the divisor rounds to 2^32).
__device__ __forceinline__ float unit(uint32_t s) {
  return __uint2float_rn(s) / 4294967295.0f;
}

struct Path {
  rt::Ray r;
  float cr, cg, cb;     // colour
  float atr, atg, atb;  // atten
  uint32_t seed;
};

// tracer.shade of one ray whose walk ended with h (normal facing the ray);
// true when the ray scattered.
__device__ __forceinline__ bool shade(Path& s, const rt::Hit& h,
                                      const Args& a) {
  const rt::Ray& r = s.r;
  const bool hit = h.t < a.t_max;
  // sky_color: normalize(d), t = 0.5 (y + 1).
  const float il =
      1.0f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  const float ndx = r.dx * il, ndy = r.dy * il, ndz = r.dz * il;
  const float ts = 0.5f * (ndy + 1.0f);
  const float omt = 1.0f - ts;
  if (!hit) {
    s.cr = s.atr * (a.sky_on ? omt + ts * 0.5f : 0.0f);
    s.cg = s.atg * (a.sky_on ? omt + ts * 0.7f : 0.0f);
    s.cb = s.atb * (a.sky_on ? omt + ts * 1.0f : 0.0f);
  }

  const float mt = h.mt;
  const bool is_lam = mt == 0.0f;
  const bool is_metal = (mt == 1.0f) || (mt == 2.0f);
  const bool is_emis = mt == 3.0f;
  const bool needs = hit && (is_lam || is_metal);
  // rng.random_vec3_in_unit_sphere: 3 discarded draws, then up to
  // kRejectionRounds rounds of 3 (an exhausted ray keeps (0, 0, 0)).
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (needs) {
    uint32_t seed = rt::pcg(rt::pcg(rt::pcg(s.seed)));
    for (int k = 0; k < kRejectionRounds; ++k) {
      seed = rt::pcg(seed);
      const float cx = unit(seed) * 2.0f - 1.0f;
      seed = rt::pcg(seed);
      const float cy = unit(seed) * 2.0f - 1.0f;
      seed = rt::pcg(seed);
      const float cz = unit(seed) * 2.0f - 1.0f;
      if (cx * cx + cy * cy + cz * cz < 1.0f) {
        px = cx;
        py = cy;
        pz = cz;
        break;
      }
    }
    s.seed = seed;
  }
  const float slen = sqrtf(px * px + py * py + pz * pz);
  const float isl = 1.0f / ((needs && slen > 0.0f) ? slen : 1.0f);
  float lamx = h.nx + px * isl, lamy = h.ny + py * isl,
        lamz = h.nz + pz * isl;
  if (sqrtf(lamx * lamx + lamy * lamy + lamz * lamz) < 1e-4f) {
    lamx = h.nx;
    lamy = h.ny;
    lamz = h.nz;
  }
  const float fz = mt == 2.0f ? a.fuzz : 0.0f;
  const float dn = ndx * h.nx + ndy * h.ny + ndz * h.nz;
  const float rawx = is_lam ? lamx : (ndx - 2.0f * dn * h.nx) + px * fz;
  const float rawy = is_lam ? lamy : (ndy - 2.0f * dn * h.ny) + py * fz;
  const float rawz = is_lam ? lamz : (ndz - 2.0f * dn * h.nz) + pz * fz;
  const float rl = sqrtf(rawx * rawx + rawy * rawy + rawz * rawz);
  const float irl = 1.0f / (rl > 0.0f ? rl : 1.0f);
  const float newx = rawx * irl, newy = rawy * irl, newz = rawz * irl;
  const bool met_ok = (newx * h.nx + newy * h.ny + newz * h.nz) > 0.0f;
  const bool scattered = hit && (is_lam || (is_metal && met_ok));

  const bool emits = a.emissive_emits && hit && is_emis;
  s.cr = s.cr + (emits ? h.ar : 0.0f) * s.atr;
  s.cg = s.cg + (emits ? h.ag : 0.0f) * s.atg;
  s.cb = s.cb + (emits ? h.ab : 0.0f) * s.atb;
  if (scattered) {
    s.atr = s.atr * h.ar;
    s.atg = s.atg * h.ag;
    s.atb = s.atb * h.ab;
    s.r = {r.ox + r.dx * h.t, r.oy + r.dy * h.t, r.oz + r.dz * h.t,
           newx, newy, newz};
  }
  return scattered;
}

__global__ void __launch_bounds__(kThreads) mega_kernel(Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int rays = 0;
  if (i < a.p) {
    const float* st = a.state + i;
    const int p = a.p;
    Path s;
    s.r = {st[0], st[p], st[2 * p], st[3 * p], st[4 * p], st[5 * p]};
    s.cr = st[6 * p];
    s.cg = st[7 * p];
    s.cb = st[8 * p];
    s.atr = st[9 * p];
    s.atg = st[10 * p];
    s.atb = st[11 * p];
    s.seed = a.seed[i];
    if (a.alive[i]) {
      int bounce = a.start_bounce;
      while (true) {
        ++rays;
        rt::Hit h = rt::walk2(a.nodes, a.clusters, a.counts, a.num_nodes,
                              s.r, a.t_min, a.t_max, a.det_eps);
        // The one-hot select's +0 (see the top), then the flip.
        h.nx = h.nx + 0.0f;
        h.ny = h.ny + 0.0f;
        h.nz = h.nz + 0.0f;
        h.ar = h.ar + 0.0f;
        h.ag = h.ag + 0.0f;
        h.ab = h.ab + 0.0f;
        h.mt = h.mt + 0.0f;
        rt::face_ray(s.r, h);
        const bool scattered = shade(s, h, a);
        ++bounce;
        if (!(scattered && bounce < a.max_bounces)) break;
      }
    }
    const int px = a.pix[i];
    if (px >= 0 && px < a.n_out) {
      a.out[px] = 0.0f + s.cr;
      a.out[a.n_out + px] = 0.0f + s.cg;
      a.out[2 * a.n_out + px] = 0.0f + s.cb;
    }
  }
  // Every lane of the warp reaches the sum (lanes past p add 0).
  const unsigned int wr = __reduce_add_sync(0xffffffffu, rays);
  if ((threadIdx.x & 31) == 0 && wr)
    atomicAdd(a.rays, (unsigned long long)wr);
}

}  // namespace

extern "C" int rt_mega(const void* nodes8, const void* clusters,
                       const void* counts, const void* state,
                       const void* seed, const void* alive, const void* pix,
                       void* out, void* rays, int p, int n_out, int num_nodes,
                       int start_bounce, int max_bounces, int sky_on,
                       int emissive_emits, float fuzz, float t_min,
                       float t_max, float det_eps, void* stream) {
  if (p > 0) {
    Args a;
    a.nodes = (const float4*)nodes8;
    a.clusters = (const float*)clusters;
    a.counts = (const int*)counts;
    a.state = (const float*)state;
    a.seed = (const uint32_t*)seed;
    a.alive = (const uint8_t*)alive;
    a.pix = (const int*)pix;
    a.out = (float*)out;
    a.rays = (unsigned long long*)rays;
    a.p = p;
    a.n_out = n_out;
    a.num_nodes = num_nodes;
    a.start_bounce = start_bounce;
    a.max_bounces = max_bounces;
    a.sky_on = sky_on;
    a.emissive_emits = emissive_emits;
    a.fuzz = fuzz;
    a.t_min = t_min;
    a.t_max = t_max;
    a.det_eps = det_eps;
    mega_kernel<<<(p + kThreads - 1) / kThreads, kThreads, 0,
                  (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_mega_attrs(int* out) {
  return rt::kernel_attrs(mega_kernel, kThreads, out);
}

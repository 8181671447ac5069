// The mega kernel: every bounce of a band's rays in one launch.
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
// A ray's path: the skip-link walk of nodes8 (walk2.cuh, the same
// pre-order and leaf test as kernel 5), then the shade of
// kernels/tracer.py shade (sky on a miss, then scatter, emit, absorb), and
// it walks again while the ray scattered and bounce + 1 < max_bounces.
// Then its colour goes to its pixel id, and its rays traced (1 for a live
// ray, and 1 for each respawn) into a counter, summed over the warp first,
// one atomic a warp.
//
// What the JAX loop does that changes no result, and the kernel does not
// do: its width levels (RAYTPU_COMPACT_FLOOR / RAYTPU_COMPACT_RATIO: live
// rays cumsum-compacted into a narrower loop, colours deposited at each
// level boundary) are a TPU schedule. A ray's path depends only on its own
// state, so the kernel runs every ray to its end in one launch (the JAX
// package's own test, tests/test_packet.py:231, shows the levels change
// no byte), and which lane runs which ray, and when, changes no byte
// either. What the kernel does to be bit-equal to that loop:
// - the draw is tracer.shade's (rng._to_unit_float): the direct u32 ->
//   f32 conversion, one rounding, not kernel B's two-step unit
//   (bounce12.cu unit_two_step);
// - the JAX loop selects the winner's normal, albedo and type with a
//   one-hot sum over the cluster's 8 slots, which turns a -0 of the record
//   into +0; the kernel adds +0 before the flip, at every walk's end, as it
//   does to the colour it deposits (the JAX deposit adds into zeros);
// - a respawned ray resets its closest t and nothing else (JAX keeps the
//   stale hit state, which a shade reads only under a hit).
//
// What bounds it on an H100 (PERF.md, the flagship's 720p bands): the
// latency of the walk, dependent 32-byte node loads with the tables in L1
// and the 50 MB L2, and the lanes of a warp that wait on each other. The
// visit loop runs at 0.27 SIMD efficiency under one thread a ray, and the
// longest paths (up to 10 serial walks) set a tail that no schedule
// shortens: once the rays run out, most of the call is those paths.
//
// The design: persistent warps that run one loop across bounces, with
// dynamic ray fetch (Aila and Laine, Understanding the Efficiency of Ray
// Traversal on GPUs, HPG 2009; JAX's own schedule, in which a ray whose
// walk ends is shaded and respawns in the same loop iteration). The
// launch holds as many blocks as stay resident; each warp starts on its
// own 32 consecutive rays. A trip of a warp's loop runs one walk2_step of
// each lane's walk (visit nodes until a leaf is parked or the walk ends,
// then test the parked leaf). A lane whose walk ended waits, then shades
// with the others and either starts its next bounce's walk at the root or
// writes its colour out: the shade runs once kShadeMin lanes have ended,
// or when no lane walks, or at once when the counter is empty (in the
// tail a wait only lengthens the longest paths). At the top of the next
// trip the warp refills its idle lanes with the next rays of its batch,
// 32 consecutive rays taken by one atomicAdd on a counter (dead rays are
// written out there and skipped). So a warp pays its lanes' longest total
// path, not the sum over bounces of its longest walk, and a shade's long
// integer work runs for half a warp, not for the few lanes whose walk
// ended in a trip. __launch_bounds__(kThreads, 8) keeps 8 blocks a SM
// (64 registers, 8 bytes of local memory; 68 and 7 blocks without it).
// Measured against one thread a ray on the flagship (PERF.md): 7% faster
// on the middle band from bounce 0, 5% from bounce 1, 18% on the top
// band, the bottom band within 1% (its tail of long paths is most of its
// call). Measured and not kept: shading at every walk's end (up to 5%
// slower on the bottom band), when 8 lanes have ended (2-4% slower
// there) or only when no lane walks (4% slower on the middle band); a
// trip of one node visit or one triangle test (visit SIMD efficiency 0.51
// against 0.31, but 35-75% slower); refilling only at the end of whole
// walks, or the step loop with one ray a thread (4-7% slower); caps of 10
// or 12 blocks a SM (48 / 40 registers, spills; 7-15% slower); the L1 at
// its largest (cudaFuncAttributePreferredSharedMemoryCarveout 0: no
// change).
//
// Layout: state f32[12, P] (origin xyz, direction xyz, colour rgb, atten
// rgb rows), seed u32[P], alive u8[P], pix i32[P]; out f32[3, n_out],
// zero-filled by the caller: a ray with 0 <= pix < n_out writes its colour
// there (the pixel ids below n_out must be distinct), the rest are
// dropped; rays u64[2] zero-filled by the caller: [0] += the rays traced,
// [1] is the ray counter.
//
// Build with -fmad=false and without fast math: every product, sum,
// division and square root rounds as in the plain PyTorch version.
#include "shade.cuh"
#include "walk2.cuh"

namespace {

using rt::Path;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kBatch = 32;  // rays a warp takes from the counter
constexpr int kShadeMin = 16;    // ended walks that shade together

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

// Ray i's colour to its pixel id (dropped outside [0, n_out)).
__device__ __forceinline__ void deposit(const Args& a, int i, float cr,
                                        float cg, float cb) {
  const int px = a.pix[i];
  if (px >= 0 && px < a.n_out) {
    a.out[px] = 0.0f + cr;
    a.out[a.n_out + px] = 0.0f + cg;
    a.out[2 * a.n_out + px] = 0.0f + cb;
  }
}

// Takes ray i: a dead ray's colour is written out at once (false); a live
// ray is loaded and its first walk started (true).
template <class W>
__device__ __forceinline__ bool begin(const Args& a, int i, Path& s, W& w,
                                      int& bounce, unsigned& rays) {
  const float* st = a.state + i;
  const int p = a.p;
  if (!a.alive[i]) {
    deposit(a, i, st[6 * p], st[7 * p], st[8 * p]);
    return false;
  }
  s.r = {st[0], st[p], st[2 * p], st[3 * p], st[4 * p], st[5 * p]};
  s.cr = st[6 * p];
  s.cg = st[7 * p];
  s.cb = st[8 * p];
  s.atr = st[9 * p];
  s.atg = st[10 * p];
  s.atb = st[11 * p];
  s.seed = a.seed[i];
  bounce = a.start_bounce;
  ++rays;
  rt::walk2_start(w, s.r, a.t_max);
  return true;
}

// The end of a walk: the one-hot select's +0 (see the top), the flip and
// the shade; true when the ray walks again (its next walk started).
template <class W>
__device__ __forceinline__ bool end_walk(const Args& a, Path& s, W& w,
                                         int& bounce, unsigned& rays) {
  rt::Hit h = w.h;
  h.nx = h.nx + 0.0f;
  h.ny = h.ny + 0.0f;
  h.nz = h.nz + 0.0f;
  h.ar = h.ar + 0.0f;
  h.ag = h.ag + 0.0f;
  h.ab = h.ab + 0.0f;
  h.mt = h.mt + 0.0f;
  rt::face_ray(s.r, h);
  const bool scattered =
      rt::shade(s, h, true, h.t < a.t_max,
                {a.sky_on, a.emissive_emits, a.fuzz});
  ++bounce;
  if (!(scattered && bounce < a.max_bounces)) return false;
  ++rays;
  rt::walk2_start(w, s.r, a.t_max);
  return true;
}

// kPersistent: the kernel's schedule (see the top). Else one ray a
// thread, as many blocks as rays need, walking a whole bounce a trip and
// shading at each walk's end: the schedule of the first design, run only
// by the counting build (rt_mega_count).
template <bool kPersistent, class C>
__global__ void __launch_bounds__(kThreads, 8)
    mega_kernel(Args a, rt::CountOut co) {
  const unsigned long long t0 = C::kOn ? rt::globaltimer() : 0ull;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const unsigned p = (unsigned)a.p;
  // The first gridDim.x * kThreads rays go one to a thread; the counter
  // hands out the rest.
  const unsigned first = gridDim.x * kThreads;
  C count;
  Path s;
  rt::Walk2 w;
  int bounce = 0;
  unsigned rays = 0;
  int i = blockIdx.x * kThreads + threadIdx.x;  // the lane's ray, or -1
  if (!(i < a.p && begin(a, i, s, w, bounce, rays))) i = -1;
  bool more = kPersistent && first < p;  // the counter may still hold rays
  unsigned next = 0, end = 0;  // the warp's batch: rays [next, end) left
  while (true) {
    unsigned idle = __ballot_sync(kFull, i < 0);
    while (more && idle) {
      if (next >= end) {
        unsigned long long base = 0;
        if ((threadIdx.x & 31) == 0)
          base = atomicAdd(a.rays + 1, (unsigned long long)kBatch);
        next = first + (unsigned)__shfl_sync(kFull, base, 0);
        end = next + kBatch;
        if (next >= p) more = false;
      }
      const unsigned j = next + __popc(idle & below);
      if (i < 0 && j < end && j < p && begin(a, j, s, w, bounce, rays))
        i = (int)j;
      next = min(next + __popc(idle), end);
      idle = __ballot_sync(kFull, i < 0);
    }
    if (idle == kFull) break;  // no ray left
    bool ended = false;
    if (i >= 0) {
      if constexpr (kPersistent) {
        rt::walk2_step(w, a.nodes, a.clusters, a.counts, a.num_nodes, s.r,
                       a.t_min, a.det_eps, count);
      } else {
        do {
          rt::walk2_step(w, a.nodes, a.clusters, a.counts, a.num_nodes, s.r,
                         a.t_min, a.det_eps, count);
        } while (w.node < a.num_nodes);
      }
      ended = w.node >= a.num_nodes;
    }
    if constexpr (kPersistent) {
      const unsigned em = __ballot_sync(kFull, ended);
      ended = ended &&
              (!more || __popc(em) >= kShadeMin || (idle | em) == kFull);
    }
    if (ended && !end_walk(a, s, w, bounce, rays)) {
      deposit(a, i, s.cr, s.cg, s.cb);
      i = -1;
    }
  }
  // Every lane of the warp reaches the sum.
  const unsigned int wr = __reduce_add_sync(kFull, rays);
  if ((threadIdx.x & 31) == 0 && wr)
    atomicAdd(a.rays, (unsigned long long)wr);
  rt::count_out(count, co, t0);
}

// One block a 128 rays; a persistent kernel at most as many as stay
// resident.
template <bool kPersistent, class C>
int launch(const Args& a, rt::CountOut co, void* stream) {
  const auto kernel = &mega_kernel<kPersistent, C>;
  int blocks = (a.p + kThreads - 1) / kThreads;
  if (kPersistent) {
    int resident = 0;
    const cudaError_t err =
        rt::resident_blocks((const void*)kernel, kThreads, &resident);
    if (err != cudaSuccess) return (int)err;
    if (resident < blocks) blocks = resident;
  }
  if (blocks > 0)
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, co);
  return (int)cudaGetLastError();
}

Args make_args(const void* nodes8, const void* clusters, const void* counts,
               const void* state, const void* seed, const void* alive,
               const void* pix, void* out, void* rays, int p, int n_out,
               int num_nodes, int start_bounce, int max_bounces, int sky_on,
               int emissive_emits, float fuzz, float t_min, float t_max,
               float det_eps) {
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
  return a;
}

}  // namespace

extern "C" int rt_mega(const void* nodes8, const void* clusters,
                       const void* counts, const void* state,
                       const void* seed, const void* alive, const void* pix,
                       void* out, void* rays, int p, int n_out, int num_nodes,
                       int start_bounce, int max_bounces, int sky_on,
                       int emissive_emits, float fuzz, float t_min,
                       float t_max, float det_eps, void* stream) {
  return launch<true, rt::NoCount>(
      make_args(nodes8, clusters, counts, state, seed, alive, pix, out, rays,
                p, n_out, num_nodes, start_bounce, max_bounces, sky_on,
                emissive_emits, fuzz, t_min, t_max, det_eps),
      rt::CountOut{nullptr, nullptr}, stream);
}

// The counting build: the same launch and outputs, plus the walk's
// tallies u64[4] and each block's timer readings u64[2 * blocks]
// (rt::CountOut), under the kernel's schedule (schedule 1) or one ray a
// thread walking a whole bounce at a time (schedule 0).
extern "C" int rt_mega_count(const void* nodes8, const void* clusters,
                             const void* counts, const void* state,
                             const void* seed, const void* alive,
                             const void* pix, void* out, void* rays,
                             void* tallies, void* times, int p, int n_out,
                             int num_nodes, int start_bounce,
                             int max_bounces, int sky_on, int emissive_emits,
                             float fuzz, float t_min, float t_max,
                             float det_eps, int schedule, void* stream) {
  const Args a = make_args(nodes8, clusters, counts, state, seed, alive, pix,
                           out, rays, p, n_out, num_nodes, start_bounce,
                           max_bounces, sky_on, emissive_emits, fuzz, t_min,
                           t_max, det_eps);
  const rt::CountOut co{(unsigned long long*)tallies,
                        (unsigned long long*)times};
  return schedule ? launch<true, rt::LaneCount>(a, co, stream)
                  : launch<false, rt::LaneCount>(a, co, stream);
}

extern "C" int rt_mega_attrs(int* out) {
  return rt::kernel_attrs(mega_kernel<true, rt::NoCount>, kThreads, out);
}

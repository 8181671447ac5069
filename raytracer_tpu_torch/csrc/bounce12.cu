// Kernel B and its two variants: fused walk + shade rounds.
//
// Replaces raytracer_tpu/kernels/pallas_mega.py _kernel_core in its three
// builds, through one device function templated on CarryColor:
//   rt_bounce12     make_kernel(carry_color=False) via
//                   bounce_megakernel12: the default fused12 rounds, where a
//                   dying ray's atten becomes its colour deposit;
//   rt_bounce15     make_kernel(carry_color=True) via bounce_megakernel: the
//                   colour rides in three rows of its own (RAYTPU_WAVE=fused
//                   rounds, the colour-carrying tail, and RAYTPU_BOUNCE=pmega,
//                   where one call runs the whole chain with bcap =
//                   max_bounces - 1);
//   rt_bounce_packed make_kernel_packed via bounce_megakernel_packed: the same
//                   colour-carrying core over the packed layout of
//                   RAYTPU_WAVE=fused_packed (a layout adapter).
// Each iteration is the kernel A walk (recording the winner cluster id),
// then the material model, then the per-ray budget; after up to bcap
// iterations the kernel writes the state, the rays/live counts and the
// next round's sort key.
//
// Builds (bounce.cuh), each entry point taking key_mode and ordered:
//   key_mode 0  cid: (dead << 30) | (winner cluster << 3) | octant, the
//               default (wavefront.py KEY_DEFAULT);
//   key_mode 1  pd5: origin and direction, 5 bits a channel, interleaved
//               (pallas_mega.py :557-571), against the root box;
//   key_mode 2  om9: 9-bit Morton code of the origin, then the direction
//               octant (:583-599), against the root box;
//   ordered 0   the walk pushes hit children in slot order, without the
//               near-first network (:244-266, RAYTPU_ORDER_MINW levels);
//               not for rt_bounce_packed, which the packed engine only
//               runs ordered.
// The root box is read on the card (bounds, the six floats of nodes8 row
// 0), so no build needs a host read. The TPU kernel runs one tile of 1024-2048
// rays per grid step and loops while any ray of the tile lives; here one
// thread runs one ray, so a thread whose ray dies stops at once (at
// bcap > 1 only the cid bits of the keys of rays that died earlier differ
// from the TPU's, which re-zeroes them while the tile runs on).
//
// What the colour carry changes (pallas_mega.py :426-431, :472-481,
// :537-546): a miss WRITES atten * sky into the colour, an emissive hit
// ADDS albedo * atten to it, atten is kept wherever the ray does not
// scatter, and a budget kill zeroes nothing (the colour is final). Without
// the carry (:483-504) the deposit replaces atten and a budget kill
// blacks it out.
//
// What bounds it on an H100: the walk (walk.cuh: issued instructions and
// divergence, not bytes) plus, per hit, a short integer-heavy shade (PCG
// draws of the bounded rejection sampler). At 0.25 ms for a sorted
// 307,200-ray bounce-1 round it runs at about 21x the least time the
// card needs to read and write its state, which is more than its live
// work's operations need (PERF.md). Rays arrive sorted by the carried key
// (winner cluster, then direction octant), so neighbouring threads tend
// to walk similar paths; one thread runs one ray, the state is read once
// and written once, and counts are reduced per warp before one atomic
// each. Blocks of 128 threads: about 66 registers give 7 resident blocks
// per SM; other block sizes and a register cap measured no faster.
//
// The pmega call (rt_bounce15 at bcap > 1, bounce15_pmega_kernel) runs
// persistent warps instead. With one ray per thread a warp runs until its
// longest path ends: on the flagship's middle band a ray runs 1.15
// iterations on average and up to 9, and only 45% of the lanes' iteration
// slots do work. Refilling idle lanes cut that call by 9%, not by the
// half the idle lanes suggest: after the first iteration the live rays
// (13% of them) are too few to fill the card, so each further iteration
// costs about one walk's latency (the call grows 0.25 -> 0.34 -> 0.37 ms
// from bcap 1 to 2 to 3), and a ray's iterations cannot overlap. The
// bcap-1 rounds keep one ray per thread (persistence does not pay there,
// see bounce_packed_kernel).
//
// RNG: PCG and the two-step u32 -> f32 conversion of pallas_mega._unit
// (i32 convert, then + 2^32 when negative: two roundings, unlike the
// direct conversion of kernels/rng.py used by bounce 0), bit for bit.
//
// Round state i32[13 or 16, w], one row per field (f32 as bits): origin
// 0-2, direction 3-5, [colour 6-8,] atten, then seed (u32 bits), alive
// (0/1), bounces-left budget and pixel id (passed through). Packed state:
// sf f32[13, w] = origin, direction, colour, atten, alive (0.0 / 1.0); si
// i32[k, w] = seed, then k - 1 rows passed through; the budget is the
// constant 1 << 30. Every build writes key i32[w] (dead flag at bit 30)
// and adds (rays, live) into counts u64[2].
#include "bounce.cuh"

namespace {

using rtb::Builds;
using rtb::CountOut;
using rtb::Key;
using rtb::kThreads;
using rtb::Params;

constexpr int kInvalidValue = 1;  // cudaErrorInvalidValue

Params make_params(const void* nodes4, const void* clusters,
                   const void* bounds, int w, int bcap, int sky_on,
                   float fuzz, int emissive_emits, float t_min, float t_max,
                   float det_eps) {
  return Params{(const float*)nodes4, (const float*)clusters,
                (const float*)bounds, w, bcap, sky_on, emissive_emits,
                fuzz, t_min, t_max, det_eps};
}

// The kernels of build (key_mode, ordered); false for an unknown key.
bool find_builds(int key_mode, int ordered, Builds* b) {
  static const Builds cid = rtb::make_builds<Key::kCid, true>();
  static const Builds cid_unordered = rtb::make_builds<Key::kCid, false>();
  switch (key_mode) {
    case 0: *b = ordered ? cid : cid_unordered; return true;
    case 1: *b = rtb::builds_pd5(ordered != 0); return true;
    case 2: *b = rtb::builds_om9(ordered != 0); return true;
  }
  return false;
}

int launch_round(rtb::RoundFn fn, const Params& q, const void* state_in,
                 void* state_out, void* key, void* counts, void* stream) {
  if (q.w > 0) {
    fn<<<(q.w + kThreads - 1) / kThreads, kThreads, 0,
         (cudaStream_t)stream>>>(q, (const int32_t*)state_in,
                                 (int32_t*)state_out, (int32_t*)key,
                                 (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}

template <class C>
int launch_packed(rtb::PackedFn fn, const Params& q, int si_rows,
                  const void* sf_in, const void* si_in, void* sf_out,
                  void* si_out, void* key, void* counts, CountOut co,
                  void* stream) {
  if (q.w > 0) {
    fn<<<(q.w + kThreads - 1) / kThreads, kThreads, 0,
         (cudaStream_t)stream>>>(q, si_rows, (const float*)sf_in,
                                 (const int32_t*)si_in, (float*)sf_out,
                                 (int32_t*)si_out, (int32_t*)key,
                                 (unsigned long long*)counts, co);
  }
  return (int)cudaGetLastError();
}

int attrs_of(rtb::RoundFn fn, int* out) {
  return rt::kernel_attrs(fn, kThreads, out);
}

Builds builds_or_none(int key_mode, int ordered) {
  Builds b{};
  find_builds(key_mode, ordered, &b);
  return b;
}

}  // namespace

extern "C" int rt_bounce12(const void* nodes4, const void* clusters,
                           const void* bounds, const void* state_in,
                           void* state_out, void* key, void* counts, int w,
                           int bcap, int sky_on, float fuzz,
                           int emissive_emits, float t_min, float t_max,
                           float det_eps, int key_mode, int ordered,
                           void* stream) {
  Builds b;
  if (!find_builds(key_mode, ordered, &b)) return kInvalidValue;
  return launch_round(b.b12,
                      make_params(nodes4, clusters, bounds, w, bcap, sky_on,
                                  fuzz, emissive_emits, t_min, t_max,
                                  det_eps),
                      state_in, state_out, key, counts, stream);
}

// bounce12 with the walk's postponed leaves: measured (kernel_times.py),
// not on any path; the cid key and the ordered walk only.
extern "C" int rt_bounce12_pl(const void* nodes4, const void* clusters,
                              const void* bounds, const void* state_in,
                              void* state_out, void* key, void* counts,
                              int w, int bcap, int sky_on, float fuzz,
                              int emissive_emits, float t_min, float t_max,
                              float det_eps, int key_mode, int ordered,
                              void* stream) {
  if (key_mode != 0 || !ordered) return kInvalidValue;
  return launch_round(&rtb::bounce_kernel<false, Key::kCid, true, true>,
                      make_params(nodes4, clusters, bounds, w, bcap, sky_on,
                                  fuzz, emissive_emits, t_min, t_max,
                                  det_eps),
                      state_in, state_out, key, counts, stream);
}

// The colour-carrying round; at bcap > 1 (the pmega call, multi-bounce
// rounds) the persistent warps of bounce15_pmega_kernel.
extern "C" int rt_bounce15(const void* nodes4, const void* clusters,
                           const void* bounds, const void* state_in,
                           void* state_out, void* key, void* counts, int w,
                           int bcap, int sky_on, float fuzz,
                           int emissive_emits, float t_min, float t_max,
                           float det_eps, int key_mode, int ordered,
                           void* stream) {
  Builds b;
  if (!find_builds(key_mode, ordered, &b)) return kInvalidValue;
  const Params q = make_params(nodes4, clusters, bounds, w, bcap, sky_on,
                               fuzz, emissive_emits, t_min, t_max, det_eps);
  if (w <= 0 || bcap <= 1) {
    return launch_round(b.b15, q, state_in, state_out, key, counts, stream);
  }
  int resident = 0;
  const cudaError_t err =
      rt::resident_blocks((const void*)b.pmega, kThreads, &resident);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (w + kThreads - 1) / kThreads;
  b.pmega<<<resident < blocks ? resident : blocks, kThreads, 0,
            (cudaStream_t)stream>>>(q, (const int32_t*)state_in,
                                    (int32_t*)state_out, (int32_t*)key,
                                    (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" int rt_bounce_packed(const void* nodes4, const void* clusters,
                                const void* bounds, const void* sf_in,
                                const void* si_in, void* sf_out,
                                void* si_out, void* key, void* counts, int w,
                                int si_rows, int bcap, int sky_on,
                                float fuzz, int emissive_emits, float t_min,
                                float t_max, float det_eps, int key_mode,
                                void* stream) {
  Builds b;
  if (!find_builds(key_mode, 1, &b)) return kInvalidValue;
  return launch_packed<rt::NoCount>(
      b.packed,
      make_params(nodes4, clusters, bounds, w, bcap, sky_on, fuzz,
                  emissive_emits, t_min, t_max, det_eps),
      si_rows, sf_in, si_in, sf_out, si_out, key, counts,
      CountOut{nullptr, nullptr}, stream);
}

// The counting build of the packed round (cid key): the same launch,
// outputs and counts, plus the walk's tallies u64[4] and each block's
// timer readings u64[2 * blocks] (see CountOut).
extern "C" int rt_bounce_packed_count(
    const void* nodes4, const void* clusters, const void* bounds,
    const void* sf_in, const void* si_in, void* sf_out, void* si_out,
    void* key, void* counts, void* tallies, void* times, int w, int si_rows,
    int bcap, int sky_on, float fuzz, int emissive_emits, float t_min,
    float t_max, float det_eps, void* stream) {
  return launch_packed<rt::LaneCount>(
      &rtb::bounce_packed_kernel<rt::LaneCount, Key::kCid>,
      make_params(nodes4, clusters, bounds, w, bcap, sky_on, fuzz,
                  emissive_emits, t_min, t_max, det_eps),
      si_rows, sf_in, si_in, sf_out, si_out, key, counts,
      CountOut{(unsigned long long*)tallies, (unsigned long long*)times},
      stream);
}

// Registers, local bytes, shared bytes, blocks per SM and threads of each
// build's kernels (kernels/cuda_build.py KERNELS).
extern "C" int rt_bounce12_attrs(int* out) {
  return attrs_of(builds_or_none(0, 1).b12, out);
}
extern "C" int rt_bounce12_pd5_attrs(int* out) {
  return attrs_of(builds_or_none(1, 1).b12, out);
}
extern "C" int rt_bounce12_om9_attrs(int* out) {
  return attrs_of(builds_or_none(2, 1).b12, out);
}
extern "C" int rt_bounce12_unordered_attrs(int* out) {
  return attrs_of(builds_or_none(0, 0).b12, out);
}
extern "C" int rt_bounce12_pd5_unordered_attrs(int* out) {
  return attrs_of(builds_or_none(1, 0).b12, out);
}
extern "C" int rt_bounce12_om9_unordered_attrs(int* out) {
  return attrs_of(builds_or_none(2, 0).b12, out);
}
extern "C" int rt_bounce12_pl_attrs(int* out) {
  return attrs_of(&rtb::bounce_kernel<false, Key::kCid, true, true>, out);
}
extern "C" int rt_bounce15_attrs(int* out) {
  return attrs_of(builds_or_none(0, 1).b15, out);
}
extern "C" int rt_bounce15_pd5_attrs(int* out) {
  return attrs_of(builds_or_none(1, 1).b15, out);
}
extern "C" int rt_bounce15_om9_attrs(int* out) {
  return attrs_of(builds_or_none(2, 1).b15, out);
}
extern "C" int rt_bounce15_unordered_attrs(int* out) {
  return attrs_of(builds_or_none(0, 0).b15, out);
}
extern "C" int rt_bounce15_pd5_unordered_attrs(int* out) {
  return attrs_of(builds_or_none(1, 0).b15, out);
}
extern "C" int rt_bounce15_om9_unordered_attrs(int* out) {
  return attrs_of(builds_or_none(2, 0).b15, out);
}
extern "C" int rt_bounce15_pmega_attrs(int* out) {
  return attrs_of(builds_or_none(0, 1).pmega, out);
}
extern "C" int rt_bounce_packed_attrs(int* out) {
  return rt::kernel_attrs(builds_or_none(0, 1).packed, kThreads, out);
}
extern "C" int rt_bounce_packed_pd5_attrs(int* out) {
  return rt::kernel_attrs(builds_or_none(1, 1).packed, kThreads, out);
}
extern "C" int rt_bounce_packed_om9_attrs(int* out) {
  return rt::kernel_attrs(builds_or_none(2, 1).packed, kThreads, out);
}

// Kernel B's device code, shared by the sources that instantiate its
// builds: bounce12.cu (the cid key, both walk orders, and the C entry
// points), bounce_pd5.cu and bounce_om9.cu (the pd5 and om9 keys). See
// bounce12.cu for what the kernels compute and the state layouts.
//
// A build is a (key, order) pair, both template parameters: a runtime
// switch would hold registers on the default build (cid, ordered: about 66
// registers, 7 resident 128-thread blocks per SM).
#pragma once

#include "pcg.cuh"
#include "walk.cuh"

namespace rtb {

constexpr int kRejectionRounds = 24;  // kernels/rng.py REJECTION_ROUNDS
constexpr int kThreads = 128;

using rt::pcg;

// pallas_mega._unit: u32 bits -> i32 -> f32, + 2^32 if negative, / 2^32.
__device__ __forceinline__ float unit_two_step(uint32_t seed) {
  const int32_t i = (int32_t)seed;
  float f = (float)i;
  if (i < 0) f = f + 4294967296.0f;
  return f / 4294967295.0f;
}

__device__ __forceinline__ float as_f(int32_t v) { return __int_as_float(v); }
__device__ __forceinline__ int32_t as_i(float v) { return __float_as_int(v); }

struct Params {
  const float* nodes4;
  const float* clusters;
  const float* bounds;  // the scene's root box: min xyz, max xyz (nodes8[0])
  int w, bcap, sky_on, emissive_emits;
  float fuzz, t_min, t_max, det_eps;
};

// The next round's sort key (pallas_mega.py :549-599, key_mode): the winner
// cluster (cid, the default), or a position code against the root box:
// pd5 (origin and direction, 5 bits a channel, interleaved) or om9 (9-bit
// Morton code of the origin, then the direction octant).
enum class Key : int { kCid = 0, kPd5 = 1, kOm9 = 2 };

// One ray's state through a round.
struct RayState {
  rt::Ray r;
  float cr, cg, cb;     // colour (CarryColor only)
  float atr, atg, atb;  // atten, or the deposit once dead (no carry)
  uint32_t seed;
  bool act;
  int bud;
  int cid;              // winner cluster of the last walk, 0 if none
  unsigned int rays;    // iterations entered alive
};

// Shade a live ray after its walk (pallas_mega._kernel_core shade()):
// h is the closest hit with the normal facing the ray.
template <bool CarryColor>
__device__ __forceinline__ void shade(RayState& s, const rt::Hit& h,
                                      const Params& q) {
  s.cid = h.cid;
  const rt::Ray& r = s.r;
  const bool hit = h.t < q.t_max;
  const bool miss = !hit;
  const float dlen = sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  const float idl = 1.0f / (dlen > 0.0f ? dlen : 1.0f);
  const float uy = r.dy * idl;
  const float tsky = 0.5f * (uy + 1.0f);
  const float omt = 1.0f - tsky;
  const float skr = q.sky_on ? omt + tsky * 0.5f : 0.0f;
  const float skg = q.sky_on ? omt + tsky * 0.7f : 0.0f;
  const float skb = q.sky_on ? omt + tsky * 1.0f : 0.0f;

  const float mt = h.mt;
  const bool is_lam = mt == 0.0f;
  const bool is_metal = (mt == 1.0f) || (mt == 2.0f);
  const bool is_emis = mt == 3.0f;
  const bool needs = hit && (is_lam || is_metal);
  float sphx = 0.0f, sphy = 0.0f, sphz = 0.0f;
  uint32_t seed = s.seed;
  if (needs) {
    // 3 discarded draws, then up to kRejectionRounds rounds of 3.
    seed = pcg(pcg(pcg(seed)));
    bool need = true;
    for (int k = 0; k < kRejectionRounds && need; ++k) {
      seed = pcg(seed);
      float cx = unit_two_step(seed);
      seed = pcg(seed);
      float cy = unit_two_step(seed);
      seed = pcg(seed);
      float cz = unit_two_step(seed);
      cx = cx * 2.0f - 1.0f;
      cy = cy * 2.0f - 1.0f;
      cz = cz * 2.0f - 1.0f;
      if ((cx * cx + cy * cy + cz * cz) < 1.0f) {
        sphx = cx;
        sphy = cy;
        sphz = cz;
        need = false;
      }
    }
  }
  s.seed = seed;
  const float slen = sqrtf(sphx * sphx + sphy * sphy + sphz * sphz);
  const float isl = 1.0f / ((needs && slen > 0.0f) ? slen : 1.0f);
  const float usx = sphx * isl, usy = sphy * isl, usz = sphz * isl;
  float lamx = h.nx + usx, lamy = h.ny + usy, lamz = h.nz + usz;
  const float laml = sqrtf(lamx * lamx + lamy * lamy + lamz * lamz);
  if (laml < 1e-4f) {
    lamx = h.nx;
    lamy = h.ny;
    lamz = h.nz;
  }
  const float fz = mt == 2.0f ? q.fuzz : 0.0f;
  const float ndx = r.dx * idl, ndy = r.dy * idl, ndz = r.dz * idl;
  const float dn = ndx * h.nx + ndy * h.ny + ndz * h.nz;
  const float refx = ndx - 2.0f * dn * h.nx;
  const float refy = ndy - 2.0f * dn * h.ny;
  const float refz = ndz - 2.0f * dn * h.nz;
  const float metx = refx + fz * sphx;
  const float mety = refy + fz * sphy;
  const float metz = refz + fz * sphz;
  const float rawx = is_lam ? lamx : metx;
  const float rawy = is_lam ? lamy : mety;
  const float rawz = is_lam ? lamz : metz;
  const float rl = sqrtf(rawx * rawx + rawy * rawy + rawz * rawz);
  const float irl = 1.0f / (rl > 0.0f ? rl : 1.0f);
  const float newx = rawx * irl, newy = rawy * irl, newz = rawz * irl;
  const bool met_ok = (newx * h.nx + newy * h.ny + newz * h.nz) > 0.0f;
  const bool scattered = hit && (is_lam || (is_metal && met_ok));
  const bool emits = q.emissive_emits && hit && is_emis;

  if (CarryColor) {
    if (miss) {
      s.cr = s.atr * skr;
      s.cg = s.atg * skg;
      s.cb = s.atb * skb;
    }
    if (emits) {
      s.cr = s.cr + h.ar * s.atr;
      s.cg = s.cg + h.ag * s.atg;
      s.cb = s.cb + h.ab * s.atb;
    }
    if (scattered) {
      s.atr = s.atr * h.ar;
      s.atg = s.atg * h.ag;
      s.atb = s.atb * h.ab;
    }
  } else {
    // No-colour carry: a dying ray's atten becomes its deposit.
    float dr = miss ? s.atr * skr : 0.0f;
    float dg = miss ? s.atg * skg : 0.0f;
    float db = miss ? s.atb * skb : 0.0f;
    if (emits) {
      dr = h.ar * s.atr;
      dg = h.ag * s.atg;
      db = h.ab * s.atb;
    }
    if (scattered) {
      s.atr = s.atr * h.ar;
      s.atg = s.atg * h.ag;
      s.atb = s.atb * h.ab;
    } else {
      s.atr = dr;
      s.atg = dg;
      s.atb = db;
    }
  }
  if (scattered) {
    const float hx = r.ox + r.dx * h.t;
    const float hy = r.oy + r.dy * h.t;
    const float hz = r.oz + r.dz * h.t;
    s.r = {hx, hy, hz, newx, newy, newz};
  }
  s.act = scattered;
  // Per-ray budget: every iteration entered alive costs 1; at 0 the ray
  // dies here (without the carry, killed to black).
  s.bud -= 1;
  if (!CarryColor && s.bud <= 0 && s.act) {
    s.atr = 0.0f;
    s.atg = 0.0f;
    s.atb = 0.0f;
  }
  if (!(s.bud > 0)) s.act = false;
}

// One walk + shade iteration of a live ray.
template <bool CarryColor, bool kOrdered, bool kPostpone = false>
__device__ __forceinline__ void iterate(RayState& s, const Params& q) {
  ++s.rays;
  const rt::Hit h = rt::walk<kPostpone, kOrdered>(
      q.nodes4, q.clusters, s.r, q.t_min, q.t_max, q.det_eps, true);
  shade<CarryColor>(s, h, q);
}

// Up to bcap walk + shade iterations while the ray lives.
template <bool CarryColor, bool kOrdered, bool kPostpone = false>
__device__ __forceinline__ void run_ray(RayState& s, const Params& q) {
  for (int b = 0; b < q.bcap && s.act; ++b) {
    iterate<CarryColor, kOrdered, kPostpone>(s, q);
  }
}

// jnp.clip(x, 0, hi).astype(int32): fmaxf and fminf take NaN to 0, which
// is what XLA's conversion gives a NaN; +-inf clip to hi and 0.
__device__ __forceinline__ int clip_trunc(float x, float hi) {
  return (int)fminf(fmaxf(x, 0.0f), hi);
}

// The channel of origin axis ax against the root box, on [0, hi]: IEEE
// division, then the product (no contraction: -fmad=false).
__device__ __forceinline__ int box_channel(float o, int ax, float hi,
                                           const float* __restrict__ bounds) {
  const float lo = __ldg(bounds + ax);
  const float span = fmaxf(__ldg(bounds + 3 + ax) - lo, 1e-6f);
  return clip_trunc((o - lo) / span * hi, hi);
}

// wavefront._part1by2: the low 10 bits of v spread to every third bit.
__device__ __forceinline__ int part1by2(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// The round key of the advanced state: (dead << 30) | code.
template <Key K>
__device__ __forceinline__ int32_t round_key(
    const RayState& s, const float* __restrict__ bounds) {
  const int dead = (s.act ? 0 : 1) << 30;
  const int octant = (s.r.dx > 0.0f ? 1 : 0) | (s.r.dy > 0.0f ? 2 : 0) |
                     (s.r.dz > 0.0f ? 4 : 0);
  const float o[3] = {s.r.ox, s.r.oy, s.r.oz};
  if constexpr (K == Key::kCid) {
    return dead | (s.cid << 3) | octant;
  } else if constexpr (K == Key::kPd5) {
    const float d[3] = {s.r.dx, s.r.dy, s.r.dz};
    int ch[6];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      ch[ax] = box_channel(o[ax], ax, 31.0f, bounds);
      ch[3 + ax] = clip_trunc((d[ax] + 1.0f) * 15.5f, 31.0f);
    }
    int key = dead;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
#pragma unroll
      for (int c = 0; c < 6; ++c) key |= ((ch[c] >> b) & 1) << (6 * b + c);
    }
    return key;
  } else {
    int morton = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      morton |= part1by2(box_channel(o[ax], ax, 511.0f, bounds)) << ax;
    }
    morton &= (1 << 27) - 1;
    return dead | (morton << 3) | octant;
  }
}

// Warp sums of (rays, live), one atomic each. Every thread of the block
// reaches this (invalid lanes add 0).
__device__ __forceinline__ void add_counts(unsigned long long* counts,
                                           unsigned int rays,
                                           unsigned int live) {
  const unsigned int wr = __reduce_add_sync(0xffffffffu, rays);
  const unsigned int wl = __reduce_add_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0) {
    if (wr) atomicAdd(&counts[0], (unsigned long long)wr);
    if (wl) atomicAdd(&counts[1], (unsigned long long)wl);
  }
}

// Round state i32[13 | 16, w]: the float rows, then seed, alive, budget,
// pixel id. Ray i's fields in, with no walk yet (cid 0).
template <bool CarryColor>
__device__ __forceinline__ void load_ray(RayState& s,
                                         const int32_t* __restrict__ st_in,
                                         int i, int w) {
  constexpr int kA = CarryColor ? 9 : 6;  // first atten row
  constexpr int kSeed = kA + 3;
  const int32_t* in = st_in + i;
  s.r = {as_f(in[0]),     as_f(in[w]),     as_f(in[2 * w]),
         as_f(in[3 * w]), as_f(in[4 * w]), as_f(in[5 * w])};
  s.cr = s.cg = s.cb = 0.0f;
  if (CarryColor) {
    s.cr = as_f(in[6 * w]);
    s.cg = as_f(in[7 * w]);
    s.cb = as_f(in[8 * w]);
  }
  s.atr = as_f(in[kA * w]);
  s.atg = as_f(in[(kA + 1) * w]);
  s.atb = as_f(in[(kA + 2) * w]);
  s.seed = (uint32_t)in[kSeed * w];
  s.act = in[(kSeed + 1) * w] != 0;
  s.bud = in[(kSeed + 2) * w];
  s.cid = 0;
}

// Ray i's state out (the pixel id passed through) and its key.
template <bool CarryColor, Key K>
__device__ __forceinline__ void store_ray(const RayState& s,
                                          const int32_t* __restrict__ st_in,
                                          int32_t* __restrict__ st_out,
                                          int32_t* __restrict__ key_out,
                                          int i, int w,
                                          const float* __restrict__ bounds) {
  constexpr int kA = CarryColor ? 9 : 6;
  constexpr int kSeed = kA + 3;
  int32_t* out = st_out + i;
  out[0] = as_i(s.r.ox);
  out[w] = as_i(s.r.oy);
  out[2 * w] = as_i(s.r.oz);
  out[3 * w] = as_i(s.r.dx);
  out[4 * w] = as_i(s.r.dy);
  out[5 * w] = as_i(s.r.dz);
  if (CarryColor) {
    out[6 * w] = as_i(s.cr);
    out[7 * w] = as_i(s.cg);
    out[8 * w] = as_i(s.cb);
  }
  out[kA * w] = as_i(s.atr);
  out[(kA + 1) * w] = as_i(s.atg);
  out[(kA + 2) * w] = as_i(s.atb);
  out[kSeed * w] = (int32_t)s.seed;
  out[(kSeed + 1) * w] = s.act ? 1 : 0;
  out[(kSeed + 2) * w] = s.bud;
  out[(kSeed + 3) * w] = st_in[(kSeed + 3) * w + i];
  key_out[i] = round_key<K>(s, bounds);
}

// One thread runs one ray through up to bcap iterations. kPostpone (the
// walk's postponed leaves) is measured on bounce12 only (rt_bounce12_pl).
template <bool CarryColor, Key K, bool kOrdered, bool kPostpone = false>
__global__ void __launch_bounds__(kThreads)
    bounce_kernel(Params q, const int32_t* __restrict__ st_in,
                  int32_t* __restrict__ st_out, int32_t* __restrict__ key_out,
                  unsigned long long* __restrict__ counts) {
  const int w = q.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  RayState s;
  s.act = false;
  s.rays = 0;
  if (i < w) {
    load_ray<CarryColor>(s, st_in, i, w);
    run_ray<CarryColor, kOrdered, kPostpone>(s, q);
    store_ray<CarryColor, K>(s, st_in, st_out, key_out, i, w, q.bounds);
  }
  add_counts(counts, s.rays, s.act ? 1u : 0u);
}

// The pmega call (bcap > 1) of the colour-carrying build: persistent
// warps with dynamic ray fetch (Aila and Laine 2009). Each warp starts on
// its own 32 consecutive rays, as one ray per thread would, and runs one
// iteration at a time on each lane's ray; a lane whose ray ends (dead, or
// bcap iterations) writes it out, and before the next iteration the warp
// refills its idle lanes with the next rays of its batch, kBatch
// consecutive rays taken from the counter counts[2] by one atomicAdd.
// Each ray runs the same iterations from its own state as in
// bounce_kernel, so state, key and counts are the same bit for bit.
// Measured on the flagship's three bands (PERF.md): an atomic for every
// refill, or the first rays taken from the counter too, made the bands
// with few live rays slower than one ray per thread (their time is their
// longest path's latency, which counter traffic lengthens); batches of
// 64 or 128 rays serialise a warp's last batch.
constexpr unsigned kBatch = 32;

template <Key K, bool kOrdered>
__global__ void __launch_bounds__(kThreads)
    bounce15_pmega_kernel(Params q, const int32_t* __restrict__ st_in,
                          int32_t* __restrict__ st_out,
                          int32_t* __restrict__ key_out,
                          unsigned long long* __restrict__ counts) {
  constexpr unsigned kFull = 0xffffffffu;
  const unsigned w = (unsigned)q.w;
  // The first gridDim.x * kThreads rays go one to a thread; the counter
  // hands out the rest.
  const unsigned first = gridDim.x * kThreads;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  RayState s;
  s.act = false;
  s.rays = 0;               // iterations of all this lane's rays
  unsigned int live = 0;    // of its rays, those alive at the end
  int i = blockIdx.x * kThreads + threadIdx.x;  // the lane's ray, or -1
  int b = 0;                // iterations run on it
  bool more = first < w;    // the counter may still hold rays
  unsigned next = 0, end = 0;  // the warp's batch: rays [next, end) left
  if (i < q.w) {
    load_ray<true>(s, st_in, i, q.w);
  } else {
    i = -1;
  }
  while (true) {
    unsigned idle = __ballot_sync(kFull, i < 0);
    if (more && idle) {
      if (next >= end) {
        unsigned long long base = 0;
        if ((threadIdx.x & 31) == 0) {
          base = atomicAdd(&counts[2], (unsigned long long)kBatch);
        }
        next = first + (unsigned)__shfl_sync(kFull, base, 0);
        end = next + kBatch;
        if (next >= w) more = false;
      }
      const unsigned j = next + __popc(idle & below);
      if (i < 0 && j < end && j < w) {
        i = (int)j;
        b = 0;
        load_ray<true>(s, st_in, i, q.w);
      }
      next = min(next + __popc(idle), end);
      idle = __ballot_sync(kFull, i < 0);
    }
    if (idle == kFull) break;   // no ray left
    if (i >= 0) {
      if (s.act && b < q.bcap) {
        iterate<true, kOrdered>(s, q);
        ++b;
      }
      if (!(s.act && b < q.bcap)) {
        store_ray<true, K>(s, st_in, st_out, key_out, i, q.w, q.bounds);
        live += s.act ? 1u : 0u;
        i = -1;
      }
    }
  }
  add_counts(counts, s.rays, live);
}

using rt::count_out;
using rt::CountOut;
using rt::globaltimer;

// Packed state: sf f32[13, w], si i32[si_rows, w] (seed, then rows passed
// through); the budget is the constant 1 << 30.
// The packed round (RAYTPU_WAVE=fused_packed, bcap 1 on the path): one
// thread runs one ray, as bounce_kernel does.
//
// Measured against it on the flagship's rounds (PERF.md; NVIDIA H100
// 80GB HBM3, 700.00 W): on the middle band (300,882 live rays) one ray per
// thread makes 148,607 warp trips through the walk's visit loop at a SIMD
// efficiency of 0.44 and 108,793 through its leaf loop at 0.155, and
// leaves block slots idle for the last third of the launch. Postponed
// leaves (walk<true>) cut leaf trips by a third but added 43% of visit
// trips (+6%). Persistent warps that refill lanes in mid-walk from 32-ray
// batches (91 registers, 5 blocks per SM) cut visit trips by 39% but not
// leaf trips (+6%); with postponed leaves too they cut leaf trips by 54%
// and the middle band's round by 4-8%, the top band's by 3%, but made the
// bottom band's 10-13% slower (refilling at 8, 16 or 32 waiting lanes),
// and the frame runs the middle and the bottom band's rounds: no gain.
template <class C, Key K>
__global__ void __launch_bounds__(kThreads)
    bounce_packed_kernel(Params q, int si_rows,
                         const float* __restrict__ sf_in,
                         const int32_t* __restrict__ si_in,
                         float* __restrict__ sf_out,
                         int32_t* __restrict__ si_out,
                         int32_t* __restrict__ key_out,
                         unsigned long long* __restrict__ counts,
                         CountOut co) {
  const unsigned long long t0 = C::kOn ? globaltimer() : 0ull;
  const int w = q.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  C count;
  RayState s;
  s.act = false;
  s.rays = 0;
  if (i < w) {
    const float* f = sf_in + i;
    s.r = {f[0], f[w], f[2 * w], f[3 * w], f[4 * w], f[5 * w]};
    s.cr = f[6 * w];
    s.cg = f[7 * w];
    s.cb = f[8 * w];
    s.atr = f[9 * w];
    s.atg = f[10 * w];
    s.atb = f[11 * w];
    s.act = f[12 * w] > 0.5f;
    s.seed = (uint32_t)si_in[i];
    s.bud = 1 << 30;
    s.cid = 0;
    for (int b = 0; b < q.bcap && s.act; ++b) {
      ++s.rays;
      const rt::Hit h = rt::walk<false>(q.nodes4, q.clusters, s.r, q.t_min,
                                        q.t_max, q.det_eps, true, count);
      shade<true>(s, h, q);
    }
    float* o = sf_out + i;
    o[0] = s.r.ox;
    o[w] = s.r.oy;
    o[2 * w] = s.r.oz;
    o[3 * w] = s.r.dx;
    o[4 * w] = s.r.dy;
    o[5 * w] = s.r.dz;
    o[6 * w] = s.cr;
    o[7 * w] = s.cg;
    o[8 * w] = s.cb;
    o[9 * w] = s.atr;
    o[10 * w] = s.atg;
    o[11 * w] = s.atb;
    o[12 * w] = s.act ? 1.0f : 0.0f;
    si_out[i] = (int32_t)s.seed;
    for (int k = 1; k < si_rows; ++k) si_out[k * w + i] = si_in[k * w + i];
    key_out[i] = round_key<K>(s, q.bounds);
  }
  add_counts(counts, s.rays, s.act ? 1u : 0u);
  count_out(count, co, t0);
}

// The kernels of one (key, order) build, as launched by the C entry points
// of bounce12.cu: the one-ray-per-thread round without and with the colour
// carry, the pmega call's persistent warps, and the packed round (ordered
// builds only: the packed engine never runs an unordered level).
using RoundFn = void (*)(Params, const int32_t*, int32_t*, int32_t*,
                         unsigned long long*);
using PackedFn = void (*)(Params, int, const float*, const int32_t*, float*,
                          int32_t*, int32_t*, unsigned long long*, CountOut);

struct Builds {
  RoundFn b12, b15, pmega;
  PackedFn packed;
};

// Instantiate a build's kernels. Each build is instantiated in one source
// only (bounce12.cu: cid; bounce_pd5.cu; bounce_om9.cu), so the sources
// compile in parallel and no kernel is registered twice.
template <Key K, bool kOrdered>
Builds make_builds() {
  Builds b{&bounce_kernel<false, K, kOrdered>,
           &bounce_kernel<true, K, kOrdered>,
           &bounce15_pmega_kernel<K, kOrdered>, nullptr};
  if constexpr (kOrdered) b.packed = &bounce_packed_kernel<rt::NoCount, K>;
  return b;
}

Builds builds_pd5(bool ordered);
Builds builds_om9(bool ordered);

}  // namespace rtb

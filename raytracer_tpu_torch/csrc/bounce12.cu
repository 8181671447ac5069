// Kernel B and its two variants: fused walk + shade rounds.
//
// Replaces raytracer_tpu/kernels/pallas_mega.py _kernel_core in its three
// builds, through one device function templated on CarryColor:
//   rt_bounce12     make_kernel(carry_color=False, key_mode="cid") via
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
// next round's cid sort key. The TPU kernel runs one tile of 1024-2048
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
// per SM; other block sizes and a register cap measured no faster. In
// the pmega call (bcap 9) a warp runs until its longest path ends;
// compaction inside the call is later work.
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
// constant 1 << 30. Every build writes key i32[w] = (dead << 30) |
// (cid << 3) | octant and adds (rays, live) into counts u64[2].
#include "walk.cuh"

namespace {

constexpr int kRejectionRounds = 24;  // kernels/rng.py REJECTION_ROUNDS
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pcg(uint32_t v) {
  const uint32_t state = v * 747796405u + 2891336453u;
  const uint32_t word =
      ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

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
  int w, bcap, sky_on, emissive_emits;
  float fuzz, t_min, t_max, det_eps;
};

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

// Up to bcap walk + shade iterations while the ray lives.
template <bool CarryColor>
__device__ __forceinline__ void run_ray(RayState& s, const Params& q) {
  for (int b = 0; b < q.bcap && s.act; ++b) {
    ++s.rays;
    const rt::Hit h =
        rt::walk(q.nodes4, q.clusters, s.r, q.t_min, q.t_max, q.det_eps,
                 true);
    s.cid = h.cid;
    // Shade (pallas_mega._kernel_core shade(); the ray is alive here).
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
}

__device__ __forceinline__ int32_t cid_key(const RayState& s) {
  const int octant = (s.r.dx > 0.0f ? 1 : 0) | (s.r.dy > 0.0f ? 2 : 0) |
                     (s.r.dz > 0.0f ? 4 : 0);
  return ((s.act ? 0 : 1) << 30) | (s.cid << 3) | octant;
}

// Warp sums of (rays, live), one atomic each. Every thread of the block
// reaches this (invalid lanes add 0).
__device__ __forceinline__ void add_counts(unsigned long long* counts,
                                           unsigned int rays, bool live) {
  const unsigned int wr = __reduce_add_sync(0xffffffffu, rays);
  const unsigned int wl = __reduce_add_sync(0xffffffffu, live ? 1u : 0u);
  if ((threadIdx.x & 31) == 0) {
    if (wr) atomicAdd(&counts[0], (unsigned long long)wr);
    if (wl) atomicAdd(&counts[1], (unsigned long long)wl);
  }
}

// Round state i32[13 | 16, w]: the float rows, then seed, alive, budget,
// pixel id.
template <bool CarryColor>
__global__ void __launch_bounds__(kThreads)
    bounce_kernel(Params q, const int32_t* __restrict__ st_in,
                  int32_t* __restrict__ st_out, int32_t* __restrict__ key_out,
                  unsigned long long* __restrict__ counts) {
  constexpr int kA = CarryColor ? 9 : 6;  // first atten row
  constexpr int kSeed = kA + 3;
  const int w = q.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  RayState s;
  s.act = false;
  s.rays = 0;
  if (i < w) {
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
    run_ray<CarryColor>(s, q);
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
    out[(kSeed + 3) * w] = in[(kSeed + 3) * w];
    key_out[i] = cid_key(s);
  }
  add_counts(counts, s.rays, s.act);
}

// Packed state: sf f32[13, w], si i32[si_rows, w] (seed, then rows passed
// through); the budget is the constant 1 << 30.
__global__ void __launch_bounds__(kThreads)
    bounce_packed_kernel(Params q, int si_rows,
                         const float* __restrict__ sf_in,
                         const int32_t* __restrict__ si_in,
                         float* __restrict__ sf_out,
                         int32_t* __restrict__ si_out,
                         int32_t* __restrict__ key_out,
                         unsigned long long* __restrict__ counts) {
  const int w = q.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
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
    run_ray<true>(s, q);
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
    key_out[i] = cid_key(s);
  }
  add_counts(counts, s.rays, s.act);
}

Params make_params(const void* nodes4, const void* clusters, int w, int bcap,
                   int sky_on, float fuzz, int emissive_emits, float t_min,
                   float t_max, float det_eps) {
  return Params{(const float*)nodes4, (const float*)clusters, w, bcap,
                sky_on, emissive_emits, fuzz, t_min, t_max, det_eps};
}

}  // namespace

extern "C" int rt_bounce12(const void* nodes4, const void* clusters,
                           const void* state_in, void* state_out, void* key,
                           void* counts, int w, int bcap, int sky_on,
                           float fuzz, int emissive_emits, float t_min,
                           float t_max, float det_eps, void* stream) {
  if (w > 0) {
    bounce_kernel<false>
        <<<(w + kThreads - 1) / kThreads, kThreads, 0,
           (cudaStream_t)stream>>>(
            make_params(nodes4, clusters, w, bcap, sky_on, fuzz,
                        emissive_emits, t_min, t_max, det_eps),
            (const int32_t*)state_in, (int32_t*)state_out, (int32_t*)key,
            (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bounce12_attrs(int* out) {
  return rt::kernel_attrs(bounce_kernel<false>, kThreads, out);
}

extern "C" int rt_bounce15(const void* nodes4, const void* clusters,
                           const void* state_in, void* state_out, void* key,
                           void* counts, int w, int bcap, int sky_on,
                           float fuzz, int emissive_emits, float t_min,
                           float t_max, float det_eps, void* stream) {
  if (w > 0) {
    bounce_kernel<true>
        <<<(w + kThreads - 1) / kThreads, kThreads, 0,
           (cudaStream_t)stream>>>(
            make_params(nodes4, clusters, w, bcap, sky_on, fuzz,
                        emissive_emits, t_min, t_max, det_eps),
            (const int32_t*)state_in, (int32_t*)state_out, (int32_t*)key,
            (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bounce15_attrs(int* out) {
  return rt::kernel_attrs(bounce_kernel<true>, kThreads, out);
}

extern "C" int rt_bounce_packed(const void* nodes4, const void* clusters,
                                const void* sf_in, const void* si_in,
                                void* sf_out, void* si_out, void* key,
                                void* counts, int w, int si_rows, int bcap,
                                int sky_on, float fuzz, int emissive_emits,
                                float t_min, float t_max, float det_eps,
                                void* stream) {
  if (w > 0) {
    bounce_packed_kernel<<<(w + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(
        make_params(nodes4, clusters, w, bcap, sky_on, fuzz, emissive_emits,
                    t_min, t_max, det_eps),
        si_rows, (const float*)sf_in, (const int32_t*)si_in, (float*)sf_out,
        (int32_t*)si_out, (int32_t*)key, (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bounce_packed_attrs(int* out) {
  return rt::kernel_attrs(bounce_packed_kernel, kThreads, out);
}

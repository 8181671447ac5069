// Kernel B: one fused walk + shade round of the sorted wavefront.
//
// Replaces raytracer_tpu/kernels/pallas_mega.py _kernel_core as built by
// make_kernel(carry_color=False, key_mode="cid") and called through
// _bounce_call by bounce_megakernel12: up to bcap iterations of the kernel
// A walk (recording the winner cluster id) plus the material model, the
// no-color carry (a dying ray's atten becomes its colour deposit), the
// per-ray budget kill, the rays/live counts and the next round's sort key.
// The TPU kernel runs one tile of 2048 rays per grid step; here one thread
// runs one ray's whole round.
//
// What bounds it on an H100: the walk (walk.cuh: dependent L2/L1 loads of
// node and cluster rows, warp divergence) plus, per hit, a short
// integer-heavy shade (PCG draws of the bounded rejection sampler). Rays
// arrive sorted by the carried key (winner cluster, then direction
// octant), so neighbouring threads tend to walk similar paths; the design
// leans on that order and otherwise stays simple: one thread per ray, the
// state read once and written once (52 bytes each way), counts reduced per
// warp before one atomic each. Coherent-warp traversal and a persistent
// multi-bounce loop are later work.
//
// RNG: PCG and the two-step u32 -> f32 conversion of pallas_mega._unit
// (i32 convert, then + 2^32 when negative: two roundings, unlike the
// direct conversion of kernels/rng.py used by bounce 0), bit for bit.
//
// State i32[13, w], one row per field: 0-2 origin, 3-5 direction, 6-8
// atten (f32 bits), 9 seed (u32 bits), 10 alive (0/1), 11 bounces-left
// budget, 12 pixel id (passed through). Writes the advanced state to
// state_out, key i32[w] = (dead << 30) | (cid << 3) | octant, and adds
// (rays, live) into counts u64[2].
#include "walk.cuh"

namespace {

constexpr int kRejectionRounds = 24;  // kernels/rng.py REJECTION_ROUNDS

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

__global__ void __launch_bounds__(128)
    bounce12_kernel(const float* __restrict__ nodes4,
                    const float* __restrict__ clusters,
                    const int32_t* __restrict__ st_in,
                    int32_t* __restrict__ st_out,
                    int32_t* __restrict__ key_out,
                    unsigned long long* __restrict__ counts, int w, int bcap,
                    int sky_on, float fuzz, int emissive_emits, float t_min,
                    float t_max, float det_eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < w;
  unsigned int rays = 0;
  bool act = false;
  if (valid) {
    rt::Ray r = {as_f(st_in[i]),         as_f(st_in[w + i]),
                 as_f(st_in[2 * w + i]), as_f(st_in[3 * w + i]),
                 as_f(st_in[4 * w + i]), as_f(st_in[5 * w + i])};
    float atr = as_f(st_in[6 * w + i]), atg = as_f(st_in[7 * w + i]),
          atb = as_f(st_in[8 * w + i]);
    uint32_t seed = (uint32_t)st_in[9 * w + i];
    act = st_in[10 * w + i] != 0;
    int bud = st_in[11 * w + i];
    int cid = 0;
    for (int b = 0; b < bcap && act; ++b) {
      ++rays;
      const rt::Hit h = rt::walk(nodes4, clusters, r, t_min, t_max, det_eps);
      cid = h.cid;
      // Shade (pallas_mega._kernel_core shade(); the ray is alive here).
      const bool hit = h.t < t_max;
      const bool miss = !hit;
      const float dlen = sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
      const float idl = 1.0f / (dlen > 0.0f ? dlen : 1.0f);
      const float uy = r.dy * idl;
      const float tsky = 0.5f * (uy + 1.0f);
      const float omt = 1.0f - tsky;
      const float skr = sky_on ? omt + tsky * 0.5f : 0.0f;
      const float skg = sky_on ? omt + tsky * 0.7f : 0.0f;
      const float skb = sky_on ? omt + tsky * 1.0f : 0.0f;

      const float mt = h.mt;
      const bool is_lam = mt == 0.0f;
      const bool is_metal = (mt == 1.0f) || (mt == 2.0f);
      const bool is_emis = mt == 3.0f;
      const bool needs = hit && (is_lam || is_metal);
      float sphx = 0.0f, sphy = 0.0f, sphz = 0.0f;
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
      const float fz = mt == 2.0f ? fuzz : 0.0f;
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

      // No-color carry: a dying ray's atten becomes its deposit.
      float dr = miss ? atr * skr : 0.0f;
      float dg = miss ? atg * skg : 0.0f;
      float db = miss ? atb * skb : 0.0f;
      if (emissive_emits && hit && is_emis) {
        dr = h.ar * atr;
        dg = h.ag * atg;
        db = h.ab * atb;
      }
      if (scattered) {
        atr = atr * h.ar;
        atg = atg * h.ag;
        atb = atb * h.ab;
        const float hx = r.ox + r.dx * h.t;
        const float hy = r.oy + r.dy * h.t;
        const float hz = r.oz + r.dz * h.t;
        r = {hx, hy, hz, newx, newy, newz};
      } else {
        atr = dr;
        atg = dg;
        atb = db;
      }
      act = scattered;
      // Per-ray budget: every iteration entered alive costs 1; at 0 the
      // ray dies here, killed to black.
      bud -= 1;
      if (bud <= 0 && act) {
        atr = 0.0f;
        atg = 0.0f;
        atb = 0.0f;
      }
      if (!(bud > 0)) act = false;
    }
    st_out[i] = as_i(r.ox);
    st_out[w + i] = as_i(r.oy);
    st_out[2 * w + i] = as_i(r.oz);
    st_out[3 * w + i] = as_i(r.dx);
    st_out[4 * w + i] = as_i(r.dy);
    st_out[5 * w + i] = as_i(r.dz);
    st_out[6 * w + i] = as_i(atr);
    st_out[7 * w + i] = as_i(atg);
    st_out[8 * w + i] = as_i(atb);
    st_out[9 * w + i] = (int32_t)seed;
    st_out[10 * w + i] = act ? 1 : 0;
    st_out[11 * w + i] = bud;
    st_out[12 * w + i] = st_in[12 * w + i];
    const int octant = (r.dx > 0.0f ? 1 : 0) | (r.dy > 0.0f ? 2 : 0) |
                       (r.dz > 0.0f ? 4 : 0);
    key_out[i] = ((act ? 0 : 1) << 30) | (cid << 3) | octant;
  }
  const unsigned int live = act ? 1u : 0u;
  const unsigned int wr = __reduce_add_sync(0xffffffffu, rays);
  const unsigned int wl = __reduce_add_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0) {
    if (wr) atomicAdd(&counts[0], (unsigned long long)wr);
    if (wl) atomicAdd(&counts[1], (unsigned long long)wl);
  }
}

}  // namespace

extern "C" int rt_bounce12(const void* nodes4, const void* clusters,
                           const void* state_in, void* state_out, void* key,
                           void* counts, int w, int bcap, int sky_on,
                           float fuzz, int emissive_emits, float t_min,
                           float t_max, float det_eps, void* stream) {
  if (w > 0) {
    const int threads = 128;
    const int blocks = (w + threads - 1) / threads;
    bounce12_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)nodes4, (const float*)clusters,
        (const int32_t*)state_in, (int32_t*)state_out, (int32_t*)key,
        (unsigned long long*)counts, w, bcap, sky_on, fuzz, emissive_emits,
        t_min, t_max, det_eps);
  }
  return (int)cudaGetLastError();
}

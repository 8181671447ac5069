// kernels/tracer.py shade for one ray, shared by the mega kernel (mega.cu)
// and the shade kernel (front.cu): sky on a miss, then scatter (Lambertian,
// metal / fuzzy metal, emissive) with the bounded rejection sampler of
// kernels/rng.py, then emit, absorb and advance.
//
// Every product, sum, division and square root is written in the plain
// version's order; built with -fmad=false and no fast math, each rounds
// once as IEEE, so a ray shades bit for bit as the plain ops shade it.
#pragma once

#include <cstdint>

#include "pcg.cuh"
#include "walk.cuh"  // rt::Ray, rt::Hit

namespace rt {

constexpr int kRejectionRounds = 24;  // kernels/rng.py REJECTION_ROUNDS

// rng.to_unit_float: float(u32) / float(0xFFFFFFFF), both rounded to
// nearest (the divisor rounds to 2^32). Kernel B draws otherwise
// (bounce.cuh unit_two_step).
__device__ __forceinline__ float unit(uint32_t s) {
  return __uint2float_rn(s) / 4294967295.0f;
}

struct Path {
  Ray r;
  float cr, cg, cb;     // colour
  float atr, atg, atb;  // atten
  uint32_t seed;
};

struct ShadeConsts {
  int sky_on, emissive_emits;
  float fuzz;
};

// tracer.shade of one ray: alive, and hit (alive and its walk hit, h
// holding the hit with its normal facing the ray); true when the ray
// scattered. A dead ray keeps its ray, atten and seed, and its colour gets
// the plain version's c + 0 * atten.
__device__ __forceinline__ bool shade(Path& s, const Hit& h, bool alive,
                                      bool hit, const ShadeConsts& k) {
  const Ray& r = s.r;
  // sky_color: normalize(d), t = 0.5 (y + 1).
  const float il =
      1.0f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  const float ndx = r.dx * il, ndy = r.dy * il, ndz = r.dz * il;
  const float ts = 0.5f * (ndy + 1.0f);
  const float omt = 1.0f - ts;
  if (alive && !hit) {
    s.cr = s.atr * (k.sky_on ? omt + ts * 0.5f : 0.0f);
    s.cg = s.atg * (k.sky_on ? omt + ts * 0.7f : 0.0f);
    s.cb = s.atb * (k.sky_on ? omt + ts * 1.0f : 0.0f);
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
    uint32_t seed = pcg(pcg(pcg(s.seed)));
    for (int j = 0; j < kRejectionRounds; ++j) {
      seed = pcg(seed);
      const float cx = unit(seed) * 2.0f - 1.0f;
      seed = pcg(seed);
      const float cy = unit(seed) * 2.0f - 1.0f;
      seed = pcg(seed);
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
  const float fz = mt == 2.0f ? k.fuzz : 0.0f;
  const float dn = ndx * h.nx + ndy * h.ny + ndz * h.nz;
  const float rawx = is_lam ? lamx : (ndx - 2.0f * dn * h.nx) + px * fz;
  const float rawy = is_lam ? lamy : (ndy - 2.0f * dn * h.ny) + py * fz;
  const float rawz = is_lam ? lamz : (ndz - 2.0f * dn * h.nz) + pz * fz;
  const float rl = sqrtf(rawx * rawx + rawy * rawy + rawz * rawz);
  const float irl = 1.0f / (rl > 0.0f ? rl : 1.0f);
  const float newx = rawx * irl, newy = rawy * irl, newz = rawz * irl;
  const bool met_ok = (newx * h.nx + newy * h.ny + newz * h.nz) > 0.0f;
  const bool scattered = hit && (is_lam || (is_metal && met_ok));

  const bool emits = k.emissive_emits && hit && is_emis;
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

}  // namespace rt

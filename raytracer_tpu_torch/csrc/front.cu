// The front of a band on the default path, before the sorted rounds:
// ray-gen and the bounce-0 shade, two kernels in place of ~1,790 plain
// PyTorch ops a band.
//
// Neither replaces a Pallas kernel. The JAX package runs both as array ops
// around kernel A (raytracer_tpu/kernels/packet.py render_linear_fast:
// tracer.initial_seed, make_primary_rays, then tracer.shade), which XLA
// fuses on the TPU; as plain PyTorch ops on the card each op is a launch
// of its own, most of them the 24 rounds of masked int64 PCG that the
// rejection sampler (kernels/rng.py) runs for every ray.
//
// raygen_kernel<kJitter>: one thread a ray of a band's P (p_pad) rays, in
// the tile-major order of kernels/packet.py _tile_major_pixels (th x tw
// pixel tiles; th = 1, tw = w is raster order); the pad tail past the
// band's p pixels wraps to valid pixels as dead rays. It writes rays
// f32[6, P] (origin xyz, direction xyz: kernel A's input layout), alive
// u8[P], pix i32[P] (band-local pixel id, p for a pad) and, with kJitter,
// seed (u32 values in i64[P]): tracer.initial_seed, then the two draws of
// tracer.make_primary_rays. Without kJitter (the fixed-light tier): no
// draws and no seed. The camera uniforms and the frame counter are read
// from device memory, so nothing is copied from the host.
//
// shade_kernel: tracer.shade (shade.cuh) one thread a ray, over kernel A's
// record (t, normal xyz, albedo rgb, type), the hit flag, alive, the ray,
// its colour, atten and seed; writes out f32[12, P] (origin, direction,
// colour, atten rows), seed i64[P] and scattered u8[P]. Any caller of
// tracer.shade may take it: a dead ray passes through as the plain ops
// leave it.
//
// What bounds them on an H100: bytes. Ray-gen writes 37 bytes a ray
// (15 MB for a 414,720-ray band, 4.6 us at 3.35 TB/s); the shade reads 90
// and writes 57 (61 MB, 18 us). The rejection loop accepts with
// probability pi / 6, 1.9 rounds a ray on average, so its PCG work is
// small beside the bytes. One thread a ray, every row read and written
// coalesced.
//
// Build with -fmad=false and without fast math: the divisions of u and v
// are IEEE (the plain version divides by 0-d tensors for that), and every
// product, sum and square root rounds as in the plain version.
#include <cstdint>
#include <cuda_runtime.h>

#include "pcg.cuh"
#include "shade.cuh"
#include "walk.cuh"  // rt::kernel_attrs

namespace {

constexpr int kThreads = 256;

struct Camera {
  const float* origin;
  const float* llc;  // lower-left corner
  const float* hor;
  const float* ver;
  const int32_t* frame_count;
};

struct Band {
  int p_pad, p, w, th, tw, y_offset, gh, reference, spp, sample_index;
};

template <bool kJitter>
__global__ void __launch_bounds__(kThreads)
    raygen_kernel(Camera cam, Band b, float* __restrict__ rays,
                  int64_t* __restrict__ seed_out,
                  uint8_t* __restrict__ alive, int32_t* __restrict__ pix) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= b.p_pad) return;
  const size_t n = (size_t)b.p_pad;
  const int im = i % b.p;
  const int per = b.th * b.tw;
  const int t_id = im / per, off = im % per;
  const int tiles_x = b.w / b.tw;
  const int xx = (t_id % tiles_x) * b.tw + off % b.tw;
  const int yl = (t_id / tiles_x) * b.th + off / b.tw;
  const int yy = yl + b.y_offset;
  const bool live = i < b.p;
  alive[i] = live;
  pix[i] = live ? yl * b.w + xx : b.p;

  float ju = 0.0f, jv = 0.0f;
  if constexpr (kJitter) {
    const uint32_t pixel = (uint32_t)((int64_t)yy * b.w + xx);
    uint32_t seed = pixel;
    if (!b.reference) {
      // (frame * spp + sample + 1) mod 2^32, then the golden-ratio mix.
      const uint32_t stream = (uint32_t)__ldg(cam.frame_count) *
                                  (uint32_t)b.spp +
                              (uint32_t)b.sample_index + 1u;
      seed = pixel ^ rt::pcg(stream * 0x9E3779B9u);
    }
    seed = rt::pcg(seed);
    ju = rt::unit(seed);
    seed = rt::pcg(seed);
    jv = rt::unit(seed);
    seed_out[i] = (int64_t)seed;
  }
  const float u = ((float)xx + ju) / (float)b.w;
  const float v = (((float)(b.gh - 1) - (float)yy) + jv) / (float)b.gh;
  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(cam.origin + k);
    d[k] = (__ldg(cam.llc + k) +
            (__ldg(cam.hor + k) * u + __ldg(cam.ver + k) * v)) -
           o[k];
  }
  const float inv = 1.0f / sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rays[k * n + i] = o[k];
    rays[(3 + k) * n + i] = d[k] * inv;
  }
}

// The rows shade_kernel reads, in the order of rt_shade's pointer table.
struct ShadeIn {
  const float* rec[8];  // t, normal xyz, albedo rgb, type
  const uint8_t* hit;
  const uint8_t* alive;
  const float* f[12];  // origin xyz, direction xyz, colour rgb, atten rgb
  const int64_t* seed;
};
constexpr int kShadeIn = 23;

__global__ void __launch_bounds__(kThreads)
    shade_kernel(ShadeIn in, float* __restrict__ out,
                 int64_t* __restrict__ seed_out,
                 uint8_t* __restrict__ scattered, int p,
                 rt::ShadeConsts k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const size_t n = (size_t)p;
  const rt::Hit h = {in.rec[0][i], in.rec[1][i], in.rec[2][i],
                     in.rec[3][i], in.rec[4][i], in.rec[5][i],
                     in.rec[6][i], in.rec[7][i], 0};
  const bool alive = in.alive[i] != 0;
  const bool hit = alive && in.hit[i] != 0;
  rt::Path s;
  s.r = {in.f[0][i], in.f[1][i], in.f[2][i],
         in.f[3][i], in.f[4][i], in.f[5][i]};
  s.cr = in.f[6][i];
  s.cg = in.f[7][i];
  s.cb = in.f[8][i];
  s.atr = in.f[9][i];
  s.atg = in.f[10][i];
  s.atb = in.f[11][i];
  s.seed = (uint32_t)in.seed[i];
  const bool sc = rt::shade(s, h, alive, hit, k);
  const float row[12] = {s.r.ox, s.r.oy, s.r.oz, s.r.dx, s.r.dy, s.r.dz,
                         s.cr,   s.cg,   s.cb,   s.atr,  s.atg,  s.atb};
#pragma unroll
  for (int j = 0; j < 12; ++j) out[j * n + i] = row[j];
  seed_out[i] = (int64_t)s.seed;
  scattered[i] = sc;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int rt_raygen(const void* origin, const void* llc,
                         const void* hor, const void* ver,
                         const void* frame_count, void* rays, void* seed,
                         void* alive, void* pix, int p_pad, int p, int w,
                         int th, int tw, int y_offset, int gh, int jitter,
                         int reference, int spp, int sample_index,
                         void* stream) {
  if (p_pad > 0) {
    const Camera cam{(const float*)origin, (const float*)llc,
                     (const float*)hor, (const float*)ver,
                     (const int32_t*)frame_count};
    const Band b{p_pad, p, w, th, tw, y_offset, gh, reference, spp,
                 sample_index};
    const auto kernel =
        jitter ? &raygen_kernel<true> : &raygen_kernel<false>;
    kernel<<<blocks(p_pad), kThreads, 0, (cudaStream_t)stream>>>(
        cam, b, (float*)rays, (int64_t*)seed, (uint8_t*)alive,
        (int32_t*)pix);
  }
  return (int)cudaGetLastError();
}

// in: kShadeIn device pointers, in ShadeIn's order.
extern "C" int rt_shade(const void* const* in, void* out, void* seed,
                        void* scattered, int p, int sky_on,
                        int emissive_emits, float fuzz, void* stream) {
  if (p > 0) {
    ShadeIn s;
    const void* const* q = in;
    for (int j = 0; j < 8; ++j) s.rec[j] = (const float*)*q++;
    s.hit = (const uint8_t*)*q++;
    s.alive = (const uint8_t*)*q++;
    for (int j = 0; j < 12; ++j) s.f[j] = (const float*)*q++;
    s.seed = (const int64_t*)*q++;
    static_assert(8 + 2 + 12 + 1 == kShadeIn, "ShadeIn's rows");
    shade_kernel<<<blocks(p), kThreads, 0, (cudaStream_t)stream>>>(
        s, (float*)out, (int64_t*)seed, (uint8_t*)scattered, p,
        rt::ShadeConsts{sky_on, emissive_emits, fuzz});
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_raygen_attrs(int* out) {
  return rt::kernel_attrs(raygen_kernel<true>, kThreads, out);
}

extern "C" int rt_shade_attrs(int* out) {
  return rt::kernel_attrs(shade_kernel, kThreads, out);
}

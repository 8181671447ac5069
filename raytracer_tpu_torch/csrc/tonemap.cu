// The frame tail: running-average accumulate, exposure, sqrt gamma, u8.
//
// Replaces raytracer_tpu/kernels/pallas_ops.py _tonemap_accum_kernel (via
// tonemap_accumulate), which reads the frame in the planar [3, H*W] view.
// Per pixel channel, with s = total / spp:
//   new = (acc * fc + s) / (fc + 1)          (written back into acc)
//   q   = rint(sqrt(max(new * 2^exposure, 0)) * 255), clamped to [0, 255]
// Each product, sum, division and square root rounds once as IEEE (built
// with -fmad=false; __fdiv_rn, __fsqrt_rn, rintf rounds half to even, and
// exp2f is the function torch.exp2 calls on the card), so the kernel
// agrees bit for bit with the plain version.
//
// Inputs and layout: the band sum total f32[3, H*W] as the renderer
// builds it (planar, read in place: no division, transpose or copy
// before the call), spp by value, the frame count (i32) and the exposure
// in stops (f32) read through device pointers (no host sync); the
// accumulator f32[H, W, 3] is updated in place and the image u8[H, W, 3]
// written. One launch a frame.
//
// What bounds it on an H100: bytes alone (read total and acc, write acc
// and the image: 13 bytes a pixel channel, ~36 MB at 1280x720, ~0.011 ms
// at the data sheet's 3.35 TB/s). Each thread takes 4 pixels: one 16-byte
// load per plane of total, three 16-byte loads and stores of acc, three
// 4-byte stores of the image. Where H*W is not a multiple of 4 (or a
// pointer is not aligned so), every thread takes the scalar path.
// Measured at 1280x720 (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): 0.0166
// ms from device memory, 65% of the bound, against 0.0146 ms for the
// Triton kernel this replaced, which did one IEEE division a channel
// where this does two (its caller divided by spp and transposed the
// frame first, two more launches); staging the planes in shared memory
// so every warp access is contiguous, 128-thread blocks, and building
// without the division at spp 1 did not make it faster.
#include <cstdint>
#include <cuda_runtime.h>

#include "walk.cuh"  // rt::kernel_attrs

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float spp, fc, fc1, scale;
};

// One pixel channel: acc in, new acc out (returned), the u8 value in q.
__device__ __forceinline__ float tone(float acc, float total, const Scalars& k,
                                      uint32_t& q) {
  const float s = __fdiv_rn(total, k.spp);
  const float nw = __fdiv_rn(__fadd_rn(__fmul_rn(acc, k.fc), s), k.fc1);
  const float g = __fsqrt_rn(fmaxf(__fmul_rn(nw, k.scale), 0.0f));
  const float r = fminf(fmaxf(rintf(__fmul_rn(g, 255.0f)), 0.0f), 255.0f);
  q = (uint32_t)r;
  return nw;
}

__global__ void __launch_bounds__(kThreads)
    tonemap_kernel(const float* __restrict__ total, float* __restrict__ acc,
                   uint8_t* __restrict__ image, int hw, int spp,
                   const int32_t* __restrict__ frame_count,
                   const float* __restrict__ exposure, bool vec) {
  const float fc = (float)__ldg(frame_count);
  const Scalars k = {(float)spp, fc, __fadd_rn(fc, 1.0f),
                     exp2f(__ldg(exposure))};
  const int p0 = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (p0 >= hw) return;
  if (vec) {
    // 4 whole pixels: planes and rows 16-byte aligned.
    const float4 t0 = __ldg(reinterpret_cast<const float4*>(total + p0));
    const float4 t1 =
        __ldg(reinterpret_cast<const float4*>(total + hw + p0));
    const float4 t2 =
        __ldg(reinterpret_cast<const float4*>(total + 2 * hw + p0));
    float4* a = reinterpret_cast<float4*>(acc + 3 * p0);
    float4 a0 = a[0], a1 = a[1], a2 = a[2];
    // acc holds r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3.
    uint32_t q[12];
    a0.x = tone(a0.x, t0.x, k, q[0]);
    a0.y = tone(a0.y, t1.x, k, q[1]);
    a0.z = tone(a0.z, t2.x, k, q[2]);
    a0.w = tone(a0.w, t0.y, k, q[3]);
    a1.x = tone(a1.x, t1.y, k, q[4]);
    a1.y = tone(a1.y, t2.y, k, q[5]);
    a1.z = tone(a1.z, t0.z, k, q[6]);
    a1.w = tone(a1.w, t1.z, k, q[7]);
    a2.x = tone(a2.x, t2.z, k, q[8]);
    a2.y = tone(a2.y, t0.w, k, q[9]);
    a2.z = tone(a2.z, t1.w, k, q[10]);
    a2.w = tone(a2.w, t2.w, k, q[11]);
    a[0] = a0;
    a[1] = a1;
    a[2] = a2;
    uint32_t* img = reinterpret_cast<uint32_t*>(image + 3 * p0);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      img[j] = q[4 * j] | (q[4 * j + 1] << 8) | (q[4 * j + 2] << 16) |
               (q[4 * j + 3] << 24);
    }
  } else {
    const int p1 = p0 + 4 < hw ? p0 + 4 : hw;
    for (int p = p0; p < p1; ++p) {
      for (int c = 0; c < 3; ++c) {
        uint32_t q;
        acc[3 * p + c] = tone(acc[3 * p + c], total[c * hw + p], k, q);
        image[3 * p + c] = (uint8_t)q;
      }
    }
  }
}

}  // namespace

extern "C" int rt_tonemap(const void* total, void* acc, void* image, int hw,
                          int spp, const void* frame_count,
                          const void* exposure, void* stream) {
  if (hw > 0) {
    const bool vec = hw % 4 == 0 && (uintptr_t)total % 16 == 0 &&
                     (uintptr_t)acc % 16 == 0 && (uintptr_t)image % 4 == 0;
    const int threads = (hw + 3) / 4;
    tonemap_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
        (const float*)total, (float*)acc, (uint8_t*)image, hw, spp,
        (const int32_t*)frame_count, (const float*)exposure, vec);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_tonemap_attrs(int* out) {
  return rt::kernel_attrs(tonemap_kernel, kThreads, out);
}

// The PCG output hash of kernels/rng.py (compute_dynamic_ray.comp:52-56),
// u32 -> u32, shared by kernel B (bounce12.cu) and the mega kernel
// (mega.cu).
#pragma once

#include <cstdint>

namespace rt {

__device__ __forceinline__ uint32_t pcg(uint32_t v) {
  const uint32_t state = v * 747796405u + 2891336453u;
  const uint32_t word =
      ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

}  // namespace rt

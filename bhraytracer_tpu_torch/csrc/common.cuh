// Shared device helpers for the port's CUDA kernels.
//
// Build flags (ops/kernels.py): -fmad=false, no --use_fast_math, so every
// multiply and add below rounds on its own and sqrtf / division are IEEE,
// as the plain PyTorch twins compute them. Expressions keep the operand
// order of the twins (left to right, a*b + c*d + e*f == (a*b + c*d) + e*f).
#pragma once

#include <cuda_runtime.h>

#define BHRT_BIG 1.0e30f
#define BHRT_BIGI (1 << 30)
#define BHRT_PERP_EPS 0.001745f
#define BHRT_MAX_ANALYTIC 32

// Instance-local ray through a [itm (9), pos (3)] row (local_ray,
// bhraytracer_tpu/ops/pallas_analytic.py:24-36).
__device__ __forceinline__ void bhrt_local_ray(
    const float* r, float ox, float oy, float oz, float dx, float dy, float dz,
    float* l) {
  const float sx = ox - r[9], sy = oy - r[10], sz = oz - r[11];
  l[0] = r[0] * sx + r[1] * sy + r[2] * sz;
  l[1] = r[3] * sx + r[4] * sy + r[5] * sz;
  l[2] = r[6] * sx + r[7] * sy + r[8] * sz;
  l[3] = r[0] * dx + r[1] * dy + r[2] * dz;
  l[4] = r[3] * dx + r[4] * dy + r[5] * dz;
  l[5] = r[6] * dx + r[7] * dy + r[8] * dz;
}

// Copy n floats from global to shared memory with the whole block.
__device__ __forceinline__ void bhrt_stage(float* dst, const float* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

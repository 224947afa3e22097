// What the blur kernels share (stencil.cu: B8-B10; blur_resident_opt.cu: B13):
// the block size limit and refusal codes of their entry points, periodic
// indices, the small division of their flat loops, and loads and stores of
// the image's type as float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the most threads a block of B9, B8 or B13 takes: the caller names the count
constexpr int kMaxThreads = 1024;

// refusals of the entry points (CUDA's own errors are positive)
constexpr int kNotCoResident = -1;
constexpr int kNoCooperativeLaunch = -2;
constexpr int kBadArgument = -3;

// x mod n, non-negative. Only cells of a halo that crosses the array's edge
// pay for the division.
__device__ __forceinline__ int wrap(int x, int n) {
  if ((unsigned)x >= (unsigned)n) {
    x %= n;
    if (x < 0) x += n;
  }
  return x;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// idx / w for 0 <= idx < 2^16 and 0 < w < 2^10, with inv_w = 1.0f / w:
// (idx + 0.5) / w lies at least 0.5/w from an integer, far more than the
// float rounding error of the product, so truncation gives the quotient.
__device__ __forceinline__ int div_small(int idx, float inv_w) {
  return (int)((float(idx) + 0.5f) * inv_w);
}

}  // namespace

// The D3Q19 lattice, one cell's collision and the fixed-order reductions that
// the 3-D kernels share (d3q19_kstep.cu: B4 and B6; d3q19_blocked.cu: B5 and
// B7). Every kernel collides a cell through collide_cell below, so a cell that
// two kernels compute from the same 19 values gets the same bits from both
// (the libraries are compiled with -fmad=false).
//
// Two groupings of the collision, one a library: by default the 'paired'
// grouping of d3q19.collide_fields; built with -DLBM_D3Q19_PER_SPEED (the
// library that d3q19.GROUPING = "reference" loads, ops/_build.py) the
// reference's per-speed grouping, the `GROUPING != "paired"` branch of
// lbm_tpu/ops/d3q19.py, operation for operation.
//
// Types: a kernel stores the lattice in S (float, double or bfloat16) and
// collides in storage::Compute<S>::type (csrc/storage.cuh): a bfloat16
// lattice steps in float and rounds once a pass.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

constexpr int kQ = 19;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

// X(q, dz, dy, dx, opposite): the lattice of ops/d3q19_lattice.py
#define D3Q19_SPEEDS(X)                                                     \
  X(0, 0, 0, 0, 0)                                                          \
  X(1, 0, 0, 1, 2) X(2, 0, 0, -1, 1)                                        \
  X(3, 0, 1, 0, 4) X(4, 0, -1, 0, 3)                                        \
  X(5, 1, 0, 0, 6) X(6, -1, 0, 0, 5)                                        \
  X(7, 0, 1, 1, 10) X(8, 0, 1, -1, 9) X(9, 0, -1, 1, 8) X(10, 0, -1, -1, 7) \
  X(11, 1, 0, 1, 14) X(12, 1, 0, -1, 13) X(13, -1, 0, 1, 12)                \
  X(14, -1, 0, -1, 11)                                                      \
  X(15, 1, 1, 0, 18) X(16, 1, -1, 0, 17) X(17, -1, 1, 0, 16)                \
  X(18, -1, -1, 0, 15)

struct Grid {
  int nz, ny, nx;
};

struct Window {
  int plane_offset, valid_lo, valid_hi, global_nz, row_lo, row_hi, accel_plane;
};

// one_minus_omega; (W * omega) of the rest, axis and edge speeds; the force
// density * accel * W of the axis and edge speeds; omega (the per-speed
// grouping forms (W * rho) * omega)
template <typename T>
struct Coef {
  T omo, wo0, wo1, wo2, fw1, fw2, om;
};

__device__ __forceinline__ int wrap(int x, int n) {
  int m = x % n;
  return m < 0 ? m + n : m;
}

// One cell of collide_fields: s are the 19 pulled values, o the 19
// post-collision values; returns |u| (0 on obstacles).
template <typename T>
__device__ __forceinline__ T collide_cell(const T s[kQ], bool obstacle,
                                          bool accel, const Coef<T>& p,
                                          T o[kQ]) {
  T rho = s[0];
#pragma unroll
  for (int q = 1; q < kQ; ++q) rho = rho + s[q];
  const T u_x = (s[1] - s[2] + s[7] - s[8] + s[9] - s[10] + s[11] - s[12] +
                 s[13] - s[14]) / rho;
  const T u_y = (s[3] - s[4] + s[7] + s[8] - s[9] - s[10] + s[15] - s[16] +
                 s[17] - s[18]) / rho;
  const T u_z = (s[5] - s[6] + s[11] + s[12] - s[13] - s[14] + s[15] + s[16] -
                 s[17] - s[18]) / rho;
  const T u_sq = u_x * u_x + u_y * u_y + u_z * u_z;
  if (obstacle) {
#define BOUNCE(q, dz, dy, dx, opp) o[q] = s[opp];
    D3Q19_SPEEDS(BOUNCE)
#undef BOUNCE
    return T(0);
  }
  const T c_sq = T(1.0) - u_sq * T(1.5);
#ifdef LBM_D3Q19_PER_SPEED
  // the reference's grouping: per speed, e.u summed in the order x, y, z,
  // then ((W rho) omega) ((4.5 eu)(2/3 + eu) + c_sq)
  const T w0 = T(1.0 / 3.0), w1 = T(1.0 / 18.0), w2 = T(1.0 / 36.0);
  o[0] = s[0] * p.omo + ((w0 * rho) * p.om) * c_sq;
#define SPEED(k, eu_expr, w)                                                          \
  {                                                                                  \
    const T eu = (eu_expr);                                                          \
    o[k] = s[k] * p.omo + (((w) * rho) * p.om) * ((T(4.5) * eu) * (T(2.0 / 3.0) + eu) + c_sq); \
  }
  SPEED(1, u_x, w1)
  SPEED(2, -u_x, w1)
  SPEED(3, u_y, w1)
  SPEED(4, -u_y, w1)
  SPEED(5, u_z, w1)
  SPEED(6, -u_z, w1)
  SPEED(7, u_x + u_y, w2)
  SPEED(8, -u_x + u_y, w2)
  SPEED(9, u_x + -u_y, w2)
  SPEED(10, -u_x + -u_y, w2)
  SPEED(11, u_x + u_z, w2)
  SPEED(12, -u_x + u_z, w2)
  SPEED(13, u_x + -u_z, w2)
  SPEED(14, -u_x + -u_z, w2)
  SPEED(15, u_y + u_z, w2)
  SPEED(16, -u_y + u_z, w2)
  SPEED(17, u_y + -u_z, w2)
  SPEED(18, -u_y + -u_z, w2)
#undef SPEED
#else
  const T w0 = p.wo0 * rho, w1 = p.wo1 * rho, w2 = p.wo2 * rho;
  o[0] = s[0] * p.omo + w0 * c_sq;
  // an opposite pair (k, kb) shares eu, the quadratic term and the weight
#define PAIR(k, kb, eu_expr, w)                      \
  {                                                  \
    const T eu = (eu_expr);                          \
    const T quad = (T(4.5) * eu) * eu + c_sq;        \
    const T lin = T(3.0) * eu;                       \
    o[k] = s[k] * p.omo + (w) * (quad + lin);        \
    o[kb] = s[kb] * p.omo + (w) * (quad - lin);      \
  }
  PAIR(1, 2, u_x, w1)
  PAIR(3, 4, u_y, w1)
  PAIR(5, 6, u_z, w1)
  PAIR(7, 10, u_x + u_y, w2)
  PAIR(8, 9, -u_x + u_y, w2)
  PAIR(11, 14, u_x + u_z, w2)
  PAIR(12, 13, -u_x + u_z, w2)
  PAIR(15, 18, u_y + u_z, w2)
  PAIR(16, 17, -u_y + u_z, w2)
#undef PAIR
#endif
  if (accel) {  // + on the speeds that move towards +x, - on their opposites
    o[1] = o[1] + p.fw1;
    o[2] = o[2] - p.fw1;
    o[7] = o[7] + p.fw2;
    o[10] = o[10] - p.fw2;
    o[8] = o[8] - p.fw2;
    o[9] = o[9] + p.fw2;
    o[11] = o[11] + p.fw2;
    o[14] = o[14] - p.fw2;
    o[12] = o[12] - p.fw2;
    o[13] = o[13] + p.fw2;
  }
  return sqrt(u_sq);
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red, int tid, int nwarps) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  T acc = T(0);
  if (tid == 0)
    for (int w = 0; w < nwarps; ++w) acc += red[w];
  return acc;
}

// tot[j] = sum over blocks of partials[j, :], one block per step, fixed order.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
sum_partials_kernel(const T* __restrict__ partials, int nblocks,
                    T* __restrict__ tot) {
  __shared__ T red[kMaxWarps];
  const int j = blockIdx.x;
  T acc = T(0);
  for (int i = threadIdx.x; i < nblocks; i += kMaxThreads)
    acc += partials[(size_t)j * nblocks + i];
  const T s = block_sum<T>(acc, red, threadIdx.x, kMaxWarps);
  if (threadIdx.x == 0) tot[j] = s;
}

template <typename T>
Coef<T> make_coef(double omo, double wo0, double wo1, double wo2, double fw1,
                  double fw2, double om) {
  return Coef<T>{T(omo), T(wo0), T(wo1), T(wo2), T(fw1), T(fw2), T(om)};
}

template <typename T>
int sum_partials(const T* partials, int nblocks, int k, T* tot,
                 cudaStream_t stream) {
  sum_partials_kernel<T><<<k, kMaxThreads, 0, stream>>>(partials, nblocks, tot);
  return (int)cudaGetLastError();
}

}  // namespace

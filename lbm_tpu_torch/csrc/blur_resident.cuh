// The resident blur: a whole run of 3x3 blur passes in ONE cooperative
// launch, the image held in the SMs' shared memory throughout. Kernel B8
// (csrc/stencil.cu, the V0 instance) and the variants v0-v7 of kernel B13
// (csrc/blur_resident_opt.cu) are instances of this one template.
//
// The card has no fast memory that holds a whole image, so the image is
// spread over the shared memory of the SMs: at most as many blocks as are
// co-resident, each keeping its tile plus a halo (two state buffers, and,
// unless the variant zeroes a ring, its part of the mask) for the whole run.
// After each pass a block writes its tile's first and last row and columns
// to exchange buffers in device memory (full-width rows, so corners need no
// case of their own), the grid synchronises, and every block reads its halo
// from its neighbours' edges. Two exchange buffers alternate by the pass's
// parity, so one barrier per pass is enough. The exchange is read and
// written past L1 (__ldcg/__stcg), which is not coherent between SMs. The
// image crosses device memory once in and once out; the pass count is a
// runtime argument.
//
// `resident_kernel<T, V>`: T is the image's type in memory (float or
// bfloat16) and V the variant:
//   State     float | bfloat16: the two buffers in shared memory, the mask,
//             the exchange; a bfloat16 state is rounded at the end of every
//             pass (v3, v6), not once at the store as B8's bfloat16 path does
//   kBf16     every operation rounded to bfloat16 (__hadd/__hmul, v7)
//   kFolded   rows = 0.25 (below + above) + 0.5 mid (v4-v7), or B8's
//             rows = (below + 2 mid) + above and a final x 1/16 (V0: B8, v0-v3)
//   kRing     the pad ring (row 0, rows past h0, column 0, columns past w0)
//             set to zero (v5-v7), or a multiply by the interior mask, which
//             then lives in shared memory too
//   kRank2    the (h, w*C) layout (v2): horizontal neighbours are C flat
//             columns away, so the column halo and its exchange are C
//             columns wide; a tile's edge may cut through a pixel's channels
// Every sum is taken in the TPU kernel's order and every factor is a power of
// two, so each instance equals its plain PyTorch version bit for bit (the
// libraries are built with -fmad=false all the same).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "blur_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRow = 1023;  // div_small's divisor: a tile row with its halo

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the exchange, read and written in L2
__device__ __forceinline__ void xst(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ float xld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ void xst(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}
__device__ __forceinline__ __nv_bfloat16 xld(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename S, bool Bf16, bool Folded, bool Ring, bool Rank2>
struct Variant {
  using State = S;
  static constexpr bool kBf16 = Bf16, kFolded = Folded, kRing = Ring, kRank2 = Rank2;
  static_assert(!Bf16 || (Folded && sizeof(S) == 2), "bf16 arithmetic is v7's: folded, bf16");
  static_assert(!(Ring && Rank2), "the ring is of the (C, h, w) layout");
};

using V0 = Variant<float, false, false, false, false>;
using V2 = Variant<float, false, false, false, true>;
using V3 = Variant<__nv_bfloat16, false, false, false, false>;
using V4 = Variant<float, false, true, false, false>;
using V5 = Variant<float, false, true, true, false>;
using V6 = Variant<__nv_bfloat16, false, true, true, false>;
using V7 = Variant<__nv_bfloat16, true, true, true, false>;

// One stage of a pass on float values, `lo` the neighbour summed first (the
// row below, the column to the right): B8's (lo + 2 mid) + hi, or the folded
// 0.25 (lo + hi) + 0.5 mid.
template <bool Folded>
__device__ __forceinline__ float stage(float lo, float mid, float hi) {
  if (Folded) return 0.25f * (lo + hi) + 0.5f * mid;
  return (lo + 2.0f * mid) + hi;
}

// v7's stage, each operation rounded to bfloat16
__device__ __forceinline__ __nv_bfloat16 stage_bf16(__nv_bfloat16 lo, __nv_bfloat16 mid,
                                                    __nv_bfloat16 hi) {
  const __nv_bfloat16 quarter = __float2bfloat16_rn(0.25f);
  const __nv_bfloat16 half = __float2bfloat16_rn(0.5f);
  return __hadd(__hmul(quarter, __hadd(lo, hi)), __hmul(half, mid));
}

// One value of a pass: p points at the cell in the current buffer, sw is its
// row stride, step the distance of a horizontal neighbour; `mask` is the
// cell's interior mask (masked variants), `ring` whether it lies on the pad
// ring (ring variants).
template <typename V>
__device__ __forceinline__ typename V::State cell(const typename V::State* p, int sw,
                                                  int step, typename V::State mask,
                                                  bool ring) {
  using S = typename V::State;
  if constexpr (V::kBf16) {
    auto rows = [&](int o) { return stage_bf16(p[sw + o], p[o], p[o - sw]); };
    const S acc = stage_bf16(rows(step), rows(0), rows(-step));
    return ring ? __float2bfloat16_rn(0.0f) : acc;
  } else {
    auto rows = [&](int o) {
      return stage<V::kFolded>(to_f(p[sw + o]), to_f(p[o]), to_f(p[o - sw]));
    };
    float acc = stage<V::kFolded>(rows(step), rows(0), rows(-step));
    if (!V::kFolded) acc = acc * 0.0625f;
    if (V::kRing) return from_f<S>(ring ? 0.0f : acc);
    return from_f<S>(acc * to_f(mask));
  }
}

// Shared memory: two state buffers of (th + 2) x (tw + 2 hw), then the
// tile's mask (th x tw, row stride tw) unless the variant zeroes a ring.
// Exchange buffers, one pair per parity of the pass:
//   xrow[parity][plane][tile row][0 = first row, 1 = last row][w]
//   xcol[parity][plane][tile column][0 = first hw columns, 1 = last][hw][h]
// For kRank2 the image is one (h, w) = (h, w*C) plane and hw = C; otherwise
// it is (planes, h, w) and hw = 1.
template <typename T, typename V>
__global__ void __launch_bounds__(kMaxThreads)
resident_kernel(const T* __restrict__ img, const T* __restrict__ interior,
                T* __restrict__ out, typename V::State* xrow, typename V::State* xcol,
                int h, int w, int hw_arg, int th, int tw, int h0, int w0, int num_passes) {
  using S = typename V::State;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = V::kRank2 ? hw_arg : 1;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ntx = gridDim.x, nty = gridDim.y, np = gridDim.z;
  const int tx = blockIdx.x, ty = blockIdx.y, pl = blockIdx.z;
  const int r0 = ty * th, c0 = tx * tw;
  const int eh = min(th, h - r0), ew = min(tw, w - c0);  // this tile's extent
  const int sw = tw + 2 * hw;                             // shared row stride
  const int lw = ew + 2 * hw;                             // a row with its halo
  const int plane = (th + 2) * sw;
  S* cur = reinterpret_cast<S*>(smem_raw);
  S* nxt = cur + plane;
  S* m = nxt + plane;

  const T* gplane = img + (size_t)pl * h * w;
  const float inv_lw = 1.0f / lw, inv_ew = 1.0f / ew;
  for (int idx = tid; idx < (eh + 2) * lw; idx += nthreads) {
    const int r = div_small(idx, inv_lw);
    const int c = idx - r * lw;
    cur[r * sw + c] =
        from_f<S>(ld(gplane + (size_t)wrap(r0 - 1 + r, h) * w + wrap(c0 - hw + c, w)));
  }
  if (!V::kRing) {
    for (int idx = tid; idx < eh * ew; idx += nthreads) {
      const int r = div_small(idx, inv_ew);
      const int c = idx - r * ew;
      m[r * tw + c] = from_f<S>(ld(interior + (size_t)(r0 + r) * w + c0 + c));
    }
  }
  __syncthreads();

  const size_t xrow_parity = (size_t)np * nty * 2 * w;
  const size_t xcol_parity = (size_t)np * ntx * 2 * hw * h;
  const int ty_up = (ty + nty - 1) % nty, ty_down = (ty + 1) % nty;
  const int tx_left = (tx + ntx - 1) % ntx, tx_right = (tx + 1) % ntx;
  const S zero = from_f<S>(0.0f);

  for (int p = 0; p < num_passes; ++p) {
    for (int idx = tid; idx < eh * ew; idx += nthreads) {
      const int r = div_small(idx, inv_ew);
      const int c = idx - r * ew;
      const int gr = r0 + r, gc = c0 + c;
      const bool ring = V::kRing && (gr == 0 || gr > h0 || gc == 0 || gc > w0);
      const int mid = (r + 1) * sw + c + hw;
      nxt[mid] = cell<V>(cur + mid, sw, hw, V::kRing ? zero : m[r * tw + c], ring);
    }
    __syncthreads();
    if (p + 1 < num_passes) {
      S* xr = xrow + (p & 1) * xrow_parity;
      S* xc = xcol + (p & 1) * xcol_parity;
      S* my_rows = xr + (size_t)(pl * nty + ty) * 2 * w + c0;
      S* my_cols = xc + (size_t)(pl * ntx + tx) * 2 * hw * h + r0;
      for (int c = tid; c < ew; c += nthreads) {
        xst(my_rows + c, nxt[sw + hw + c]);
        xst(my_rows + w + c, nxt[eh * sw + hw + c]);
      }
      // (column k, row r) flat over the threads, so that the hw columns of
      // a short tile go to L2 together and not hw round trips in series
      for (int idx = tid; idx < hw * eh; idx += nthreads) {
        const int k = idx / eh, r = idx - k * eh;
        xst(my_cols + (size_t)k * h + r, nxt[(r + 1) * sw + hw + k]);
        xst(my_cols + (size_t)(hw + k) * h + r, nxt[(r + 1) * sw + ew + k]);
      }
      grid.sync();
      // halo: the last row of the tile row above, the first of the one
      // below (corners included: the rows span the width), then the last hw
      // columns of the tile column to the left and the first hw to the right
      const S* above = xr + ((size_t)(pl * nty + ty_up) * 2 + 1) * w;
      const S* below = xr + ((size_t)(pl * nty + ty_down) * 2) * w;
      for (int c = tid; c < lw; c += nthreads) {
        const int gc = wrap(c0 - hw + c, w);
        nxt[c] = xld(above + gc);
        nxt[(eh + 1) * sw + c] = xld(below + gc);
      }
      const S* left = xc + (size_t)(pl * ntx + tx_left) * 2 * hw * h + r0;
      const S* right = xc + (size_t)(pl * ntx + tx_right) * 2 * hw * h + r0;
      for (int idx = tid; idx < hw * eh; idx += nthreads) {
        const int k = idx / eh, r = idx - k * eh;
        nxt[(r + 1) * sw + k] = xld(left + (size_t)(hw + k) * h + r);
        nxt[(r + 1) * sw + hw + ew + k] = xld(right + (size_t)k * h + r);
      }
      __syncthreads();
    }
    S* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  T* oplane = out + (size_t)pl * h * w;
  for (int idx = tid; idx < eh * ew; idx += nthreads) {
    const int r = div_small(idx, inv_ew);
    const int c = idx - r * ew;
    st(oplane + (size_t)(r0 + r) * w + c0 + c, to_f(cur[(r + 1) * sw + c + hw]));
  }
}

// Mirrored by blur_resident_opt.resident_bytes on the Python side.
template <typename V>
size_t resident_smem_bytes(int th, int tw, int hw) {
  const size_t plane = (size_t)(th + 2) * (tw + 2 * hw);
  return sizeof(typename V::State) * (2 * plane + (V::kRing ? 0 : (size_t)th * tw));
}

// c: channels. For kRank2 the image is (h, w) with w = the flat width and
// c the column step; otherwise it is (c, h, w).
template <typename T, typename V>
int launch_resident(const void* img, const void* interior, void* out, void* xrow, void* xcol,
           int c, int h, int w, int th, int tw, int h0, int w0,
                    int num_passes, int threads, cudaStream_t stream) {
  const int hw = V::kRank2 ? c : 1;
  const int planes = V::kRank2 ? 1 : c;
  if (threads < 32 || threads > kMaxThreads || c < 1 || h < 1 || w < 1 || th < 1 ||
      tw < hw || num_passes < 0 || tw + 2 * hw > kMaxRow ||
      (th + 2) * (tw + 2 * hw) >= 65536)
    return kBadArgument;
  const int ntx = (w + tw - 1) / tw, nty = (h + th - 1) / th;
  if (w - (ntx - 1) * tw < hw) return kBadArgument;  // the last tile holds the halo
  int device = 0, cooperative = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!cooperative) return kNoCooperativeLaunch;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = resident_smem_bytes<V>(th, tw, hw);
  err = cudaFuncSetAttribute(resident_kernel<T, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel<T, V>,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ntx, nty, planes);
  // a grid barrier among blocks that are not all resident never returns
  if ((long long)grid.x * grid.y * grid.z > (long long)per_sm * sms) return kNotCoResident;

  using S = typename V::State;
  const T* img_t = static_cast<const T*>(img);
  const T* interior_t = static_cast<const T*>(interior);
  T* out_t = static_cast<T*>(out);
  S* xrow_s = static_cast<S*>(xrow);
  S* xcol_s = static_cast<S*>(xcol);
  int hw_arg = hw;
  void* args[] = {&img_t, &interior_t, &out_t, &xrow_s, &xcol_s, &h, &w,
                  &hw_arg, &th, &tw, &h0, &w0, &num_passes};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(resident_kernel<T, V>), grid,
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

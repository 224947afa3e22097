// The resident blur: a whole run of 3x3 blur passes in ONE cooperative
// launch, the image held in the SMs' shared memory throughout. Kernel B8
// (csrc/stencil.cu, the V0 instance) and the variants v0-v7 of kernel B13
// (csrc/blur_resident_opt.cu) are instances of this one template.
//
// The card has no fast memory that holds a whole image, so the image is
// spread over the shared memory of the SMs: at most as many blocks as are
// co-resident, each keeping its tile plus a halo k cells deep (two state
// buffers and, unless the variant zeroes a ring, the mask over the tile and
// all but the outermost ring of the halo) for the whole run. A block runs k
// passes on its region, which shrinks by one cell a side a pass, so that
// after k passes its tile is right; then it writes its tile's first and last
// k rows and k*hw columns to exchange buffers in device memory (full-width
// rows, so corners need no case of their own) and reads its halo from its
// neighbours' edges. The run's remainder of passes mod k is a shorter last
// group.
//
// The exchange has no grid barrier. Every value goes to L2 as one naturally
// aligned 8-byte word: 32 bits of payload and a 32-bit tag that names the
// exchange (the pattern of NCCL's "LL" protocol). A reader polls each word
// it needs until the tag is the one it waits for, so a block waits only on
// the words of its neighbours (the three tiles above and the three below
// through the rows, left and right through the columns). Two buffers
// alternating by the exchange's parity are enough: a block writes exchange
// e + 2 only after it has read its neighbours' e + 1, which they wrote only
// after reading e. The tags of a launch are tag0 + 1 .. tag0 + E: the
// wrapper keeps the buffers for a stream and continues the count from launch
// to launch, so no word left by an earlier launch carries a tag this one
// waits for (ops/blur_resident_opt.py `exchange`). All blocks must be
// resident at once, as a barrier needed: hence the cooperative launch. A
// poll that waits absurdly long traps, so that a fault fails the launch
// instead of hanging the card.
//
// A pass walks its region in strips: a thread takes one column of a strip
// of rows and keeps its 3x3 window in registers, three shared loads a new
// row instead of nine and no division a cell; the strips a region is cut
// into give a thread the fewest rows to walk (`plan_strips`). A block has at
// most 512 threads, so that a thread may hold 128 registers. The image
// crosses device memory once in and once out; the pass count is a runtime
// argument.
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
//             columns away, so the column halo and its exchange are k*C
//             columns wide; a tile's edge may cut through a pixel's channels
// Every sum is taken in the TPU kernel's order and every factor is a power of
// two, so each instance equals its plain PyTorch version bit for bit (the
// libraries are built with -fmad=false all the same). A cell of the halo is
// computed from the same values in the same order as by the block that owns
// it, so the redundant cells agree bit for bit too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "blur_common.cuh"

namespace {

constexpr int kMaxRow = 1023;   // div_small's divisor: a tile row with its halo
// threads a block at most: 128 registers a thread, one block an SM
constexpr int kResidentMaxThreads = 512;
constexpr int kMaxDepth = 8;    // passes a block per exchange, at most
constexpr int kGatherBatch = 4; // halo words a thread has in flight
// polls of one word before the launch traps: ~1.7 * 10^7 L2 round trips,
// seconds, where a neighbour is at most one group of passes (microseconds)
// behind
constexpr int kMaxPolls = 1 << 24;

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

// a state value as the payload of an exchange word, and back
__device__ __forceinline__ unsigned to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned to_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
template <typename S>
__device__ __forceinline__ S from_bits(unsigned b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(unsigned b) {
  return __ushort_as_bfloat16((unsigned short)b);
}

// An exchange word, stored and loaded whole at device scope: a relaxed
// 8-byte access is single-copy atomic, and the asm keeps the poll's load in
// its loop.
__device__ __forceinline__ void xput(unsigned long long* p, unsigned payload, unsigned tag) {
  const unsigned long long v = ((unsigned long long)tag << 32) | payload;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long xget(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned tag_of(unsigned long long v) { return (unsigned)(v >> 32); }

template <typename S, bool Bf16, bool Folded, bool Ring, bool Rank2>
struct Variant {
  using State = S;
  // what a stage takes: bfloat16 for v7's bfloat16 arithmetic, else float
  using Value = typename std::conditional<Bf16, __nv_bfloat16, float>::type;
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
__device__ __forceinline__ __nv_bfloat16 stage(__nv_bfloat16 lo, __nv_bfloat16 mid,
                                               __nv_bfloat16 hi) {
  const __nv_bfloat16 quarter = __float2bfloat16_rn(0.25f);
  const __nv_bfloat16 half = __float2bfloat16_rn(0.5f);
  return __hadd(__hmul(quarter, __hadd(lo, hi)), __hmul(half, mid));
}

template <typename V>
__device__ __forceinline__ typename V::Value value(typename V::State s) {
  if constexpr (V::kBf16) return s;
  else return to_f(s);
}

template <typename V>
__device__ __forceinline__ typename V::Value vstage(typename V::Value lo, typename V::Value mid,
                                                    typename V::Value hi) {
  if constexpr (V::kBf16) return stage(lo, mid, hi);
  else return stage<V::kFolded>(lo, mid, hi);
}

// The value of a cell from the vertical stages of the columns to its right,
// its own and to its left; `mask` is the cell's interior mask (masked
// variants), `ring` whether it lies on the pad ring (ring variants).
template <typename V>
__device__ __forceinline__ typename V::State finish(typename V::Value right,
                                                    typename V::Value mid,
                                                    typename V::Value left,
                                                    typename V::State mask, bool ring) {
  using S = typename V::State;
  if constexpr (V::kBf16) {
    return ring ? __float2bfloat16_rn(0.0f) : stage(right, mid, left);
  } else {
    float acc = stage<V::kFolded>(right, mid, left);
    if (!V::kFolded) acc = acc * 0.0625f;
    if (V::kRing) return from_f<S>(ring ? 0.0f : acc);
    return from_f<S>(acc * to_f(mask));
  }
}

// The strips of a pass's region at each margin d < k, for a full tile: the
// count that gives a thread the fewest rows to walk, each strip costing two
// rows more than it has (its window's first two rows). A short last tile
// takes the full tile's counts: only the time depends on them.
struct Strips {
  int n[kMaxDepth];
};

inline Strips plan_strips(int th, int tw, int hw, int k, int threads) {
  Strips s{};
  for (int d = 0; d < k; ++d) {
    const int rows = th + 2 * d, width = tw + 2 * d * hw;
    int best_cost = 0x7fffffff;
    for (int ns = 1; ns <= rows && ns <= threads; ++ns) {
      const int cost = (width * ns + threads - 1) / threads * ((rows + ns - 1) / ns + 2);
      if (cost < best_cost) s.n[d] = ns, best_cost = cost;
    }
  }
  return s;
}

// Shared memory: two state buffers of (th + 2k) x (tw + 2k hw), then, unless
// the variant zeroes a ring, the mask over (th + 2k - 2) x (tw + 2(k-1) hw):
// every cell a pass of a group computes.
// Exchange words (unsigned 64-bit), one copy per parity of the exchange:
//   xrow[parity][plane][tile row][0 = first k rows, 1 = last k][k][w]
//   xcol[parity][plane][tile column][0 = first k hw columns, 1 = last][k hw][h]
// For kRank2 the image is one (h, w) = (h, w*C) plane and hw = C; otherwise
// it is (planes, h, w) and hw = 1. A cell (r, c) of the tile, -k <= r <
// eh + k and -k hw <= c < ew + k hw, is cur[(r + k) sw + c + k hw].
template <typename T, typename V>
__global__ void __launch_bounds__(kResidentMaxThreads, 1)
resident_kernel(const T* __restrict__ img, const T* __restrict__ interior,
                T* __restrict__ out, unsigned long long* xrow, unsigned long long* xcol,
                int h, int w, int hw_arg, int th, int tw, int h0, int w0, int num_passes,
                int k, unsigned tag0, Strips strips) {
  using S = typename V::State;
  using W = typename V::Value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = V::kRank2 ? hw_arg : 1;
  const int khw = k * hw;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ntx = gridDim.x, nty = gridDim.y, np = gridDim.z;
  const int tx = blockIdx.x, ty = blockIdx.y, pl = blockIdx.z;
  const int r0 = ty * th, c0 = tx * tw;
  const int eh = min(th, h - r0), ew = min(tw, w - c0);  // this tile's extent
  const int sw = tw + 2 * khw;                            // shared row stride
  const int mw = sw - 2 * hw;                             // the mask's row stride
  const int plane = (th + 2 * k) * sw;
  S* cur = reinterpret_cast<S*>(smem_raw);
  S* nxt = cur + plane;
  S* m = nxt + plane;
  const int origin = k * sw + khw;              // cell (0, 0)
  const int morigin = (k - 1) * mw + khw - hw;  // its mask

  // the tile and its halo, and the mask over every cell a pass computes
  const T* gplane = img + (size_t)pl * h * w;
  {
    const int lw = ew + 2 * khw;
    const float inv_lw = 1.0f / lw;
    for (int idx = tid; idx < (eh + 2 * k) * lw; idx += nthreads) {
      const int r = div_small(idx, inv_lw);
      const int c = idx - r * lw;
      cur[r * sw + c] =
          from_f<S>(ld(gplane + (size_t)wrap(r0 - k + r, h) * w + wrap(c0 - khw + c, w)));
    }
  }
  if (!V::kRing) {
    const int lw = ew + 2 * (khw - hw);
    const float inv_lw = 1.0f / lw;
    for (int idx = tid; idx < (eh + 2 * k - 2) * lw; idx += nthreads) {
      const int r = div_small(idx, inv_lw);
      const int c = idx - r * lw;
      m[r * mw + c] = from_f<S>(
          ld(interior + (size_t)wrap(r0 - k + 1 + r, h) * w + wrap(c0 - khw + hw + c, w)));
    }
  }
  __syncthreads();

  const size_t xrow_parity = (size_t)np * nty * 2 * k * w;
  const size_t xcol_parity = (size_t)np * ntx * 2 * khw * h;
  const int ty_up = (ty + nty - 1) % nty, ty_down = (ty + 1) % nty;
  const int tx_left = (tx + ntx - 1) % ntx, tx_right = (tx + 1) % ntx;
  const S zero = from_f<S>(0.0f);
  unsigned tag = tag0;

  for (int done = 0; done < num_passes;) {
    const int g = min(k, num_passes - done);
    // pass d = g-1 .. 0 computes rows -d .. eh+d-1 and columns -d hw .. ew+d hw-1
    for (int d = g - 1; d >= 0; --d) {
      const int cols = ew + 2 * d * hw;
      const int ns = strips.n[d];
      const int srows = (th + 2 * d + ns - 1) / ns;
      // a thread a (column, strip), its 3x3 window in registers
      for (int item = tid; item < cols * ns; item += nthreads) {
        const int strip = item / cols;
        const int c = item - strip * cols - d * hw;
        const int rs = strip * srows - d;
        const int re = min(rs + srows, eh + d);
        const S* p = cur + origin + (rs - 1) * sw + c;  // the row above the strip
        // the window: (left, mid, right) of the row above and of the row
        W ul = value<V>(p[-hw]), um = value<V>(p[0]), ur = value<V>(p[hw]);
        p += sw;
        W ml = value<V>(p[-hw]), mm = value<V>(p[0]), mr = value<V>(p[hw]);
        bool col_ring = false;
        int gr = 0;
        if (V::kRing) {
          const int gc = wrap(c0 + c, w);
          col_ring = gc == 0 || gc > w0;
          gr = wrap(r0 + rs, h);
        }
        S* q = nxt + origin + rs * sw + c;
        const S* mk = m + morigin + rs * mw + c;
#pragma unroll 3
        for (int r = rs; r < re; ++r) {
          p += sw;  // the row below
          const W dl = value<V>(p[-hw]), dm = value<V>(p[0]), dr = value<V>(p[hw]);
          const bool ring = V::kRing && (col_ring || gr == 0 || gr > h0);
          if (V::kRing && ++gr == h) gr = 0;
          *q = finish<V>(vstage<V>(dr, mr, ur), vstage<V>(dm, mm, um), vstage<V>(dl, ml, ul),
                         V::kRing ? zero : *mk, ring);
          q += sw;
          mk += mw;
          ul = ml, um = mm, ur = mr;
          ml = dl, mm = dm, mr = dr;
        }
      }
      __syncthreads();
      S* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    done += g;
    if (done == num_passes) break;

    ++tag;
    unsigned long long* xr = xrow + (tag & 1) * xrow_parity;
    unsigned long long* xc = xcol + (tag & 1) * xcol_parity;
    // this tile's first and last k rows, then its first and last k hw columns
    {
      unsigned long long* mine = xr + (size_t)(pl * nty + ty) * 2 * k * w + c0;
      const float inv_ew = 1.0f / ew;
      for (int idx = tid; idx < 2 * k * ew; idx += nthreads) {
        const int i = div_small(idx, inv_ew), c = idx - i * ew;  // i = side k + row
        const int r = i < k ? i : eh - 2 * k + i;
        xput(mine + (size_t)i * w + c, to_bits(cur[origin + r * sw + c]), tag);
      }
    }
    {
      unsigned long long* mine = xc + (size_t)(pl * ntx + tx) * 2 * khw * h + r0;
      for (int idx = tid; idx < 2 * khw * eh; idx += nthreads) {
        const int i = idx / eh, r = idx - i * eh;  // i = side k hw + column
        const int c = i < khw ? i : ew - 2 * khw + i;
        xput(mine + (size_t)i * h + r, to_bits(cur[origin + r * sw + c]), tag);
      }
    }
    // the halo, word by word as each arrives: the last k rows of the tile row
    // above and the first k of the one below, across this tile's columns and
    // k hw more a side (corners included: the rows span the width), then the
    // last k hw columns of the tile column to the left and the first k hw of
    // the one to the right
    const int lw = ew + 2 * khw;
    const int n_rows = 2 * k * lw, n_words = n_rows + 2 * khw * eh;
    const unsigned long long* above = xr + ((size_t)(pl * nty + ty_up) * 2 + 1) * k * w;
    const unsigned long long* below = xr + (size_t)(pl * nty + ty_down) * 2 * k * w;
    const unsigned long long* left =
        xc + ((size_t)(pl * ntx + tx_left) * 2 + 1) * khw * h + r0;
    const unsigned long long* right = xc + (size_t)(pl * ntx + tx_right) * 2 * khw * h + r0;
    const float inv_lw = 1.0f / lw;
    auto word = [&](int idx, S*& dst) -> const unsigned long long* {
      if (idx < n_rows) {
        const int i = div_small(idx, inv_lw), c = idx - i * lw;  // i = side k + row
        const int gc = wrap(c0 - khw + c, w);
        if (i < k) {
          dst = cur + (i * sw + c);  // row i - k
          return above + (size_t)i * w + gc;
        }
        dst = cur + ((eh + i) * sw + c);  // row eh + i - k
        return below + (size_t)(i - k) * w + gc;
      }
      idx -= n_rows;
      const int i = idx / eh, r = idx - i * eh;  // i = side k hw + column
      if (i < khw) {
        dst = cur + (origin + r * sw - khw + i);
        return left + (size_t)i * h + r;
      }
      dst = cur + (origin + r * sw + ew + i - khw);
      return right + (size_t)(i - khw) * h + r;
    };
    for (int base = tid; base < n_words; base += kGatherBatch * nthreads) {
      const unsigned long long* src[kGatherBatch];
      S* dst[kGatherBatch];
      unsigned long long v[kGatherBatch];
#pragma unroll
      for (int b = 0; b < kGatherBatch; ++b) {
        const int idx = base + b * nthreads;
        if (idx < n_words) {
          src[b] = word(idx, dst[b]);
          v[b] = xget(src[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kGatherBatch; ++b) {
        if (base + b * nthreads < n_words) {
          for (int polls = 0; tag_of(v[b]) != tag; v[b] = xget(src[b]))
            if (++polls > kMaxPolls) __trap();
          *dst[b] = from_bits<S>((unsigned)v[b]);
        }
      }
    }
    __syncthreads();
  }

  T* oplane = out + (size_t)pl * h * w;
  const float inv_ew = 1.0f / ew;
  for (int idx = tid; idx < eh * ew; idx += nthreads) {
    const int r = div_small(idx, inv_ew);
    const int c = idx - r * ew;
    st(oplane + (size_t)(r0 + r) * w + c0 + c, to_f(cur[origin + r * sw + c]));
  }
}

// Mirrored by blur_resident_opt.resident_bytes on the Python side.
template <typename V>
size_t resident_smem_bytes(int th, int tw, int hw, int k) {
  const size_t plane = (size_t)(th + 2 * k) * (tw + 2 * k * hw);
  const size_t mask = (size_t)(th + 2 * k - 2) * (tw + 2 * (k - 1) * hw);
  return sizeof(typename V::State) * (2 * plane + (V::kRing ? 0 : mask));
}

// c: channels. For kRank2 the image is (h, w) with w = the flat width and
// c the column step; otherwise it is (c, h, w). k: passes a block runs per
// exchange; tag0: the tag of the exchange before the launch's first.
template <typename T, typename V>
int launch_resident(const void* img, const void* interior, void* out, void* xrow, void* xcol,
                    int c, int h, int w, int th, int tw, int h0, int w0, int num_passes,
                    int k, unsigned tag0, int threads, cudaStream_t stream) {
  const int hw = V::kRank2 ? c : 1;
  const int planes = V::kRank2 ? 1 : c;
  if (threads < 32 || threads > kResidentMaxThreads || c < 1 || h < 1 || w < 1 || th < 1 ||
      tw < hw || num_passes < 0 || k < 1 || k > kMaxDepth || tw + 2 * k * hw > kMaxRow ||
      (th + 2 * k) * (tw + 2 * k * hw) >= 65536)
    return kBadArgument;
  const int ntx = (w + tw - 1) / tw, nty = (h + th - 1) / th;
  // the last tile row and column hold the halo: k rows, k hw columns
  if (h - (nty - 1) * th < k || w - (ntx - 1) * tw < k * hw) return kBadArgument;
  int device = 0, cooperative = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!cooperative) return kNoCooperativeLaunch;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = resident_smem_bytes<V>(th, tw, hw, k);
  err = cudaFuncSetAttribute(resident_kernel<T, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel<T, V>,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ntx, nty, planes);
  // a block that waits on a neighbour that is not resident waits forever
  if ((long long)grid.x * grid.y * grid.z > (long long)per_sm * sms) return kNotCoResident;

  const T* img_t = static_cast<const T*>(img);
  const T* interior_t = static_cast<const T*>(interior);
  T* out_t = static_cast<T*>(out);
  auto* xrow_w = static_cast<unsigned long long*>(xrow);
  auto* xcol_w = static_cast<unsigned long long*>(xcol);
  int hw_arg = hw;
  Strips strips = plan_strips(th, tw, hw, k, threads);
  void* args[] = {&img_t, &interior_t, &out_t, &xrow_w, &xcol_w, &h, &w, &hw_arg,
                  &th, &tw, &h0, &w0, &num_passes, &k, &tag0, &strips};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(resident_kernel<T, V>), grid,
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

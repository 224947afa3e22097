// The D2Q9 step code shared by the K-step kernels of csrc/d2q9_kstep.cu (B1,
// B2) and csrc/d2q9_manual.cu (B3): the window and tile geometry, one cell of
// collide_fields, the flags of a tile's region, one step over a region in
// shared memory, and the fixed-order block reduction. Kernels that use the
// same code on the same tile give the same bits.
//
// A tile is th x tw cells of the grid, taken in row-major tile order; the
// tiles of the last row and column are cut to what is left of the grid (edge
// tiles). A tile's region is its interior plus a K-cell halo on all four
// sides, at periodic (wrapped) grid indices. Step j updates the region rows
// [j, rh - j) x columns [j, rw - j), so after K steps the interior is exact.
//
// Types: the lattice in device memory is of the storage type S (float,
// double or bfloat16), the steps run in C = storage::Compute<S>::type, and
// the region buffers in shared memory hold C (csrc/storage.cuh). A value is
// rounded to S only where it leaves for device memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace d2q9 {

constexpr int kThreads = 256;  // threads per block, over the flattened region
constexpr int kWarps = kThreads / 32;

// Diagnostic modes of the K-step kernels (the TPU kernels' `mode`):
// kFull is the production step; kStreamOnly streams without bounce-back or
// collision and counts the rest-speed plane as |u|; kCopy loads the region
// and stores the interior unchanged, with a Sum|u| of zeros (a token).
enum Mode { kFull = 0, kStreamOnly = 1, kCopy = 2 };

struct Window {
  int row_offset, valid_lo, valid_hi, global_ny, col_lo, col_hi;
};

template <typename T>
struct Coef {
  T omega, one_minus_omega, w1, w2;
};

struct Tiles {
  int ny, nx, th, tw, k;
  __host__ __device__ int nty() const { return (ny + th - 1) / th; }
  __host__ __device__ int ntx() const { return (nx + tw - 1) / tw; }
  // region of a full tile: the layout of a shared-memory buffer
  __host__ __device__ int full_plane() const { return (th + 2 * k) * (tw + 2 * k); }
};

// One tile's place and region. Edge tiles have th/tw below the Tiles'.
struct Region {
  int ty, tx, r0, c0, th, tw, rh, rw, plane;
};

// Whether the grid has edge tiles, i.e. tiles that its last row or column
// cuts. Kernels are instantiated for both values and launched with this one:
// with the extents computed by min() for every tile, B1 and B2 ran measurably
// slower on an H100 than with the Tiles' own (PERF.md), so a grid that
// the tile divides keeps the plain extents.
__host__ __device__ inline bool has_edges(const Tiles& t) {
  return t.ny % t.th != 0 || t.nx % t.tw != 0;
}

// The region of tile (ty, tx); kEdge must be has_edges(t).
template <bool kEdge>
__device__ __forceinline__ Region region_of(const Tiles& t, int ty, int tx) {
  Region g;
  g.ty = ty;
  g.tx = tx;
  g.r0 = ty * t.th;
  g.c0 = tx * t.tw;
  g.th = kEdge ? min(t.th, t.ny - g.r0) : t.th;
  g.tw = kEdge ? min(t.tw, t.nx - g.c0) : t.tw;
  g.rh = g.th + 2 * t.k;
  g.rw = g.tw + 2 * t.k;
  g.plane = g.rh * g.rw;
  return g;
}

__device__ __forceinline__ int wrap(int x, int n) {
  int m = x % n;
  return m < 0 ? m + n : m;
}

// idx / w for 0 <= idx < 2^20 and w > 0, with inv_w = 1.0f / w:
// (idx + 0.5) / w lies at least 0.5/w from an integer, and the float
// rounding of inv_w and of the product is below 2^-3/w, so truncation gives
// the quotient.
__device__ __forceinline__ int div_small(int idx, float inv_w) {
  return (int)((float(idx) + 0.5f) * inv_w);
}

// One cell of collide_fields: s are the nine pulled values, out the nine
// post-collision values; returns |u| (0 on obstacles). kRecip is
// collide_fields' shared_reciprocal: 1/rho once and two products, in place
// of two divisions by rho.
template <typename T, bool kRecip = false>
__device__ __forceinline__ T collide_cell(const T s[9], bool obstacle,
                                          bool accel, const Coef<T>& p,
                                          T out[9]) {
  const T rho = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7] + s[8];
  T u_x, u_y;
  if constexpr (kRecip) {
    const T inv_rho = T(1.0) / rho;
    u_x = (s[1] + s[5] + s[8] - (s[3] + s[6] + s[7])) * inv_rho;
    u_y = (s[2] + s[5] + s[6] - (s[4] + s[7] + s[8])) * inv_rho;
  } else {
    u_x = (s[1] + s[5] + s[8] - (s[3] + s[6] + s[7])) / rho;
    u_y = (s[2] + s[5] + s[6] - (s[4] + s[7] + s[8])) / rho;
  }
  const T u_sq = u_x * u_x + u_y * u_y;

  const T c_sq = T(1.0) - u_sq * T(1.5);
  const T ld0 = T(4.0 / 9.0) * rho * p.omega;
  const T ld1 = rho / T(9.0) * p.omega;
  const T ld2 = rho / T(36.0) * p.omega;
  const T u_s = u_x + u_y;
  const T u_d = -u_x + u_y;

  const T tt = T(2.0 / 3.0);
  const T omo = p.one_minus_omega;
  T o0 = s[0] * omo + ld0 * c_sq;
  T o1 = s[1] * omo + ld1 * ((T(4.5) * u_x) * (tt + u_x) + c_sq);
  T o2 = s[2] * omo + ld1 * ((T(4.5) * u_y) * (tt + u_y) + c_sq);
  T o3 = s[3] * omo + ld1 * ((T(-4.5) * u_x) * (tt - u_x) + c_sq);
  T o4 = s[4] * omo + ld1 * ((T(-4.5) * u_y) * (tt - u_y) + c_sq);
  T o5 = s[5] * omo + ld2 * ((T(4.5) * u_s) * (tt + u_s) + c_sq);
  T o6 = s[6] * omo + ld2 * ((T(4.5) * u_d) * (tt + u_d) + c_sq);
  T o7 = s[7] * omo + ld2 * ((T(-4.5) * u_s) * (tt - u_s) + c_sq);
  T o8 = s[8] * omo + ld2 * ((T(-4.5) * u_d) * (tt - u_d) + c_sq);
  if (accel) {
    o1 = o1 + p.w1;
    o3 = o3 - p.w1;
    o5 = o5 + p.w2;
    o6 = o6 - p.w2;
    o7 = o7 - p.w2;
    o8 = o8 + p.w2;
  }
  if (obstacle) {
    out[0] = s[0]; out[1] = s[3]; out[2] = s[4]; out[3] = s[1]; out[4] = s[2];
    out[5] = s[7]; out[6] = s[8]; out[7] = s[5]; out[8] = s[6];
    return T(0);
  }
  out[0] = o0; out[1] = o1; out[2] = o2; out[3] = o3; out[4] = o4;
  out[5] = o5; out[6] = o6; out[7] = o7; out[8] = o8;
  return sqrt(u_sq);
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T acc = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) acc += red[w];
  return acc;
}

// Row and column flags of the region, kept in shared memory.
constexpr uint8_t kAccelRow = 1;  // row receives the body force
constexpr uint8_t kCounts = 2;    // row / column is inside tile and window

__device__ __forceinline__ void set_flags(const Tiles& t, const Region& g,
                                          const Window& win, int accel_row,
                                          uint8_t* row_flag, uint8_t* col_flag) {
  const int k = t.k;
  for (int r = threadIdx.x; r < g.rh; r += kThreads) {
    const int lrow = g.r0 - k + r;  // local row, unwrapped as on the TPU
    uint8_t flag = wrap(lrow + win.row_offset, win.global_ny) == accel_row ? kAccelRow : 0;
    if (r >= k && r < k + g.th && lrow >= win.valid_lo && lrow < win.valid_hi) flag |= kCounts;
    row_flag[r] = flag;
  }
  for (int c = threadIdx.x; c < g.rw; c += kThreads) {
    const int lcol = g.c0 - k + c;
    col_flag[c] = (c >= k && c < k + g.tw && lcol >= win.col_lo && lcol < win.col_hi)
                      ? kCounts : 0;
  }
}

// Step j (1..K) of a region held in shared memory as 9 planes of rh x rw
// values (src) with its mask m: every cell of rows [j, rh - j) x columns
// [j, rw - j) pulls from its neighbours in src, collides (kFull) or not
// (kStreamOnly), and is stored to dst, a buffer of the region's layout, or
// with kToDevice (the last step, whose region is the tile) to the (9, ny, nx)
// state dst in device memory. Returns this thread's share of Sum|u| over the
// cells that count. (The store is chosen by template, not passed as a
// lambda, which ran measurably slower on an H100; PERF.md.) Src and Dst are
// the types of src and dst (C in shared memory; B3's first step reads its
// staged region in the storage type, a last step to device memory rounds to
// it); the step runs in T.
template <typename Src, typename Dst, typename T, int kMode, bool kToDevice,
          bool kRecip = false>
__device__ __forceinline__ T step_region(const Src* src, Dst* dst, const uint8_t* m,
                                         const uint8_t* row_flag, const uint8_t* col_flag,
                                         const Tiles& t, const Region& g, int j,
                                         const Coef<T>& p) {
  const int rw = g.rw, plane = g.plane;
  const int h = g.rh - 2 * j, w = rw - 2 * j;
  const float inv_w = 1.0f / w;
  T acc = T(0);
  for (int idx = threadIdx.x; idx < h * w; idx += kThreads) {
    const int rr = div_small(idx, inv_w);
    const int r = j + rr, c = j + idx - rr * w;
    const int mid = r * rw + c, up = mid - rw, down = mid + rw;
    using storage::load;
    T s[9];
    s[0] = load(src[0 * plane + mid]);
    s[1] = load(src[1 * plane + mid - 1]);   // east: from the west
    s[2] = load(src[2 * plane + up]);        // north: from the south
    s[3] = load(src[3 * plane + mid + 1]);   // west: from the east
    s[4] = load(src[4 * plane + down]);      // south: from the north
    s[5] = load(src[5 * plane + up - 1]);    // north-east
    s[6] = load(src[6 * plane + up + 1]);    // north-west
    s[7] = load(src[7 * plane + down + 1]);  // south-west
    s[8] = load(src[8 * plane + down - 1]);  // south-east
    T o[9];
    const uint8_t rf = row_flag[r];
    T u;
    if constexpr (kMode == kStreamOnly) {
#pragma unroll
      for (int q = 0; q < 9; ++q) o[q] = s[q];
      u = s[0];
    } else {
      u = collide_cell<T, kRecip>(s, m[mid] != 0, (rf & kAccelRow) != 0, p, o);
    }
    if constexpr (kToDevice) {
      const size_t gplane = (size_t)t.ny * t.nx;
      const size_t gi = (size_t)(g.r0 + r - t.k) * t.nx + (g.c0 + c - t.k);
#pragma unroll
      for (int q = 0; q < 9; ++q) storage::put(dst[q * gplane + gi], o[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 9; ++q) storage::put(dst[q * plane + mid], o[q]);
    }
    if (rf & col_flag[c] & kCounts) acc += u;
  }
  return acc;
}

// The interior of the region (after the steps, in buf) to out, masked to the
// grid at an edge tile; rounded to out's type.
template <typename B, typename S>
__device__ __forceinline__ void store_interior(const B* buf, S* out, const Tiles& t,
                                               const Region& g) {
  const size_t gplane = (size_t)t.ny * t.nx;
  const float inv_tw = 1.0f / g.tw;
  const int k = t.k;
  for (int idx = threadIdx.x; idx < g.th * g.tw; idx += kThreads) {
    const int r = div_small(idx, inv_tw);
    const int c = idx - r * g.tw;
    const size_t gi = (size_t)(g.r0 + r) * t.nx + (g.c0 + c);
#pragma unroll
    for (int q = 0; q < 9; ++q)
      storage::put(out[q * gplane + gi], storage::load(buf[q * g.plane + (r + k) * g.rw + (c + k)]));
  }
}

// tot[j] = sum over tiles of partials[j, :], one block per step, fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const T* __restrict__ partials, int ntiles, T* __restrict__ tot) {
  __shared__ T red[kWarps];
  const int j = blockIdx.x;
  T acc = T(0);
  for (int i = threadIdx.x; i < ntiles; i += kThreads)
    acc += partials[(size_t)j * ntiles + i];
  const T s = block_sum<T>(acc, red);
  if (threadIdx.x == 0) tot[j] = s;
}

}  // namespace d2q9

#define D2Q9_ARGS                                                          \
  int ny, int nx, int th, int tw, int k, int row_offset, int valid_lo,     \
      int valid_hi, int global_ny, int col_lo, int col_hi, int accel_row,  \
      int mode, double omega, double w1, double w2, void *stream
#define D2Q9_PASS                                                          \
  d2q9::Tiles{ny, nx, th, tw, k},                                          \
      d2q9::Window{row_offset, valid_lo, valid_hi, global_ny, col_lo, col_hi}, \
      accel_row, mode, omega, w1, w2, static_cast<cudaStream_t>(stream)

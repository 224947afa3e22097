// K fused D2Q9 lattice-Boltzmann steps per launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   B2  lbm_tpu/ops/d2q9_pallas.py          _kernel  (two-stream, in -> out)
//   B1  lbm_tpu/ops/d2q9_pallas_inplace.py  _kernel  (written back in place)
// Both compute, per step: periodic pull streaming, bounce-back on obstacle
// cells, BGK collision in the exact grouping of d2q9.collide_fields (two
// divisions by rho), the accelerated-row force with the row tested as
// (row + row_offset) mod global_ny == accel_row, and |u| zeroed on
// obstacles. They return the state after K steps and, per step, Sum|u| over
// the valid window [valid_lo, valid_hi) x [col_lo, col_hi).
//
// What bounds it on this card: memory. One pass reads 9 values and a 1-byte
// mask per cell and writes 9 values: 73 bytes per cell at f32 for K steps,
// i.e. 73/K bytes per cell-step, against ~94 floating-point operations per
// cell-step. At 3.35 TB/s and 67 TFLOP/s (f32) the bytes dominate up to
// K ~ 13, so the design fuses K steps per pass to divide the traffic by K.
//
// Design. The TPU kernels walk row bands in order on one core and carry the
// Sum|u| across grid steps; neither holds on the card, where blocks run in
// parallel in no order. Here:
//   * one thread block per (row tile, column tile); it loads its tile plus a
//     K-cell halo on all four sides (periodic indices) into shared memory,
//     runs the K steps there between two shared buffers (the step-j region
//     shrinks by one cell per side), and writes only its tile interior. The
//     threads walk each region as one flat range, so a region a little wider
//     than a warp does not leave lanes idle;
//   * each block writes its per-step partial sums to partials[K, nblocks];
//     a second small kernel sums them in a fixed order. No float atomics, so
//     reruns are bit-identical;
//   * B1 (in place): blocks run concurrently, so a block may overwrite its
//     interior before a neighbour has read its halo from it. So the halo
//     comes from a snapshot of the 2K rows (and 2K columns) around every
//     tile boundary, held in side buffers; the main kernel reads its
//     interior from f and its halo from the snapshot, and writes only its
//     own interior back into f. That is safe under any block order. Two
//     small kernels fill the snapshot from f before a first pass; after
//     that each pass writes its tiles' new K-deep rings from shared memory
//     into a second snapshot buffer for the next pass, so a run of passes
//     copies nothing more. Being in place saves the second lattice in
//     memory, not traffic: the ring adds (2K/tile_h + 2K/tile_w) of the
//     lattice, written once and read once per pass.
//   * both kernels share the load-compute-store code and the reduction
//     order, so for the same tiles B1 is bit-identical to B2.
// The library is compiled with -fmad=false: every product, sum and division
// rounds on its own, as in collide_fields. The plain PyTorch version on CUDA
// still differs by about 1e-6 relative in float32 (1e-15 in float64): PyTorch
// divides by a Python scalar as a multiply by its reciprocal. The order of the
// Sum|u| reduction differs too.
//
// Interface: plain C, one entry per (kernel, dtype), each launching on the
// given stream and returning cudaGetLastError() after every launch. The
// kernels allocate nothing; the caller passes every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block, over the flattened region
constexpr int kWarps = kThreads / 32;

struct Window {
  int row_offset, valid_lo, valid_hi, global_ny, col_lo, col_hi;
};

template <typename T>
struct Coef {
  T omega, one_minus_omega, w1, w2;
};

struct Tiles {
  int ny, nx, th, tw, k;
};

__device__ __forceinline__ int wrap(int x, int n) {
  int m = x % n;
  return m < 0 ? m + n : m;
}

// One cell of collide_fields: s are the nine pulled values, out the nine
// post-collision values; returns |u| (0 on obstacles).
template <typename T>
__device__ __forceinline__ T collide_cell(const T s[9], bool obstacle,
                                          bool accel, const Coef<T>& p,
                                          T out[9]) {
  const T rho = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7] + s[8];
  const T u_x = (s[1] + s[5] + s[8] - (s[3] + s[6] + s[7])) / rho;
  const T u_y = (s[2] + s[5] + s[6] - (s[4] + s[7] + s[8])) / rho;
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

// idx / w for 0 <= idx < 2^16 and 0 < w < 2^10, with inv_w = 1.0f / w:
// (idx + 0.5) / w lies at least 0.5/w from an integer, far more than the
// float rounding error of the product, so truncation gives the quotient.
__device__ __forceinline__ int div_small(int idx, float inv_w) {
  return (int)((float(idx) + 0.5f) * inv_w);
}

// Where the nine values of region cell (r, c) come from: speed q is at
// base[q * stride]. f for the tile interior (and the whole region in B2);
// in place, the boundary snapshot for the halo. Only the address is chosen
// per cell, so a warp that mixes interior and halo cells issues its nine
// loads together instead of once per branch.
template <typename T, bool kInPlace>
__device__ __forceinline__ const T* cell_source(const T* f, const T* hband,
                                                const T* vband, const Tiles& t,
                                                int r, int c, int gr, int gc,
                                                size_t& stride) {
  stride = (size_t)t.ny * t.nx;
  const T* base = f + (size_t)gr * t.nx + gc;
  if (kInPlace) {
    const int k = t.k, two_k = 2 * k;
    if (r < k || r >= k + t.th) {
      // rows around a horizontal tile boundary: hband[b][q][i][x] holds row
      // (b*th - k + i) mod ny
      const int nty = t.ny / t.th;
      const int b = r < k ? (int)blockIdx.y : ((int)blockIdx.y + 1) % nty;
      const int i = r < k ? r : r - t.th;
      base = hband + ((size_t)b * 9 * two_k + i) * t.nx + gc;
      stride = (size_t)two_k * t.nx;
    } else if (c < k || c >= k + t.tw) {
      // columns around a vertical tile boundary: vband[b][q][y][i] holds
      // column (b*tw - k + i) mod nx
      const int ntx = t.nx / t.tw;
      const int b = c < k ? (int)blockIdx.x : ((int)blockIdx.x + 1) % ntx;
      const int i = c < k ? c : c - t.tw;
      base = vband + ((size_t)b * 9 * t.ny + gr) * two_k + i;
      stride = (size_t)t.ny * two_k;
    }
  }
  return base;
}

// Row and column flags of the region, kept in shared memory.
constexpr uint8_t kAccelRow = 1;  // row receives the body force
constexpr uint8_t kCounts = 2;    // row / column is inside tile and window

template <typename T, bool kInPlace>
__global__ void __launch_bounds__(kThreads)
kstep_kernel(const T* f, const uint8_t* __restrict__ mask, T* out,
             const T* __restrict__ hband, const T* __restrict__ vband,
             T* __restrict__ next_hband, T* __restrict__ next_vband,
             T* __restrict__ partials, Tiles t, Window win, int accel_row,
             Coef<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = t.k;
  const int rh = t.th + 2 * k;
  const int rw = t.tw + 2 * k;
  const int plane = rh * rw;
  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_b = buf_a + 9 * plane;
  T* red = buf_b + 9 * plane;  // 2 * kWarps, alternating by step parity
  uint8_t* m = reinterpret_cast<uint8_t*>(red + 2 * kWarps);
  uint8_t* row_flag = m + plane;
  uint8_t* col_flag = row_flag + rh;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * t.th;
  const int c0 = blockIdx.x * t.tw;
  const int nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;

  for (int r = tid; r < rh; r += kThreads) {
    const int lrow = r0 - k + r;  // local row, unwrapped as on the TPU
    uint8_t flag = wrap(lrow + win.row_offset, win.global_ny) == accel_row ? kAccelRow : 0;
    if (r >= k && r < k + t.th && lrow >= win.valid_lo && lrow < win.valid_hi) flag |= kCounts;
    row_flag[r] = flag;
  }
  for (int c = tid; c < rw; c += kThreads) {
    const int lcol = c0 - k + c;
    col_flag[c] = (c >= k && c < k + t.tw && lcol >= win.col_lo && lcol < win.col_hi)
                      ? kCounts : 0;
  }
  const float inv_rw = 1.0f / rw;
  for (int idx = tid; idx < plane; idx += kThreads) {
    const int r = div_small(idx, inv_rw);
    const int c = idx - r * rw;
    const int gr = wrap(r0 - k + r, t.ny);
    const int gc = wrap(c0 - k + c, t.nx);
    m[idx] = mask[(size_t)gr * t.nx + gc];
    size_t stride;
    const T* src = cell_source<T, kInPlace>(f, hband, vband, t, r, c, gr, gc, stride);
#pragma unroll
    for (int q = 0; q < 9; ++q) buf_a[q * plane + idx] = src[q * stride];
  }
  __syncthreads();

  T* src = buf_a;
  T* dst = buf_b;
  for (int j = 1; j <= k; ++j) {
    // step j updates the region rows [j, rh - j) x columns [j, rw - j)
    const int h = rh - 2 * j, w = rw - 2 * j;
    const float inv_w = 1.0f / w;
    T acc = T(0);
    for (int idx = tid; idx < h * w; idx += kThreads) {
      const int rr = div_small(idx, inv_w);
      const int r = j + rr, c = j + idx - rr * w;
      const int mid = r * rw + c, up = mid - rw, down = mid + rw;
      T s[9];
      s[0] = src[0 * plane + mid];
      s[1] = src[1 * plane + mid - 1];   // east: from the west
      s[2] = src[2 * plane + up];        // north: from the south
      s[3] = src[3 * plane + mid + 1];   // west: from the east
      s[4] = src[4 * plane + down];      // south: from the north
      s[5] = src[5 * plane + up - 1];    // north-east
      s[6] = src[6 * plane + up + 1];    // north-west
      s[7] = src[7 * plane + down + 1];  // south-west
      s[8] = src[8 * plane + down - 1];  // south-east
      T o[9];
      const uint8_t rf = row_flag[r];
      const T u = collide_cell<T>(s, m[mid] != 0, (rf & kAccelRow) != 0, p, o);
#pragma unroll
      for (int q = 0; q < 9; ++q) dst[q * plane + mid] = o[q];
      if (rf & col_flag[c] & kCounts) acc += u;
    }
    // the barrier inside block_sum also orders this step's writes of dst
    // before the next step's reads
    const T tot = block_sum<T>(acc, red + (j & 1) * kWarps);
    if (tid == 0) partials[(size_t)(j - 1) * nblocks + bid] = tot;
    T* tmp = src;
    src = dst;
    dst = tmp;
  }

  const size_t gplane = (size_t)t.ny * t.nx;
  const float inv_tw = 1.0f / t.tw;
  for (int idx = tid; idx < t.th * t.tw; idx += kThreads) {
    const int r = div_small(idx, inv_tw);
    const int c = idx - r * t.tw;
    const size_t g = (size_t)(r0 + r) * t.nx + (c0 + c);
#pragma unroll
    for (int q = 0; q < 9; ++q) out[q * gplane + g] = src[q * plane + (r + k) * rw + (c + k)];
  }
  if (!kInPlace || next_hband == nullptr) return;

  // Chained snapshot for the next in-place pass: this tile's new K-deep
  // ring, straight from shared memory, into the layout cell_source reads
  // (needs th >= k and tw >= k). Top rows go to boundary ty, bottom rows
  // to boundary ty + 1; left columns to boundary tx, right ones to tx + 1.
  const int two_k = 2 * k;
  const int nty = t.ny / t.th, ntx = t.nx / t.tw;
  for (int idx = tid; idx < two_k * t.tw; idx += kThreads) {
    const int rr = div_small(idx, inv_tw);
    const int c = idx - rr * t.tw;
    const bool top = rr < k;
    const int ir = top ? rr : t.th - two_k + rr;  // interior row
    const int b = top ? (int)blockIdx.y : ((int)blockIdx.y + 1) % nty;
    const int i = top ? k + rr : rr - k;
    T* dst = next_hband + ((size_t)b * 9 * two_k + i) * t.nx + c0 + c;
#pragma unroll
    for (int q = 0; q < 9; ++q)
      dst[(size_t)q * two_k * t.nx] = src[q * plane + (ir + k) * rw + (c + k)];
  }
  const float inv_two_k = 1.0f / two_k;
  for (int idx = tid; idx < t.th * two_k; idx += kThreads) {
    const int r = div_small(idx, inv_two_k);
    const int cc = idx - r * two_k;
    const bool left = cc < k;
    const int ic = left ? cc : t.tw - two_k + cc;  // interior column
    const int b = left ? (int)blockIdx.x : ((int)blockIdx.x + 1) % ntx;
    const int i = left ? k + cc : cc - k;
    T* dst = next_vband + ((size_t)b * 9 * t.ny + r0 + r) * two_k + i;
#pragma unroll
    for (int q = 0; q < 9; ++q)
      dst[(size_t)q * t.ny * two_k] = src[q * plane + (r + k) * rw + (ic + k)];
  }
}

// tot[j] = sum over blocks of partials[j, :], one block per step, fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const T* __restrict__ partials, int nblocks,
                    T* __restrict__ tot) {
  __shared__ T red[kWarps];
  const int j = blockIdx.x;
  T acc = T(0);
  for (int i = threadIdx.x; i < nblocks; i += kThreads)
    acc += partials[(size_t)j * nblocks + i];
  const T s = block_sum<T>(acc, red);
  if (threadIdx.x == 0) tot[j] = s;
}

// In-place snapshot, rows: hband row (b*9 + q)*2k + i is row
// (b*th - k + i) mod ny of plane q (see cell_source).
template <typename T>
__global__ void snapshot_rows_kernel(const T* __restrict__ f,
                                     T* __restrict__ hband, Tiles t) {
  const int two_k = 2 * t.k;
  const int nrows = (t.ny / t.th) * 9 * two_k;
  for (int row = blockIdx.y; row < nrows; row += gridDim.y) {
    const int i = row % two_k, bq = row / two_k, q = bq % 9, b = bq / 9;
    const T* src = f + ((size_t)q * t.ny + wrap(b * t.th - t.k + i, t.ny)) * t.nx;
    T* dst = hband + (size_t)row * t.nx;
    for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < t.nx;
         x += gridDim.x * blockDim.x)
      dst[x] = src[x];
  }
}

// In-place snapshot, columns: vband[(b*9 + q)][y][i] is column
// (b*tw - k + i) mod nx of row y of plane q.
template <typename T>
__global__ void snapshot_cols_kernel(const T* __restrict__ f,
                                     T* __restrict__ vband, Tiles t) {
  const int two_k = 2 * t.k;
  const int n = t.ny * two_k;
  for (int bq = blockIdx.y; bq < (t.nx / t.tw) * 9; bq += gridDim.y) {
    const int q = bq % 9, b = bq / 9;
    const T* src = f + (size_t)q * t.ny * t.nx;
    T* dst = vband + (size_t)bq * n;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
         idx += gridDim.x * blockDim.x) {
      const int y = idx / two_k, i = idx - y * two_k;
      dst[idx] = src[(size_t)y * t.nx + wrap(b * t.tw - t.k + i, t.nx)];
    }
  }
}

// Mirrored by d2q9_kstep.smem_bytes on the Python side.
size_t smem_bytes(const Tiles& t, size_t itemsize) {
  const size_t rh = t.th + 2 * t.k, rw = t.tw + 2 * t.k;
  return 2 * 9 * rh * rw * itemsize + 2 * kWarps * itemsize + rh * rw + rh + rw;
}

template <typename T, bool kInPlace>
int launch(const void* f, const void* mask, void* out, const void* hband,
           const void* vband, void* next_hband, void* next_vband,
           void* partials, void* tot, Tiles t, Window win,
           int accel_row, double omega, double w1, double w2,
           cudaStream_t stream) {
  const Coef<T> p{T(omega), T(1.0 - omega), T(w1), T(w2)};
  const size_t smem = smem_bytes(t, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kstep_kernel<T, kInPlace>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(t.nx / t.tw, t.ny / t.th);
  kstep_kernel<T, kInPlace><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), static_cast<const T*>(hband),
      static_cast<const T*>(vband), static_cast<T*>(next_hband),
      static_cast<T*>(next_vband), static_cast<T*>(partials), t, win,
      accel_row, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<T><<<t.k, kThreads, 0, stream>>>(
      static_cast<const T*>(partials), (int)(grid.x * grid.y),
      static_cast<T*>(tot));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inplace(void* f, const void* mask, void* hband, void* vband,
                   int take_snapshot, void* next_hband, void* next_vband,
                   void* partials, void* tot, Tiles t, Window win,
                   int accel_row, double omega, double w1, double w2,
                   cudaStream_t stream) {
  if (!take_snapshot)
    return launch<T, true>(f, mask, f, hband, vband, next_hband, next_vband,
                           partials, tot, t, win, accel_row, omega, w1, w2, stream);
  const int rows = (t.ny / t.th) * 9 * 2 * t.k;
  const int cols = (t.nx / t.tw) * 9;
  snapshot_rows_kernel<T><<<dim3((t.nx + 255) / 256, rows < 65535 ? rows : 65535), 256, 0,
                            stream>>>(static_cast<const T*>(f), static_cast<T*>(hband), t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  snapshot_cols_kernel<T><<<dim3((t.ny * 2 * t.k + 255) / 256, cols < 65535 ? cols : 65535),
                            256, 0, stream>>>(static_cast<const T*>(f), static_cast<T*>(vband), t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch<T, true>(f, mask, f, hband, vband, next_hband, next_vband,
                         partials, tot, t, win, accel_row, omega, w1, w2, stream);
}

}  // namespace

#define LBM_ARGS                                                           \
  int ny, int nx, int th, int tw, int k, int row_offset, int valid_lo,     \
      int valid_hi, int global_ny, int col_lo, int col_hi, int accel_row,  \
      double omega, double w1, double w2, void *stream
#define LBM_PASS                                                          \
  Tiles{ny, nx, th, tw, k},                                               \
      Window{row_offset, valid_lo, valid_hi, global_ny, col_lo, col_hi},  \
      accel_row, omega, w1, w2, static_cast<cudaStream_t>(stream)

extern "C" {

// B2: out = K steps of f (out must not alias f); tot[K] per-step Sum|u|;
// partials holds K * (ny/th) * (nx/tw) values of scratch.
int d2q9_kstep_f32(const void* f, const void* mask, void* out, void* partials,
                   void* tot, LBM_ARGS) {
  return launch<float, false>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                              partials, tot, LBM_PASS);
}
int d2q9_kstep_f64(const void* f, const void* mask, void* out, void* partials,
                   void* tot, LBM_ARGS) {
  return launch<double, false>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                               partials, tot, LBM_PASS);
}

// B1: f = K steps of f, in place. hband/vband hold the boundary snapshot:
// (ny/th) * 9 * 2K * nx and (nx/tw) * 9 * ny * 2K values. With take_snapshot
// they are first filled from f; otherwise they must hold f's boundaries as a
// previous pass left them in its next_hband/next_vband. next_hband and
// next_vband (same sizes, or null) receive the snapshot for the next pass;
// they need th >= K and tw >= K. partials holds K * (ny/th) * (nx/tw) values.
int d2q9_kstep_inplace_f32(void* f, const void* mask, void* hband, void* vband,
                           int take_snapshot, void* next_hband, void* next_vband,
                           void* partials, void* tot, LBM_ARGS) {
  return launch_inplace<float>(f, mask, hband, vband, take_snapshot, next_hband,
                               next_vband, partials, tot, LBM_PASS);
}
int d2q9_kstep_inplace_f64(void* f, const void* mask, void* hband, void* vband,
                           int take_snapshot, void* next_hband, void* next_vband,
                           void* partials, void* tot, LBM_ARGS) {
  return launch_inplace<double>(f, mask, hband, vband, take_snapshot, next_hband,
                                next_vband, partials, tot, LBM_PASS);
}

}  // extern "C"

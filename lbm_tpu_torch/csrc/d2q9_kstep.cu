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
// the valid window [valid_lo, valid_hi) x [col_lo, col_hi). The diagnostic
// modes of the TPU kernels (stream_only, copy) are template instances of the
// same code (csrc/d2q9_step.cuh); the full mode is the production kernel.
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
//   * one thread block per (row tile, column tile), ceil(ny/th) x ceil(nx/tw)
//     of them; the tiles of the last row and column are cut to the grid and
//     mask their stores and their Sum|u|, so any grid of at least K cells a
//     side runs. A block loads its tile plus a K-cell halo on all four sides
//     (indices wrapped at ny and nx) into shared memory, runs the K steps
//     there between two shared buffers (the step-j region shrinks by one cell
//     per side), and writes only its tile interior. The threads walk each
//     region as one flat range, so a region a little wider than a warp does
//     not leave lanes idle;
//   * each block writes its per-step partial sums to partials[K, ntiles] at
//     its tile's index; a second small kernel sums them in a fixed order. No
//     float atomics, so reruns are bit-identical;
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

#include "d2q9_step.cuh"

namespace {

using namespace d2q9;

// Where the nine values of region cell (r, c) come from: speed q is at
// base[q * stride]. f for the tile interior (and the whole region in B2);
// in place, the boundary snapshot for the halo. Only the address is chosen
// per cell, so a warp that mixes interior and halo cells issues its nine
// loads together instead of once per branch.
template <typename T, bool kInPlace>
__device__ __forceinline__ const T* cell_source(const T* f, const T* hband,
                                                const T* vband, const Tiles& t,
                                                const Region& g, int r, int c,
                                                int gr, int gc, size_t& stride) {
  stride = (size_t)t.ny * t.nx;
  const T* base = f + (size_t)gr * t.nx + gc;
  if (kInPlace) {
    const int k = t.k, two_k = 2 * k;
    if (r < k || r >= k + g.th) {
      // rows around a horizontal tile boundary: hband[b][q][i][x] holds row
      // (b*th - k + i) mod ny; below the last tile lies boundary 0
      const int b = r < k ? g.ty : (g.ty + 1) % t.nty();
      const int i = r < k ? r : r - g.th;
      base = hband + ((size_t)b * 9 * two_k + i) * t.nx + gc;
      stride = (size_t)two_k * t.nx;
    } else if (c < k || c >= k + g.tw) {
      // columns around a vertical tile boundary: vband[b][q][y][i] holds
      // column (b*tw - k + i) mod nx
      const int b = c < k ? g.tx : (g.tx + 1) % t.ntx();
      const int i = c < k ? c : c - g.tw;
      base = vband + ((size_t)b * 9 * t.ny + gr) * two_k + i;
      stride = (size_t)t.ny * two_k;
    }
  }
  return base;
}

// The pieces of a tile's interior that the next in-place pass reads as
// snapshot, along one axis (rows: n = ny, tile t = th, tiles nt, this tile's
// index i and extent e). Piece s: boundary b[s], first slot of the window
// slot[s], first interior index first[s], count[s]. The top (left) K of the
// tile go to its own boundary, the bottom (right) K to the next; where the
// last tile is shorter than K (n mod t in (0, K)), the windows of boundary 0
// and of the last boundary reach into the second-to-last and the first
// tiles, which fill those slots too.
struct RingPieces {
  int b[4], slot[4], first[4], count[4];
};

__device__ __forceinline__ RingPieces ring_pieces(int n, int tsize, int nt, int i, int e,
                                                  int k) {
  RingPieces p;
  const int own = min(k, e);
  p.b[0] = i;              p.slot[0] = k;       p.first[0] = 0;       p.count[0] = own;
  p.b[1] = (i + 1) % nt;   p.slot[1] = k - own; p.first[1] = e - own; p.count[1] = own;
  p.count[2] = p.count[3] = 0;
  p.b[2] = p.b[3] = p.slot[2] = p.slot[3] = p.first[2] = p.first[3] = 0;
  const int rem = n % tsize;
  if (rem != 0 && rem < k) {  // then nt >= 2: the grid has at least K cells
    if (i == 0) {
      p.b[2] = nt - 1; p.slot[2] = k + rem; p.first[2] = 0; p.count[2] = k - rem;
    }
    if (i == nt - 2) {
      p.b[3] = 0; p.slot[3] = 0; p.first[3] = tsize - (k - rem); p.count[3] = k - rem;
    }
  }
  return p;
}

// Which piece flat index idx of the pieces' cells (each piece `len` cells
// across) lies in; idx becomes the index inside that piece.
__device__ __forceinline__ int piece_of(const RingPieces& p, int len, int& idx) {
  int s = 0;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (s == q && idx >= p.count[q] * len) {
      idx -= p.count[q] * len;
      s = q + 1;
    }
  }
  return s;
}

// a[s] by selects, so that the pieces stay in registers
__device__ __forceinline__ int pick(const int (&a)[4], int s) {
  return s == 0 ? a[0] : s == 1 ? a[1] : s == 2 ? a[2] : a[3];
}

// Chained snapshot for the next in-place pass: this tile's new K-deep ring,
// straight from shared memory (buf), into the layout cell_source reads. On a
// grid without edge tiles each tile writes its top (left) K rows (columns) to
// its own boundary and its bottom (right) K to the next, by direct index
// arithmetic: the general pieces below cost B1 about 1% more on an H100
// (PERF.md).
template <typename T, bool kEdge>
__device__ __forceinline__ void write_ring(const T* buf, T* next_hband, T* next_vband,
                                           const Tiles& t, const Region& g) {
  const int k = t.k, two_k = 2 * k;
  if constexpr (!kEdge) {
    const float inv_tw = 1.0f / g.tw;
    for (int idx = threadIdx.x; idx < two_k * g.tw; idx += kThreads) {
      const int rr = div_small(idx, inv_tw);
      const int c = idx - rr * g.tw;
      const bool top = rr < k;
      const int ir = top ? rr : g.th - two_k + rr;  // interior row
      const int b = top ? g.ty : (g.ty + 1) % t.nty();
      const int i = top ? k + rr : rr - k;
      T* dst = next_hband + ((size_t)b * 9 * two_k + i) * t.nx + g.c0 + c;
#pragma unroll
      for (int q = 0; q < 9; ++q)
        dst[(size_t)q * two_k * t.nx] = buf[q * g.plane + (ir + k) * g.rw + (c + k)];
    }
    const float inv_two_k = 1.0f / two_k;
    for (int idx = threadIdx.x; idx < g.th * two_k; idx += kThreads) {
      const int r = div_small(idx, inv_two_k);
      const int cc = idx - r * two_k;
      const bool left = cc < k;
      const int ic = left ? cc : g.tw - two_k + cc;  // interior column
      const int b = left ? g.tx : (g.tx + 1) % t.ntx();
      const int i = left ? k + cc : cc - k;
      T* dst = next_vband + ((size_t)b * 9 * t.ny + g.r0 + r) * two_k + i;
#pragma unroll
      for (int q = 0; q < 9; ++q)
        dst[(size_t)q * t.ny * two_k] = buf[q * g.plane + (r + k) * g.rw + (ic + k)];
    }
    return;
  }
  const RingPieces rows = ring_pieces(t.ny, t.th, t.nty(), g.ty, g.th, k);
  const int nrow = (rows.count[0] + rows.count[1] + rows.count[2] + rows.count[3]) * g.tw;
  const float inv_tw = 1.0f / g.tw;
  for (int idx = threadIdx.x; idx < nrow; idx += kThreads) {
    int rest = idx;
    const int s = piece_of(rows, g.tw, rest);
    const int rr = div_small(rest, inv_tw);
    const int c = rest - rr * g.tw;
    T* dst = next_hband + ((size_t)pick(rows.b, s) * 9 * two_k + pick(rows.slot, s) + rr) * t.nx
             + g.c0 + c;
    const int src = (pick(rows.first, s) + rr + k) * g.rw + (c + k);
#pragma unroll
    for (int q = 0; q < 9; ++q) dst[(size_t)q * two_k * t.nx] = buf[q * g.plane + src];
  }
  const RingPieces cols = ring_pieces(t.nx, t.tw, t.ntx(), g.tx, g.tw, k);
  const int ncol = cols.count[0] + cols.count[1] + cols.count[2] + cols.count[3];
  const float inv_ncol = 1.0f / ncol;
  for (int idx = threadIdx.x; idx < g.th * ncol; idx += kThreads) {
    const int r = div_small(idx, inv_ncol);
    int rest = idx - r * ncol;
    const int s = piece_of(cols, 1, rest);
    T* dst = next_vband + ((size_t)pick(cols.b, s) * 9 * t.ny + g.r0 + r) * two_k
             + pick(cols.slot, s) + rest;
    const int src = (r + k) * g.rw + (pick(cols.first, s) + rest + k);
#pragma unroll
    for (int q = 0; q < 9; ++q) dst[(size_t)q * t.ny * two_k] = buf[q * g.plane + src];
  }
}

template <typename T, bool kInPlace, int kMode, bool kEdge>
__global__ void __launch_bounds__(kThreads)
kstep_kernel(const T* f, const uint8_t* __restrict__ mask, T* out,
             const T* __restrict__ hband, const T* __restrict__ vband,
             T* __restrict__ next_hband, T* __restrict__ next_vband,
             T* __restrict__ partials, Tiles t, Window win, int accel_row,
             Coef<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = t.k;
  const int full_plane = t.full_plane();
  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_b = buf_a + 9 * full_plane;
  T* red = buf_b + 9 * full_plane;  // 2 * kWarps, alternating by step parity
  uint8_t* m = reinterpret_cast<uint8_t*>(red + 2 * kWarps);
  uint8_t* row_flag = m + full_plane;
  uint8_t* col_flag = row_flag + t.th + 2 * k;

  const int tid = threadIdx.x;
  const Region g = region_of<kEdge>(t, blockIdx.y, blockIdx.x);
  const int ntiles = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;

  set_flags(t, g, win, accel_row, row_flag, col_flag);
  const float inv_rw = 1.0f / g.rw;
  for (int idx = tid; idx < g.plane; idx += kThreads) {
    const int r = div_small(idx, inv_rw);
    const int c = idx - r * g.rw;
    const int gr = wrap(g.r0 - k + r, t.ny);
    const int gc = wrap(g.c0 - k + c, t.nx);
    m[idx] = mask[(size_t)gr * t.nx + gc];
    size_t stride;
    const T* src = cell_source<T, kInPlace>(f, hband, vband, t, g, r, c, gr, gc, stride);
#pragma unroll
    for (int q = 0; q < 9; ++q) buf_a[q * g.plane + idx] = src[q * stride];
  }
  __syncthreads();

  T* src = buf_a;
  T* dst = buf_b;
  if constexpr (kMode == kCopy) {
    if (tid == 0)
      for (int j = 0; j < k; ++j) partials[(size_t)j * ntiles + bid] = T(0);
  } else {
    for (int j = 1; j <= k; ++j) {
      const T acc = step_region<T, kMode, false>(src, dst, m, row_flag, col_flag, t, g, j, p);
      // the barrier inside block_sum also orders this step's writes of dst
      // before the next step's reads
      const T tot = block_sum<T>(acc, red + (j & 1) * kWarps);
      if (tid == 0) partials[(size_t)(j - 1) * ntiles + bid] = tot;
      T* tmp = src;
      src = dst;
      dst = tmp;
    }
  }

  store_interior<T>(src, out, t, g);
  if (kInPlace && next_hband != nullptr) write_ring<T, kEdge>(src, next_hband, next_vband, t, g);
}

// In-place snapshot, rows: hband row (b*9 + q)*2k + i is row
// (b*th - k + i) mod ny of plane q (see cell_source).
template <typename T>
__global__ void snapshot_rows_kernel(const T* __restrict__ f,
                                     T* __restrict__ hband, Tiles t) {
  const int two_k = 2 * t.k;
  const int nrows = t.nty() * 9 * two_k;
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
  for (int bq = blockIdx.y; bq < t.ntx() * 9; bq += gridDim.y) {
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

template <typename T, bool kInPlace, int kMode, bool kEdge>
int launch_edge(const void* f, const void* mask, void* out, const void* hband,
                const void* vband, void* next_hband, void* next_vband,
                void* partials, void* tot, Tiles t, Window win,
                int accel_row, double omega, double w1, double w2,
                cudaStream_t stream) {
  const Coef<T> p{T(omega), T(1.0 - omega), T(w1), T(w2)};
  const size_t smem = smem_bytes(t, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kstep_kernel<T, kInPlace, kMode, kEdge>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(t.ntx(), t.nty());
  kstep_kernel<T, kInPlace, kMode, kEdge><<<grid, kThreads, smem, stream>>>(
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

template <typename T, bool kInPlace, int kMode>
int launch_mode(const void* f, const void* mask, void* out, const void* hband,
                const void* vband, void* next_hband, void* next_vband,
                void* partials, void* tot, Tiles t, Window win,
                int accel_row, double omega, double w1, double w2,
                cudaStream_t stream) {
  return has_edges(t)
      ? launch_edge<T, kInPlace, kMode, true>(f, mask, out, hband, vband, next_hband, next_vband,
                                              partials, tot, t, win, accel_row, omega, w1, w2,
                                              stream)
      : launch_edge<T, kInPlace, kMode, false>(f, mask, out, hband, vband, next_hband,
                                               next_vband, partials, tot, t, win, accel_row,
                                               omega, w1, w2, stream);
}

template <typename T, bool kInPlace>
int launch(const void* f, const void* mask, void* out, const void* hband,
           const void* vband, void* next_hband, void* next_vband,
           void* partials, void* tot, Tiles t, Window win,
           int accel_row, int mode, double omega, double w1, double w2,
           cudaStream_t stream) {
  switch (mode) {
    case kFull:
      return launch_mode<T, kInPlace, kFull>(f, mask, out, hband, vband, next_hband,
                                             next_vband, partials, tot, t, win, accel_row,
                                             omega, w1, w2, stream);
    case kStreamOnly:
      return launch_mode<T, kInPlace, kStreamOnly>(f, mask, out, hband, vband, next_hband,
                                                   next_vband, partials, tot, t, win,
                                                   accel_row, omega, w1, w2, stream);
    case kCopy:
      return launch_mode<T, kInPlace, kCopy>(f, mask, out, hband, vband, next_hband,
                                             next_vband, partials, tot, t, win, accel_row,
                                             omega, w1, w2, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_inplace(void* f, const void* mask, void* hband, void* vband,
                   int take_snapshot, void* next_hband, void* next_vband,
                   void* partials, void* tot, Tiles t, Window win,
                   int accel_row, int mode, double omega, double w1, double w2,
                   cudaStream_t stream) {
  if (take_snapshot) {
    const int rows = t.nty() * 9 * 2 * t.k;
    const int cols = t.ntx() * 9;
    snapshot_rows_kernel<T><<<dim3((t.nx + 255) / 256, rows < 65535 ? rows : 65535), 256, 0,
                              stream>>>(static_cast<const T*>(f), static_cast<T*>(hband), t);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    snapshot_cols_kernel<T><<<dim3((t.ny * 2 * t.k + 255) / 256, cols < 65535 ? cols : 65535),
                              256, 0, stream>>>(static_cast<const T*>(f), static_cast<T*>(vband), t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch<T, true>(f, mask, f, hband, vband, next_hband, next_vband,
                         partials, tot, t, win, accel_row, mode, omega, w1, w2, stream);
}

}  // namespace

extern "C" {

// B2: out = K steps of f (out must not alias f); tot[K] per-step Sum|u|;
// partials holds K * ceil(ny/th) * ceil(nx/tw) values of scratch. mode is a
// d2q9::Mode.
int d2q9_kstep_f32(const void* f, const void* mask, void* out, void* partials,
                   void* tot, D2Q9_ARGS) {
  return launch<float, false>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                              partials, tot, D2Q9_PASS);
}
int d2q9_kstep_f64(const void* f, const void* mask, void* out, void* partials,
                   void* tot, D2Q9_ARGS) {
  return launch<double, false>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                               partials, tot, D2Q9_PASS);
}

// B1: f = K steps of f, in place. hband/vband hold the boundary snapshot:
// ceil(ny/th) * 9 * 2K * nx and ceil(nx/tw) * 9 * ny * 2K values. With
// take_snapshot they are first filled from f; otherwise they must hold f's
// boundaries as a previous pass left them in its next_hband/next_vband.
// next_hband and next_vband (same sizes, or null) receive the snapshot for
// the next pass; they need th >= K, tw >= K, ny >= K and nx >= K. partials
// holds K * ceil(ny/th) * ceil(nx/tw) values.
int d2q9_kstep_inplace_f32(void* f, const void* mask, void* hband, void* vband,
                           int take_snapshot, void* next_hband, void* next_vband,
                           void* partials, void* tot, D2Q9_ARGS) {
  return launch_inplace<float>(f, mask, hband, vband, take_snapshot, next_hband,
                               next_vband, partials, tot, D2Q9_PASS);
}
int d2q9_kstep_inplace_f64(void* f, const void* mask, void* hband, void* vband,
                           int take_snapshot, void* next_hband, void* next_vband,
                           void* partials, void* tot, D2Q9_ARGS) {
  return launch_inplace<double>(f, mask, hband, vband, take_snapshot, next_hband,
                                next_vband, partials, tot, D2Q9_PASS);
}

}  // extern "C"

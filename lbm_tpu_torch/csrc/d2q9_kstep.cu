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
//   * both kernels share the step code and the reduction order, so for the
//     same tiles B1 is bit-identical to B2.
// Two ways to move a region, chosen per launch by the wrapper from the shape
// (d2q9_kstep.choose_path; the launch refuses a path that the layout does
// not allow):
//   * the box path (kstep_box_kernel): the Tensor Memory Accelerator moves
//     the region in and the tile out, so the threads spend no instruction on
//     the address of a value that a box can place. One thread issues the
//     region's boxes on an mbarrier; meanwhile the threads load the mask and,
//     into registers, the strips that no box can place; once the boxes have
//     landed they store those strips. B2's region is one (9, rh, rw) box of
//     f; its strips are the K rows or columns that wrap around the grid
//     (TMA fills them with zeros), so a tile away from the grid's edges has
//     none. B1's region is three boxes a plane: its top K rows from hband,
//     its interior rows (tw + 2K wide) from f and its bottom K rows from
//     hband (hband holds whole rows, corners included); the threads then
//     overwrite the 2K columns beside the tile from vband, and at the grid's
//     left and right edge the K x K corners of the hband rows, which wrap.
//     The last step writes the tile dense, (9, th, tw), into the buffer the
//     step before left free, and one box stores it; B1's ring goes from the
//     same dense tile to next_hband as (K, tw) boxes and to next_vband by
//     the threads. It needs no edge tiles, rows of a multiple of 16 bytes, a
//     region whose first column lies on 16 bytes (K values a multiple of 16
//     bytes) and box offsets in shared memory of a multiple of 128 bytes
//     (B1);
//   * the thread path (kstep_kernel), any other shape: the threads load every
//     value of the region (cell_source) and store every value of the tile.
// bfloat16 storage: the thread path loads a region of a bfloat16 state into
// float buffers, runs the K steps in float and rounds once, at the store of
// the tile (and of B1's ring), as the TPU kernels compute in float32 and
// cast at the store; Sum|u| is float. bfloat16 takes no box path: TMA would
// land the region in shared memory as bfloat16, where the steps need float,
// and at the flagship's K = 4 its region would start 8 bytes off 16 (the
// trap above). A bfloat16 pass moves 37 bytes a cell against float32's 73.
// B2 also takes shared_reciprocal (d2q9_kstep_recip_*): the collision takes
// 1/rho once and multiplies, as collide_fields(shared_reciprocal=True).
// The library is compiled with -fmad=false: every product, sum and division
// rounds on its own, as in collide_fields. The plain PyTorch version on CUDA
// still differs by about 1e-6 relative in float32 (1e-15 in float64): PyTorch
// divides by a Python scalar as a multiply by its reciprocal. The order of the
// Sum|u| reduction differs too.
//
// Interface: plain C, one entry per (kernel, dtype), each launching on the
// given stream and returning cudaGetLastError() after every launch. The
// kernels allocate nothing; the caller passes every buffer.

#include <string.h>

#include <type_traits>

#include "d2q9_box.cuh"
#include "tile_copy.cuh"

namespace {

using namespace d2q9;

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
template <typename B, typename T, bool kEdge>
__device__ __forceinline__ void write_ring(const B* buf, T* next_hband, T* next_vband,
                                           const Tiles& t, const Region& g) {
  using storage::load;
  using storage::put;
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
        put(dst[(size_t)q * two_k * t.nx], load(buf[q * g.plane + (ir + k) * g.rw + (c + k)]));
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
        put(dst[(size_t)q * t.ny * two_k], load(buf[q * g.plane + (r + k) * g.rw + (ic + k)]));
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
    for (int q = 0; q < 9; ++q) put(dst[(size_t)q * two_k * t.nx], load(buf[q * g.plane + src]));
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
    for (int q = 0; q < 9; ++q) put(dst[(size_t)q * t.ny * two_k], load(buf[q * g.plane + src]));
  }
}

// The thread path. T is the storage type; the region buffers, the steps and
// the partials are of the compute type C (a bfloat16 state is loaded into
// float buffers and rounded once, at the store of the tile and of the ring).
template <typename T, bool kInPlace, int kMode, bool kEdge, bool kRecip = false>
__global__ void __launch_bounds__(kThreads)
kstep_kernel(const T* f, const uint8_t* __restrict__ mask, T* out,
             const T* __restrict__ hband, const T* __restrict__ vband,
             T* __restrict__ next_hband, T* __restrict__ next_vband,
             typename storage::Compute<T>::type* __restrict__ partials, Tiles t, Window win,
             int accel_row, Coef<typename storage::Compute<T>::type> p) {
  using C = typename storage::Compute<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = t.k;
  const int full_plane = t.full_plane();
  C* buf_a = reinterpret_cast<C*>(smem_raw);
  C* buf_b = buf_a + 9 * full_plane;
  C* red = buf_b + 9 * full_plane;  // 2 * kWarps, alternating by step parity
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
    for (int q = 0; q < 9; ++q) buf_a[q * g.plane + idx] = storage::load(src[q * stride]);
  }
  __syncthreads();

  C* src = buf_a;
  C* dst = buf_b;
  if constexpr (kMode == kCopy) {
    if (tid == 0)
      for (int j = 0; j < k; ++j) partials[(size_t)j * ntiles + bid] = C(0);
  } else {
    for (int j = 1; j <= k; ++j) {
      const C acc = step_region<C, C, C, kMode, false, kRecip>(src, dst, m, row_flag, col_flag,
                                                              t, g, j, p);
      // the barrier inside block_sum also orders this step's writes of dst
      // before the next step's reads
      const C tot = block_sum<C>(acc, red + (j & 1) * kWarps);
      if (tid == 0) partials[(size_t)(j - 1) * ntiles + bid] = tot;
      C* tmp = src;
      src = dst;
      dst = tmp;
    }
  }

  store_interior(src, out, t, g);
  if (kInPlace && next_hband != nullptr) write_ring<C, T, kEdge>(src, next_hband, next_vband, t, g);
}

// ----------------------------------------------------------- box path ----

// The tensor maps of a box-path launch, one __grid_constant__ parameter.
struct Maps {
  CUtensorMap in;         // f as (9, ny, nx): B2 box (9, rh, rw), B1 box (1, th, rw)
  CUtensorMap out;        // out (B2) or f (B1), box (9, th, tw)
  CUtensorMap band;       // B1: hband as (nty * 9, 2K, nx), box (1, K, rw)
  CUtensorMap next_band;  // B1: next_hband, box (1, K, tw)
};

// Byte offsets of the box path's shared memory from its 128-byte aligned
// base: the region buffer a at 0, the buffer b, the mbarrier, the reduction
// scratch, the mask and the row and column flags; `total` counts the slack
// of the alignment too (mirrored by d2q9_kstep.box_smem_bytes).
struct BoxSmem {
  int b, bar, red, m, total;
};

__host__ __device__ inline BoxSmem box_smem(const Tiles& t, int elem) {
  const int rh = t.th + 2 * t.k, rw = t.tw + 2 * t.k, state = 9 * rh * rw * elem;
  BoxSmem s;
  s.b = round_up(state, 128);
  s.bar = s.b + round_up(state, 16);
  s.red = s.bar + 16;
  s.m = s.red + 2 * kWarps * elem;
  s.total = 128 + s.m + rh * rw + rh + rw;
  return s;
}

// B1's ring columns for the next pass from the dense (9, th, tw) tile, in
// the layout cell_source reads: the left K columns to the tile's own vertical
// boundary, the right K to the next (its rows go by boxes).
template <typename T>
__device__ __forceinline__ void write_ring_cols(const T* tile, T* next_vband, const Tiles& t,
                                                const Region& g) {
  const int k = t.k, two_k = 2 * k, tile_plane = g.th * g.tw;
  const float inv_two_k = 1.0f / two_k;
  for (int idx = threadIdx.x; idx < g.th * two_k; idx += kThreads) {
    const int r = div_small(idx, inv_two_k);
    const int cc = idx - r * two_k;
    const bool left = cc < k;
    const int ic = left ? cc : g.tw - two_k + cc;  // tile column
    const int b = left ? g.tx : (g.tx + 1) % t.ntx();
    const int i = left ? k + cc : cc - k;
    T* out = next_vband + ((size_t)b * 9 * t.ny + g.r0 + r) * two_k + i;
#pragma unroll
    for (int q = 0; q < 9; ++q)
      out[(size_t)q * t.ny * two_k] = tile[q * tile_plane + r * g.tw + ic];
  }
}

template <typename T, bool kInPlace, int kMode, bool kRecip = false>
__global__ void __launch_bounds__(kThreads)
kstep_box_kernel(const __grid_constant__ Maps maps, const T* f, const uint8_t* __restrict__ mask,
                 T* out, const T* __restrict__ hband, const T* __restrict__ vband,
                 T* __restrict__ next_hband, T* __restrict__ next_vband, T* __restrict__ partials,
                 Tiles t, Window win, int accel_row, Coef<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = t.k;
  const BoxSmem at = box_smem(t, sizeof(T));
  unsigned char* base = tile_copy::align128<unsigned char>(smem_raw);
  T* buf_a = reinterpret_cast<T*>(base);
  T* buf_b = reinterpret_cast<T*>(base + at.b);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + at.bar);
  T* red = reinterpret_cast<T*>(base + at.red);  // 2 * kWarps, alternating by step parity
  uint8_t* m = base + at.m;
  uint8_t* row_flag = m + t.full_plane();
  uint8_t* col_flag = row_flag + t.th + 2 * k;

  const int tid = threadIdx.x;
  const Region g = region_of<false>(t, blockIdx.y, blockIdx.x);
  const int ntiles = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int below = (g.ty + 1) % t.nty();  // the boundary under the tile

  if (tid == 0) {
    tile_copy::mbar_init(bar, 1);
    tile_copy::mbar_expect_tx(bar, (uint32_t)(9 * g.plane * sizeof(T)));
    if (kInPlace) {
      for (int q = 0; q < 9; ++q) {
        T* plane = buf_a + q * g.plane;
        tile_copy::box_load(&maps.band, plane, bar, g.c0 - k, 0, g.ty * 9 + q);
        // The interior rows come rw wide, not tw: a box lands dense, so only
        // one as wide as the region keeps its row stride, and a tw-wide box
        // would land at a shared offset off 128 bytes. Its 2K outer columns
        // are the neighbouring tiles' cells of f, which their blocks may be
        // storing in this same launch: a race whose values are never used,
        // since the strips from vband overwrite those columns after the wait
        // and before any step reads them.
        tile_copy::box_load(&maps.in, plane + k * g.rw, bar, g.c0 - k, g.r0, q);
        tile_copy::box_load(&maps.band, plane + (k + g.th) * g.rw, bar, g.c0 - k, k,
                            below * 9 + q);
      }
    } else {
      tile_copy::box_load(&maps.in, buf_a, bar, g.c0 - k, g.r0 - k, 0);
    }
  }

  // while the boxes are in flight: the flags, the mask and the first strip
  // cell of each thread
  set_flags(t, g, win, accel_row, row_flag, col_flag);
  const bool wraps = g.r0 < k || g.r0 + g.th + k > t.ny || g.c0 < k || g.c0 + g.tw + k > t.nx;
  if (!wraps && (t.nx | k | g.rw) % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0) {
    // four mask bytes a load: region rows and their first column on 4 bytes
    const int words = g.rw / 4;
    const float inv_words = 1.0f / words;
    for (int idx = tid; idx < g.rh * words; idx += kThreads) {
      const int r = div_small(idx, inv_words);
      const int w = idx - r * words;
      reinterpret_cast<uint32_t*>(m + r * g.rw)[w] = *reinterpret_cast<const uint32_t*>(
          mask + (size_t)(g.r0 - k + r) * t.nx + (g.c0 - k) + 4 * w);
    }
  } else {
    const float inv_rw = 1.0f / g.rw;
    for (int idx = tid; idx < g.plane; idx += kThreads) {
      const int r = div_small(idx, inv_rw);
      const int c = idx - r * g.rw;
      m[idx] = mask[(size_t)wrap(g.r0 - k + r, t.ny) * t.nx + wrap(g.c0 - k + c, t.nx)];
    }
  }
  const Strips s = strips_of<kInPlace>(t, g);
  const int nstrip = strip_cells(s);
  T v[9];
  const int first =
      tid < nstrip ? load_strip_cell<T, kInPlace>(f, hband, vband, t, g, s, tid, v) : -1;
  __syncthreads();  // the mbarrier is initialised before anyone waits on it
  tile_copy::mbar_wait(bar, 0);
  if (first >= 0) {
#pragma unroll
    for (int q = 0; q < 9; ++q) buf_a[q * g.plane + first] = v[q];
  }
  for (int i = tid + kThreads; i < nstrip; i += kThreads) {
    const int cell = load_strip_cell<T, kInPlace>(f, hband, vband, t, g, s, i, v);
#pragma unroll
    for (int q = 0; q < 9; ++q) buf_a[q * g.plane + cell] = v[q];
  }
  __syncthreads();

  // K steps; the last writes the tile dense, (9, th, tw), into the free buffer
  const int tile_plane = g.th * g.tw;
  T* src = buf_a;
  T* dst = buf_b;
  if constexpr (kMode == kCopy) {
    const float inv_tw = 1.0f / g.tw;
    for (int idx = tid; idx < tile_plane; idx += kThreads) {
      const int r = div_small(idx, inv_tw);
      const int c = idx - r * g.tw;
#pragma unroll
      for (int q = 0; q < 9; ++q)
        dst[q * tile_plane + idx] = src[q * g.plane + (r + k) * g.rw + (c + k)];
    }
    src = dst;
    tile_copy::fence_proxy_async();
    if (tid == 0)
      for (int j = 0; j < k; ++j) partials[(size_t)j * ntiles + bid] = T(0);
    __syncthreads();
  } else {
    const Tiles dense{g.th, g.tw, t.th, t.tw, k};  // the tile as a (9, th, tw) "grid"
    Region at_origin = g;
    at_origin.r0 = at_origin.c0 = 0;
    for (int j = 1; j <= k; ++j) {
      T acc;
      if (j < k) {
        acc = step_region<T, T, T, kMode, false, kRecip>(src, dst, m, row_flag, col_flag, t, g,
                                                         j, p);
      } else {
        acc = step_region<T, T, T, kMode, true, kRecip>(src, dst, m, row_flag, col_flag, dense,
                                                        at_origin, j, p);
        tile_copy::fence_proxy_async();  // the dense tile, before the box store reads it
      }
      // the barrier inside block_sum also orders this step's writes of dst
      // before the next step's reads (and the box store)
      const T tot = block_sum<T>(acc, red + (j & 1) * kWarps);
      if (tid == 0) partials[(size_t)(j - 1) * ntiles + bid] = tot;
      T* tmp = src;
      src = dst;
      dst = tmp;
    }
  }

  const bool ring = kInPlace && next_vband != nullptr;
  if (tid == 0) {
    tile_copy::box_store(&maps.out, src, g.c0, g.r0, 0);
    if (ring) {
      // the top K rows to the tile's own boundary, the bottom K to the next
      for (int q = 0; q < 9; ++q) {
        const T* plane = src + q * tile_plane;
        tile_copy::box_store(&maps.next_band, plane, g.c0, k, g.ty * 9 + q);
        tile_copy::box_store(&maps.next_band, plane + (g.th - k) * g.tw, g.c0, 0, below * 9 + q);
      }
    }
    tile_copy::bulk_commit();
  }
  if (ring) write_ring_cols<T>(src, next_vband, t, g);
  if (tid == 0) tile_copy::bulk_wait_read<0>();  // the stores have read the tile
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

// Whether the box path takes this launch (mirrored by d2q9_kstep.choose_path):
// box_layout_fits and the block in shared memory; in place, every box that
// lands in or leaves from the middle of a plane at a multiple of 128 bytes.
bool box_fits(const Tiles& t, int elem, bool in_place, const void* f, const void* out,
              const void* hband, const void* next_hband) {
  const int rh = t.th + 2 * t.k, rw = t.tw + 2 * t.k;
  bool ok = box_layout_fits(t, elem, f, out) && (size_t)box_smem(t, elem).total <= kSmemPerBlock;
  if (in_place)
    ok = ok && (rh * rw * elem) % 128 == 0 && (t.k * rw * elem) % 128 == 0 &&
         (t.th * rw * elem) % 128 == 0 && (t.th * t.tw * elem) % 128 == 0 &&
         ((t.th - t.k) * t.tw * elem) % 128 == 0 && aligned16(hband) &&
         (next_hband == nullptr || aligned16(next_hband));
  return ok;
}

template <typename C>
int sum_partials(const void* partials, void* tot, Tiles t, cudaStream_t stream) {
  sum_partials_kernel<C><<<t.k, kThreads, 0, stream>>>(
      static_cast<const C*>(partials), t.ntx() * t.nty(), static_cast<C*>(tot));
  return (int)cudaGetLastError();
}

template <typename T, bool kInPlace, int kMode, bool kEdge, bool kRecip>
int launch_edge(const void* f, const void* mask, void* out, const void* hband,
                const void* vband, void* next_hband, void* next_vband,
                void* partials, void* tot, Tiles t, Window win,
                int accel_row, double omega, double w1, double w2,
                cudaStream_t stream) {
  using C = typename storage::Compute<T>::type;
  const Coef<C> p{C(omega), C(1.0 - omega), C(w1), C(w2)};
  const size_t smem = smem_bytes(t, sizeof(C));
  cudaError_t err = cudaFuncSetAttribute(
      kstep_kernel<T, kInPlace, kMode, kEdge, kRecip>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(t.ntx(), t.nty());
  kstep_kernel<T, kInPlace, kMode, kEdge, kRecip><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), static_cast<const T*>(hband),
      static_cast<const T*>(vband), static_cast<T*>(next_hband),
      static_cast<T*>(next_vband), static_cast<C*>(partials), t, win,
      accel_row, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials<C>(partials, tot, t, stream);
}

// The tensor maps of a box-path launch, each encoded once per pointer and
// shape (tile_copy::encode_map); an encoding that fails returns its error.
int encode_maps(Maps& maps, const Tiles& t, int elem, bool in_place, const void* f,
                const void* out, const void* hband, const void* next_hband) {
  memset(&maps, 0, sizeof maps);
  const int rh = t.th + 2 * t.k, rw = t.tw + 2 * t.k, bands = t.nty() * 9;
  using tile_copy::encode_map;
  int rc = encode_map(&maps.out, {out, elem, 9, t.ny, t.nx, 9, t.th, t.tw});
  if (rc) return rc;
  if (!in_place) return encode_map(&maps.in, {f, elem, 9, t.ny, t.nx, 9, rh, rw});
  rc = encode_map(&maps.in, {f, elem, 9, t.ny, t.nx, 1, t.th, rw});
  if (!rc) rc = encode_map(&maps.band, {hband, elem, bands, 2 * t.k, t.nx, 1, t.k, rw});
  if (!rc && next_hband != nullptr)
    rc = encode_map(&maps.next_band, {next_hband, elem, bands, 2 * t.k, t.nx, 1, t.k, t.tw});
  return rc;
}

template <typename T, bool kInPlace, int kMode, bool kRecip>
int launch_box(const void* f, const void* mask, void* out, const void* hband,
               const void* vband, void* next_hband, void* next_vband,
               void* partials, void* tot, Tiles t, Window win,
               int accel_row, double omega, double w1, double w2,
               cudaStream_t stream) {
  constexpr int E = sizeof(T);
  if (!box_fits(t, E, kInPlace, f, out, hband, next_hband)) return (int)cudaErrorInvalidValue;
  Maps maps;
  int rc = encode_maps(maps, t, E, kInPlace, f, out, hband, next_hband);
  if (rc) return rc;
  const Coef<T> p{T(omega), T(1.0 - omega), T(w1), T(w2)};
  const size_t smem = box_smem(t, E).total;
  cudaError_t err = cudaFuncSetAttribute(kstep_box_kernel<T, kInPlace, kMode, kRecip>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kstep_box_kernel<T, kInPlace, kMode, kRecip>
      <<<dim3(t.ntx(), t.nty()), kThreads, smem, stream>>>(
          maps, static_cast<const T*>(f), static_cast<const uint8_t*>(mask),
          static_cast<T*>(out), static_cast<const T*>(hband), static_cast<const T*>(vband),
          static_cast<T*>(next_hband), static_cast<T*>(next_vband), static_cast<T*>(partials),
          t, win, accel_row, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials<T>(partials, tot, t, stream);
}

// A bfloat16 state runs on the thread path only: the box path would land the
// region in shared memory as bfloat16, where the steps need float
// (d2q9_kstep.choose_path gives it the thread path; a box launch is refused).
template <typename T>
constexpr bool kHasBoxPath = !std::is_same<T, __nv_bfloat16>::value;

template <typename T, bool kInPlace, int kMode, bool kRecip>
int launch_mode(const void* f, const void* mask, void* out, const void* hband,
                const void* vband, void* next_hband, void* next_vband,
                void* partials, void* tot, Tiles t, Window win,
                int accel_row, int path, double omega, double w1, double w2,
                cudaStream_t stream) {
  if (path == kBoxPath) {
    if constexpr (kHasBoxPath<T>)
      return launch_box<T, kInPlace, kMode, kRecip>(f, mask, out, hband, vband, next_hband,
                                                    next_vband, partials, tot, t, win,
                                                    accel_row, omega, w1, w2, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (path != kThreadPath) return (int)cudaErrorInvalidValue;
  return has_edges(t)
      ? launch_edge<T, kInPlace, kMode, true, kRecip>(f, mask, out, hband, vband, next_hband,
                                                      next_vband, partials, tot, t, win,
                                                      accel_row, omega, w1, w2, stream)
      : launch_edge<T, kInPlace, kMode, false, kRecip>(f, mask, out, hband, vband, next_hband,
                                                       next_vband, partials, tot, t, win,
                                                       accel_row, omega, w1, w2, stream);
}

// kRecip (B2's shared_reciprocal) changes the collision only, so it takes
// the full mode alone.
template <typename T, bool kInPlace, bool kRecip = false>
int launch(const void* f, const void* mask, void* out, const void* hband,
           const void* vband, void* next_hband, void* next_vband,
           void* partials, void* tot, int path, Tiles t, Window win,
           int accel_row, int mode, double omega, double w1, double w2,
           cudaStream_t stream) {
  if (mode == kFull)
    return launch_mode<T, kInPlace, kFull, kRecip>(f, mask, out, hband, vband, next_hband,
                                                   next_vband, partials, tot, t, win, accel_row,
                                                   path, omega, w1, w2, stream);
  if constexpr (!kRecip) {
    if (mode == kStreamOnly)
      return launch_mode<T, kInPlace, kStreamOnly, false>(f, mask, out, hband, vband,
                                                          next_hband, next_vband, partials, tot,
                                                          t, win, accel_row, path, omega, w1,
                                                          w2, stream);
    if (mode == kCopy)
      return launch_mode<T, kInPlace, kCopy, false>(f, mask, out, hband, vband, next_hband,
                                                    next_vband, partials, tot, t, win,
                                                    accel_row, path, omega, w1, w2, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_inplace(void* f, const void* mask, void* hband, void* vband,
                   int take_snapshot, void* next_hband, void* next_vband,
                   void* partials, void* tot, int path, Tiles t, Window win,
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
                         partials, tot, path, t, win, accel_row, mode, omega, w1, w2, stream);
}

// Blocks of the full-mode kernel of `path` resident on one SM of the current
// device for this tile and K; 0 on an error (and for a bfloat16 box path).
template <typename T, bool kInPlace>
int blocks_per_sm(int path, Tiles t) {
  using C = typename storage::Compute<T>::type;
  const void* kernel = nullptr;
  size_t smem = smem_bytes(t, sizeof(C));
  if (path == kBoxPath) {
    if constexpr (kHasBoxPath<T>) {
      kernel = (const void*)kstep_box_kernel<T, kInPlace, kFull>;
      smem = (size_t)box_smem(t, sizeof(T)).total;
    }
  } else {
    kernel = (const void*)kstep_kernel<T, kInPlace, kFull, false>;
  }
  int per_sm = 0;
  if (kernel == nullptr ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess)
    return 0;
  return per_sm;
}

}  // namespace

extern "C" {

// B2: out = K steps of f (out must not alias f); tot[K] per-step Sum|u|;
// partials holds K * ceil(ny/th) * ceil(nx/tw) values of scratch. path is a
// Path (d2q9_kstep.PATHS), mode a d2q9::Mode. In the _bf16 entries f and out
// are bfloat16, partials and tot float, and path must be the thread path.
int d2q9_kstep_f32(const void* f, const void* mask, void* out, void* partials,
                   void* tot, int path, D2Q9_ARGS) {
  return launch<float, false>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                              partials, tot, path, D2Q9_PASS);
}
int d2q9_kstep_f64(const void* f, const void* mask, void* out, void* partials,
                   void* tot, int path, D2Q9_ARGS) {
  return launch<double, false>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                               partials, tot, path, D2Q9_PASS);
}
int d2q9_kstep_bf16(const void* f, const void* mask, void* out, void* partials,
                    void* tot, int path, D2Q9_ARGS) {
  return launch<__nv_bfloat16, false>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                                      partials, tot, path, D2Q9_PASS);
}

// B2 with shared_reciprocal (lbm_tpu/ops/d2q9_pallas.py): the collision
// takes 1/rho once and multiplies. Full mode only; otherwise as above.
int d2q9_kstep_recip_f32(const void* f, const void* mask, void* out, void* partials,
                         void* tot, int path, D2Q9_ARGS) {
  return launch<float, false, true>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                                    partials, tot, path, D2Q9_PASS);
}
int d2q9_kstep_recip_f64(const void* f, const void* mask, void* out, void* partials,
                         void* tot, int path, D2Q9_ARGS) {
  return launch<double, false, true>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                                     partials, tot, path, D2Q9_PASS);
}
int d2q9_kstep_recip_bf16(const void* f, const void* mask, void* out, void* partials,
                          void* tot, int path, D2Q9_ARGS) {
  return launch<__nv_bfloat16, false, true>(f, mask, out, nullptr, nullptr, nullptr, nullptr,
                                            partials, tot, path, D2Q9_PASS);
}

// B1: f = K steps of f, in place. hband/vband hold the boundary snapshot:
// ceil(ny/th) * 9 * 2K * nx and ceil(nx/tw) * 9 * ny * 2K values. With
// take_snapshot they are first filled from f; otherwise they must hold f's
// boundaries as a previous pass left them in its next_hband/next_vband.
// next_hband and next_vband (same sizes, or null) receive the snapshot for
// the next pass; they need th >= K, tw >= K, ny >= K and nx >= K. partials
// holds K * ceil(ny/th) * ceil(nx/tw) values. In the _bf16 entry f and the
// snapshots are bfloat16, partials and tot float; thread path only.
int d2q9_kstep_inplace_f32(void* f, const void* mask, void* hband, void* vband,
                           int take_snapshot, void* next_hband, void* next_vband,
                           void* partials, void* tot, int path, D2Q9_ARGS) {
  return launch_inplace<float>(f, mask, hband, vband, take_snapshot, next_hband,
                               next_vband, partials, tot, path, D2Q9_PASS);
}
int d2q9_kstep_inplace_f64(void* f, const void* mask, void* hband, void* vband,
                           int take_snapshot, void* next_hband, void* next_vband,
                           void* partials, void* tot, int path, D2Q9_ARGS) {
  return launch_inplace<double>(f, mask, hband, vband, take_snapshot, next_hband,
                                next_vband, partials, tot, path, D2Q9_PASS);
}
int d2q9_kstep_inplace_bf16(void* f, const void* mask, void* hband, void* vband,
                            int take_snapshot, void* next_hband, void* next_vband,
                            void* partials, void* tot, int path, D2Q9_ARGS) {
  return launch_inplace<__nv_bfloat16>(f, mask, hband, vband, take_snapshot, next_hband,
                                       next_vband, partials, tot, path, D2Q9_PASS);
}

// Blocks of B1 (in_place) or B2 in full mode on `path` that one SM of the
// current device holds at this tile and K, itemsize 2 (bfloat16), 4 or 8; 0
// on an error.
int d2q9_kstep_blocks(int itemsize, int in_place, int path, int th, int tw, int k) {
  const Tiles t{th, tw, th, tw, k};
  if (itemsize == 8)
    return in_place ? blocks_per_sm<double, true>(path, t) : blocks_per_sm<double, false>(path, t);
  if (itemsize == 2)
    return in_place ? blocks_per_sm<__nv_bfloat16, true>(path, t)
                    : blocks_per_sm<__nv_bfloat16, false>(path, t);
  return in_place ? blocks_per_sm<float, true>(path, t) : blocks_per_sm<float, false>(path, t);
}

}  // extern "C"

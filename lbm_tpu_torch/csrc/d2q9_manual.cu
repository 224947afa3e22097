// K fused D2Q9 steps per launch through an explicit copy pipeline, for NVIDIA
// Hopper (sm_90a): kernel B3.
//
// Replaces the Pallas TPU kernel lbm_tpu/ops/d2q9_pallas_manual.py `_kernel`,
// which computes B2's function (lbm_tpu/ops/d2q9_pallas.py) with the HBM
// traffic made explicit: an empty grid, a loop over row bands, and
// double-buffered DMAs so that band i+1's fetch and band i-1's write-back are
// in flight while band i computes. It asks whether hiding the memory traffic
// behind the arithmetic buys anything over the automatic pipeline.
//
// What bounds it on this card: as B2, memory at 73 bytes per cell and pass in
// f32 (the 9 values in, the mask byte, the 9 values out), against ~94
// operations per cell-step; the K steps in shared memory take most of B2's
// time (PERF.md section 5).
//
// Design, the card's form of the TPU kernel's pipeline: a persistent grid, as
// many blocks as fit the SMs at once (the occupancy of the kernel at its
// shared memory, times the SM count); block b walks the tiles b, b + grid,
// b + 2 grid, ... in B2's row-major order (csrc/d2q9_kstep.cu), one tile a
// round. While the block runs the K steps of tile i, the region of tile
// i + grid (9 planes of the tile plus its K halo, wrapped at ny and nx) is in
// flight into shared memory. The step code, the per-tile reduction and the
// partials[K, ntiles] slot of each tile are B2's (csrc/d2q9_step.cuh), summed
// by the same fixed-order kernel: at the same tile and K, B3 equals B2 bit
// for bit on either path. Two paths, chosen per launch by the wrapper from
// the shape (d2q9_kstep_manual.choose_path; the launch refuses a path that
// the layout does not allow):
//   * the box path (manual_box_kernel), B2's box rule (csrc/d2q9_box.cuh).
//     Three region buffers rotate: one holds the tile's region, one the
//     previous tile's dense tile, one nothing. At the top of a round one
//     thread issues the next region as one (9, rh, rw) TMA box of a tensor
//     map over f into the free buffer; it completes on that buffer's
//     mbarrier. After the wait on this tile's box the threads patch the
//     strips that wrap around the grid (TMA fills them with zeros), as B2
//     does. The next tile's mask moves by `cp.async` in 4-byte words into the
//     next round's mask plane. The steps ping-pong between the region and
//     the previous dense tile's buffer, once the box store of that tile has
//     read it (waited on just before the steps); the last step writes the
//     tile dense, (9, th, tw), into the one the step before left free, and
//     one box store takes it out. So the next region's load and this tile's
//     write-back are in flight while the block waits, patches and steps, as
//     on the TPU, and neither waits for the other. Shared memory: three
//     buffers of 9 x (th + 2K)(tw + 2K) values, two mask planes, the
//     mbarriers, the reduction scratch and the flags, each on 128 bytes:
//     106,240 B at 16x32, K=4, f32, so two blocks an SM (B2: three);
//   * the thread path (manual_kernel), any other shape (edge tiles, K =
//     1..3 in f32, misaligned buffers): every value of the next region by
//     the threads' `cp.async` (16 bytes where the region rows are aligned and
//     do not wrap, else one value at a time), the next mask in registers
//     (8 a thread: a region of at most 2,048 cells), the last step straight
//     to device memory. Shared memory 105,728 B at 16x32, K=4, f32.
//     A bfloat16 state takes this path alone: its buffers hold float (the
//     same 105,728 B), a stage receives the region as bfloat16 in its
//     first half (16 bytes a copy where the region rows allow it, else 4
//     where pairs do not wrap, else one value at a time by plain loads,
//     since cp.async takes no 2-byte copy), the first step reads it so, and
//     the last step rounds to bfloat16 once, at its store.
// The last round of tiles is only partly full (1024^2 at 16x32: 2,048 tiles
// over 264 blocks, 7.76 rounds).
//
// Interface: plain C, as csrc/d2q9_kstep.cu; returns cudaGetLastError() after
// every launch and allocates nothing.

#include <string.h>

#include <type_traits>

#include "d2q9_box.cuh"
#include "tile_copy.cuh"

namespace {

using namespace d2q9;

// Mask bytes of a region that one thread carries in registers on the thread
// path: the region may hold at most kMaskRegs * kThreads cells
// (d2q9_kstep_manual.MAX_REGION_CELLS).
constexpr int kMaskRegs = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of region g's nine planes into stage (plane stride
// g.plane, row stride g.rw).
template <typename T>
__device__ __forceinline__ void issue_region(const T* f, T* stage, const Tiles& t,
                                             const Region& g) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte copy
  const size_t gplane = (size_t)t.ny * t.nx;
  const int k = t.k;
  const int cstart = g.c0 - k;
  const bool vec = cstart >= 0 && g.c0 + g.tw + k <= t.nx && t.nx % V == 0 && cstart % V == 0
                   && g.rw % V == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  if (vec) {
    const int nv = g.rw / V;
    const float inv_nv = 1.0f / nv, inv_rh = 1.0f / g.rh;
    for (int idx = threadIdx.x; idx < 9 * g.rh * nv; idx += kThreads) {
      const int row = div_small(idx, inv_nv);
      const int v = idx - row * nv;
      const int q = div_small(row, inv_rh);
      const int r = row - q * g.rh;
      const int gr = wrap(g.r0 - k + r, t.ny);
      cp_async16(stage + q * g.plane + r * g.rw + v * V,
                 f + q * gplane + (size_t)gr * t.nx + cstart + v * V);
    }
  } else if (sizeof(T) == 2 && cstart % 2 == 0 && g.rw % 2 == 0 && t.nx % 2 == 0 &&
             reinterpret_cast<uintptr_t>(f) % 4 == 0) {
    // bfloat16 in pairs: cp.async copies 4, 8 or 16 bytes. An even column
    // of an even-width grid starts a pair that does not wrap.
    const int np = g.rw / 2;
    const float inv_np = 1.0f / np, inv_rh = 1.0f / g.rh;
    for (int idx = threadIdx.x; idx < 9 * g.rh * np; idx += kThreads) {
      const int row = div_small(idx, inv_np);
      const int v = idx - row * np;
      const int q = div_small(row, inv_rh);
      const int r = row - q * g.rh;
      const int gr = wrap(g.r0 - k + r, t.ny);
      cp_async<4>(stage + q * g.plane + r * g.rw + 2 * v,
                  f + q * gplane + (size_t)gr * t.nx + wrap(cstart + 2 * v, t.nx));
    }
  } else {
    const float inv_plane = 1.0f / g.plane, inv_rw = 1.0f / g.rw;
    for (int idx = threadIdx.x; idx < 9 * g.plane; idx += kThreads) {
      const int q = div_small(idx, inv_plane);
      const int cell = idx - q * g.plane;
      const int r = div_small(cell, inv_rw);
      const int c = cell - r * g.rw;
      const int gr = wrap(g.r0 - k + r, t.ny);
      const int gc = wrap(g.c0 - k + c, t.nx);
      if constexpr (sizeof(T) >= 4)
        cp_async<sizeof(T)>(stage + idx, f + q * gplane + (size_t)gr * t.nx + gc);
      else  // a single bfloat16 by the thread itself, ordered by the round's barrier
        stage[idx] = f[q * gplane + (size_t)gr * t.nx + gc];
    }
  }
}

// Region g's mask bytes into this thread's registers (cells tid + i*kThreads).
__device__ __forceinline__ void load_mask(const uint8_t* mask, const Tiles& t, const Region& g,
                                          uint8_t (&regs)[kMaskRegs]) {
  const float inv_rw = 1.0f / g.rw;
#pragma unroll
  for (int i = 0; i < kMaskRegs; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < g.plane) {
      const int r = div_small(idx, inv_rw);
      const int c = idx - r * g.rw;
      regs[i] = mask[(size_t)wrap(g.r0 - t.k + r, t.ny) * t.nx + wrap(g.c0 - t.k + c, t.nx)];
    }
  }
}

__device__ __forceinline__ void store_mask(uint8_t* m, int plane,
                                           const uint8_t (&regs)[kMaskRegs]) {
#pragma unroll
  for (int i = 0; i < kMaskRegs; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < plane) m[idx] = regs[i];
  }
}

// Values of one shared-memory buffer, rounded up to 16 bytes so that every
// buffer starts aligned for cp.async.
template <typename T>
__host__ __device__ __forceinline__ int buffer_values(const Tiles& t) {
  constexpr int V = 16 / sizeof(T);
  return (9 * t.full_plane() + V - 1) / V * V;
}

// The kernel's region for a tile index, in B2's row-major tile order.
template <bool kEdge>
__device__ __forceinline__ Region tile_region(const Tiles& t, int tile) {
  return region_of<kEdge>(t, tile / t.ntx(), tile % t.ntx());
}

// The thread path. T is the storage type. The buffers hold values of the
// compute type C: a stage receives its region in T (a bfloat16 region fills
// the first half of it), the first step reads it so and writes C, and the
// steps after it run between C buffers; the last rounds to T at its store.
template <typename T, int kMode, bool kEdge>
__global__ void __launch_bounds__(kThreads, 2)
manual_kernel(const T* __restrict__ f, const uint8_t* __restrict__ mask, T* __restrict__ out,
              typename storage::Compute<T>::type* __restrict__ partials, Tiles t, Window win,
              int accel_row, Coef<typename storage::Compute<T>::type> p) {
  using C = typename storage::Compute<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = t.k;
  const int nbuf = buffer_values<C>(t);
  C* const stage0 = reinterpret_cast<C*>(smem_raw);
  C* const stage1 = stage0 + nbuf;
  C* const work = stage1 + nbuf;
  C* const red = work + nbuf;  // 2 * kWarps, alternating by step parity
  uint8_t* const mask0 = reinterpret_cast<uint8_t*>(red + 2 * kWarps);
  uint8_t* const mask1 = mask0 + t.full_plane();
  uint8_t* const row_flag = mask1 + t.full_plane();
  uint8_t* const col_flag = row_flag + t.th + 2 * k;

  const int tid = threadIdx.x;
  const int ntiles = t.nty() * t.ntx();
  uint8_t mregs[kMaskRegs];

  int tile = blockIdx.x;  // the grid never exceeds the tile count
  Region g = tile_region<kEdge>(t, tile);
  issue_region<T>(f, reinterpret_cast<T*>(stage0), t, g);
  cp_async_commit();
  load_mask(mask, t, g, mregs);
  store_mask(mask0, g.plane, mregs);

  for (int round = 0; tile < ntiles; ++round, tile += gridDim.x) {
    const bool odd = round & 1;
    C* const stage = odd ? stage1 : stage0;
    const T* const staged = reinterpret_cast<const T*>(stage);  // the region as it landed
    const uint8_t* const m = odd ? mask1 : mask0;
    const int next = tile + gridDim.x;
    Region gn = g;
    if (next < ntiles) {
      gn = tile_region<kEdge>(t, next);
      issue_region<T>(f, reinterpret_cast<T*>(odd ? stage0 : stage1), t, gn);
      load_mask(mask, t, gn, mregs);
    }
    cp_async_commit();  // an empty group on the last round keeps the count
    cp_async_wait_one();  // this tile's group has landed (for this thread)
    set_flags(t, g, win, accel_row, row_flag, col_flag);
    __syncthreads();  // ... and for every thread; flags set

    if constexpr (kMode == kCopy) {
      store_interior(staged, out, t, g);
      if (tid == 0)
        for (int j = 0; j < k; ++j) partials[(size_t)j * ntiles + tile] = C(0);
      __syncthreads();  // the stage is refilled in the next round
    } else {
      C* src = stage;
      C* dst = work;
      for (int j = 1; j <= k; ++j) {
        // the first step reads the stage as it landed; the last step's
        // region is the tile: straight to device memory
        C acc;
        if (j == 1)
          acc = j < k
              ? step_region<T, C, C, kMode, false>(staged, dst, m, row_flag, col_flag, t, g, j, p)
              : step_region<T, T, C, kMode, true>(staged, out, m, row_flag, col_flag, t, g, j, p);
        else
          acc = j < k
              ? step_region<C, C, C, kMode, false>(src, dst, m, row_flag, col_flag, t, g, j, p)
              : step_region<C, T, C, kMode, true>(src, out, m, row_flag, col_flag, t, g, j, p);
        // the barrier inside block_sum orders this step's writes before the
        // next step's reads, and the last step's reads of the stage before
        // the next round refills it
        const C tot = block_sum<C>(acc, red + (j & 1) * kWarps);
        if (tid == 0) partials[(size_t)(j - 1) * ntiles + tile] = tot;
        C* tmp = src;
        src = dst;
        dst = tmp;
      }
    }
    if (next < ntiles) store_mask(odd ? mask0 : mask1, gn.plane, mregs);
    g = gn;
  }
}


// -------------------------------------------------------------- box path ----

// The tensor maps of a box-path launch, one __grid_constant__ parameter.
struct Maps {
  CUtensorMap in;   // f as (9, ny, nx), box (9, rh, rw): a region
  CUtensorMap out;  // out as (9, ny, nx), box (9, th, tw): a tile
};

// Byte offsets of the box path's shared memory from its 128-byte aligned
// base, each on 128 bytes: state buffer i (0..2) at i * buf, the mask plane
// of round r at mask + (r & 1) * mask_bytes, the three mbarriers (one a
// buffer) at bar, the reduction scratch at red, the row flags at flags and
// the column flags after them; `total` counts 128 bytes of slack to align
// the base (mirrored by d2q9_kstep_manual.box_smem_layout).
struct BoxSmem {
  int buf, mask, mask_bytes, bar, red, flags, total;
};

__host__ __device__ inline BoxSmem box_smem(const Tiles& t, int elem) {
  const int rh = t.th + 2 * t.k, rw = t.tw + 2 * t.k;
  BoxSmem s;
  s.buf = round_up(9 * rh * rw * elem, 128);
  s.mask_bytes = round_up(rh * rw, 128);
  s.mask = 3 * s.buf;
  s.bar = s.mask + 2 * s.mask_bytes;
  s.red = s.bar + 128;
  s.flags = s.red + round_up(2 * kWarps * elem, 128);
  s.total = 128 + s.flags + round_up(rh + rw, 128);
  return s;
}

// Whether a region's mask moves in 4-byte words: mask rows, tile columns and
// K on 4 bytes. Then every word of the region is 4 bytes in one row of the
// mask, also where the region wraps (nx is a multiple of 4).
__device__ __forceinline__ bool mask_words(const Tiles& t, const uint8_t* mask) {
  return (t.nx | t.tw | t.k) % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
}

// Region g's mask into the plane m: in words by cp.async, which complete at
// the caller's next cp_async_wait_all; else byte by byte, synchronously.
__device__ __forceinline__ void load_mask_plane(const uint8_t* mask, const Tiles& t,
                                                const Region& g, uint8_t* m, bool words) {
  const int k = t.k;
  if (words) {
    const int per_row = g.rw / 4;
    const float inv = 1.0f / per_row;
    for (int idx = threadIdx.x; idx < g.rh * per_row; idx += kThreads) {
      const int r = div_small(idx, inv);
      const int w = idx - r * per_row;
      cp_async<4>(m + r * g.rw + 4 * w, mask + (size_t)wrap(g.r0 - k + r, t.ny) * t.nx
                                                + wrap(g.c0 - k + 4 * w, t.nx));
    }
  } else {
    const float inv_rw = 1.0f / g.rw;
    for (int idx = threadIdx.x; idx < g.plane; idx += kThreads) {
      const int r = div_small(idx, inv_rw);
      const int c = idx - r * g.rw;
      m[idx] = mask[(size_t)wrap(g.r0 - k + r, t.ny) * t.nx + wrap(g.c0 - k + c, t.nx)];
    }
  }
}

// One thread: region g of f as one box into stage, completing on bar.
__device__ __forceinline__ void issue_box(const CUtensorMap* in, void* stage, uint64_t* bar,
                                          const Tiles& t, const Region& g, uint32_t bytes) {
  tile_copy::mbar_expect_tx(bar, bytes);
  tile_copy::box_load(in, stage, bar, g.c0 - t.k, g.r0 - t.k, 0);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
manual_box_kernel(const __grid_constant__ Maps maps, const T* f, const uint8_t* __restrict__ mask,
                  T* __restrict__ partials, Tiles t, Window win, int accel_row, Coef<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = t.k;
  const BoxSmem at = box_smem(t, sizeof(T));
  unsigned char* const base = tile_copy::align128<unsigned char>(smem_raw);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(base + at.bar);  // bar[i]: buffer i
  T* const red = reinterpret_cast<T*>(base + at.red);  // 2 * kWarps, alternating by step parity
  uint8_t* const row_flag = base + at.flags;
  uint8_t* const col_flag = row_flag + t.th + 2 * k;
  const auto buffer = [&](int i) { return reinterpret_cast<T*>(base + i * at.buf); };
  // the mask plane of round r is plane r & 1
  const auto mask_plane = [&](int round) { return base + at.mask + (round & 1) * at.mask_bytes; };

  const int tid = threadIdx.x;
  const int ntiles = t.nty() * t.ntx();
  const uint32_t region_bytes = (uint32_t)(9 * t.full_plane() * sizeof(T));
  const bool words = mask_words(t, mask);
  // The three buffers rotate. In each round `reg` holds the tile's region
  // (landed by its box), `dns` the previous tile's dense tile, which its box
  // store may still be reading and which the steps take as their work
  // buffer once that read is over, and `fre` nothing: the next region's box
  // goes there at once. The last step leaves the dense tile in `reg` (K
  // even) or in `dns` (K odd, and the copy mode), which becomes the next
  // round's `dns`; `fre` becomes its `reg`.
  int reg = 0, dns = 1, fre = 2;
  // The mbarrier of buffer i completes once for every region the buffer
  // receives, and a buffer receives its next region only after the wait on
  // this one: bit i of `phases` is the parity of its next completion.
  uint32_t phases = 0;

  int tile = blockIdx.x;  // the grid never exceeds the tile count
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) tile_copy::mbar_init(&bar[i], 1);
    issue_box(&maps.in, buffer(reg), &bar[reg], t, tile_region<false>(t, tile), region_bytes);
  }
  load_mask_plane(mask, t, tile_region<false>(t, tile), mask_plane(0), words);
  cp_async_commit();
  __syncthreads();  // the mbarriers are initialised before anyone waits on them

  for (int round = 0; tile < ntiles; ++round, tile += gridDim.x) {
    const Region g = tile_region<false>(t, tile);
    const int next = tile + gridDim.x;
    // `fre` was last read and written by the threads in an earlier round,
    // whose steps ended at a barrier after the fence that orders their
    // writes before the async proxy; a box store that read it was waited on
    // before the last round's steps. On the last round nothing is issued:
    // the empty cp.async group below keeps the wait on this tile's mask
    // exact.
    if (tid == 0 && next < ntiles)
      issue_box(&maps.in, buffer(fre), &bar[fre], t, tile_region<false>(t, next), region_bytes);
    // the next round's mask plane was last read by the last round's steps
    if (next < ntiles)
      load_mask_plane(mask, t, tile_region<false>(t, next), mask_plane(round + 1), words);
    cp_async_commit();
    set_flags(t, g, win, accel_row, row_flag, col_flag);
    cp_async_wait_one();  // this tile's mask (all but the group just committed)
    tile_copy::mbar_wait(&bar[reg], (phases >> reg) & 1u);
    phases ^= 1u << reg;
    // the strips that wrap around the grid, which the box filled with zeros
    T* const region = buffer(reg);
    const Strips st = strips_of<false>(t, g);
    const int nstrip = strip_cells(st);
    for (int i = tid; i < nstrip; i += kThreads) {
      T v[9];
      const int cell = load_strip_cell<T, false>(f, nullptr, nullptr, t, g, st, i, v);
#pragma unroll
      for (int q = 0; q < 9; ++q) region[q * g.plane + cell] = v[q];
    }
    // the previous tile's box store has read `dns` before the steps write it
    if (tid == 0) tile_copy::bulk_wait_read<0>();
    __syncthreads();  // region, strips, mask, flags and that read, for every thread

    // K steps between `reg` and `dns`; the last writes the tile dense,
    // (9, th, tw), into the one the step before left free
    const uint8_t* const m = mask_plane(round);
    const int tile_plane = g.th * g.tw;
    T* src = region;
    T* dst = buffer(dns);
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
      tile_copy::fence_proxy_async();  // the dense tile and the strips, before the async proxy
      if (tid == 0)
        for (int j = 0; j < k; ++j) partials[(size_t)j * ntiles + tile] = T(0);
      __syncthreads();
    } else {
      const Tiles dense{g.th, g.tw, t.th, t.tw, k};  // the tile as a (9, th, tw) "grid"
      Region at_origin = g;
      at_origin.r0 = at_origin.c0 = 0;
      for (int j = 1; j <= k; ++j) {
        T acc;
        if (j < k) {
          acc = step_region<T, T, T, kMode, false>(src, dst, m, row_flag, col_flag, t, g, j, p);
        } else {
          acc = step_region<T, T, T, kMode, true>(src, dst, m, row_flag, col_flag, dense, at_origin,
                                            j, p);
          // every generic write of this round (strips, steps, the dense
          // tile), before the box store reads the tile and a later box
          // overwrites a buffer
          tile_copy::fence_proxy_async();
        }
        // the barrier inside block_sum orders this step's writes of dst
        // before the next step's reads (and the box store), and this
        // round's reads of every buffer before a later box refills it
        const T tot = block_sum<T>(acc, red + (j & 1) * kWarps);
        if (tid == 0) partials[(size_t)(j - 1) * ntiles + tile] = tot;
        T* tmp = src;
        src = dst;
        dst = tmp;
      }
    }
    if (tid == 0) {
      tile_copy::box_store(&maps.out, src, g.c0, g.r0, 0);
      tile_copy::bulk_commit();
    }
    const int dense_at = src == region ? reg : dns;
    reg = fre;
    fre = 3 - reg - dense_at;
    dns = dense_at;
  }
  // the last store has read its tile before the block's shared memory goes
  if (tid == 0) tile_copy::bulk_wait_read<0>();
}

// Mirrored by d2q9_kstep_manual.smem_bytes on the Python side: the buffers
// hold the compute type.
template <typename T>
size_t smem_bytes(const Tiles& t) {
  using C = typename storage::Compute<T>::type;
  const size_t plane = t.full_plane();
  return 3 * (size_t)buffer_values<C>(t) * sizeof(C) + 2 * kWarps * sizeof(C) + 2 * plane
         + (t.th + 2 * t.k) + (t.tw + 2 * t.k);
}

// A bfloat16 state runs on the thread path only: the box path lands regions
// in shared memory as they are stored, where its steps need float.
template <typename T>
constexpr bool kHasBoxPath = !std::is_same<T, __nv_bfloat16>::value;

// The kernel of a launch: the box path's, or the thread path's at kEdge
// (null for a path the type does not have).
template <typename T, int kMode>
const void* kernel_of(int path, bool edge) {
  if (path == kBoxPath) {
    if constexpr (kHasBoxPath<T>) return (const void*)manual_box_kernel<T, kMode>;
    return nullptr;
  }
  return edge ? (const void*)manual_kernel<T, kMode, true>
              : (const void*)manual_kernel<T, kMode, false>;
}

// Blocks of the persistent grid: as many as are resident at once, at most
// one per tile. Returns 0 on an error of the occupancy query.
int grid_blocks(const void* kernel, const Tiles& t, size_t smem) {
  if (kernel == nullptr ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int per_sm = 0, device = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const int ntiles = t.nty() * t.ntx();
  return per_sm * sms < ntiles ? per_sm * sms : ntiles;
}

// Shared memory of a launch on `path`.
template <typename T>
size_t launch_smem(int path, const Tiles& t) {
  return path == kBoxPath && kHasBoxPath<T> ? (size_t)box_smem(t, sizeof(T)).total
                                            : smem_bytes<T>(t);
}

// Whether the box path takes this launch (mirrored by
// d2q9_kstep_manual.choose_path): B2's layout rule and the block in shared
// memory.
bool box_fits(const Tiles& t, int elem, const void* f, const void* out) {
  return box_layout_fits(t, elem, f, out) && (size_t)box_smem(t, elem).total <= kSmemPerBlock;
}

template <typename T, int kMode>
int launch_mode(const void* f, const void* mask, void* out, void* partials, void* tot, int path,
                Tiles t, Window win, int accel_row, double omega, double w1, double w2,
                cudaStream_t stream) {
  using C = typename storage::Compute<T>::type;
  if (path != kBoxPath && path != kThreadPath) return (int)cudaErrorInvalidValue;
  if (path == kBoxPath && !kHasBoxPath<T>) return (int)cudaErrorInvalidValue;
  const Coef<C> p{C(omega), C(1.0 - omega), C(w1), C(w2)};
  const size_t smem = launch_smem<T>(path, t);
  const void* kernel = kernel_of<T, kMode>(path, has_edges(t));
  Maps maps;
  if (path == kBoxPath) {
    // the shape and alignment decide the path before the launch; a launch
    // that breaks TMA's rules or whose maps do not encode is refused
    if (!box_fits(t, sizeof(T), f, out)) return (int)cudaErrorInvalidValue;
    memset(&maps, 0, sizeof maps);
    const int e = sizeof(T), rh = t.th + 2 * t.k, rw = t.tw + 2 * t.k;
    int rc = tile_copy::encode_map(&maps.in, {f, e, 9, t.ny, t.nx, 9, rh, rw});
    if (!rc) rc = tile_copy::encode_map(&maps.out, {out, e, 9, t.ny, t.nx, 9, t.th, t.tw});
    if (rc) return rc;
  }
  const int blocks = grid_blocks(kernel, t, smem);
  if (blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const T* tf = static_cast<const T*>(f);
  const uint8_t* tm = static_cast<const uint8_t*>(mask);
  C* tp = static_cast<C*>(partials);
  if (path == kBoxPath) {
    if constexpr (kHasBoxPath<T>)
      manual_box_kernel<T, kMode><<<blocks, kThreads, smem, stream>>>(maps, tf, tm, tp, t, win,
                                                                       accel_row, p);
  } else if (has_edges(t))
    manual_kernel<T, kMode, true><<<blocks, kThreads, smem, stream>>>(
        tf, tm, static_cast<T*>(out), tp, t, win, accel_row, p);
  else
    manual_kernel<T, kMode, false><<<blocks, kThreads, smem, stream>>>(
        tf, tm, static_cast<T*>(out), tp, t, win, accel_row, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<C><<<t.k, kThreads, 0, stream>>>(tp, t.nty() * t.ntx(),
                                                       static_cast<C*>(tot));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* f, const void* mask, void* out, void* partials, void* tot, int path,
           Tiles t, Window win, int accel_row, int mode, double omega, double w1, double w2,
           cudaStream_t stream) {
  switch (mode) {
    case kFull:
      return launch_mode<T, kFull>(f, mask, out, partials, tot, path, t, win, accel_row, omega,
                                   w1, w2, stream);
    case kStreamOnly:
      return launch_mode<T, kStreamOnly>(f, mask, out, partials, tot, path, t, win, accel_row,
                                         omega, w1, w2, stream);
    case kCopy:
      return launch_mode<T, kCopy>(f, mask, out, partials, tot, path, t, win, accel_row, omega,
                                   w1, w2, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int blocks_of(int ny, int nx, int th, int tw, int k, int mode, int path) {
  const Tiles t{ny, nx, th, tw, k};
  const size_t smem = launch_smem<T>(path, t);
  const bool edge = has_edges(t);
  switch (mode) {
    case kFull:
      return grid_blocks(kernel_of<T, kFull>(path, edge), t, smem);
    case kStreamOnly:
      return grid_blocks(kernel_of<T, kStreamOnly>(path, edge), t, smem);
    case kCopy:
      return grid_blocks(kernel_of<T, kCopy>(path, edge), t, smem);
  }
  return 0;
}

}  // namespace

extern "C" {

// B3: out = K steps of f (out must not alias f); tot[K] per-step Sum|u|;
// partials holds K * ceil(ny/th) * ceil(nx/tw) values of scratch, in B2's
// tile order. path is a Path (d2q9_kstep_manual.PATHS), mode a d2q9::Mode.
// On the thread path the region (th + 2K)(tw + 2K) may hold at most 2,048
// cells.
int d2q9_manual_f32(const void* f, const void* mask, void* out, void* partials, void* tot,
                    int path, D2Q9_ARGS) {
  return launch<float>(f, mask, out, partials, tot, path, D2Q9_PASS);
}
int d2q9_manual_f64(const void* f, const void* mask, void* out, void* partials, void* tot,
                    int path, D2Q9_ARGS) {
  return launch<double>(f, mask, out, partials, tot, path, D2Q9_PASS);
}
// f and out bfloat16, partials and tot float; the thread path only.
int d2q9_manual_bf16(const void* f, const void* mask, void* out, void* partials, void* tot,
                     int path, D2Q9_ARGS) {
  return launch<__nv_bfloat16>(f, mask, out, partials, tot, path, D2Q9_PASS);
}

// Blocks of B3's persistent grid on the current device for this grid, tile,
// K, itemsize (2 for bfloat16, 4 or 8), mode and path; 0 on an error.
int d2q9_manual_blocks(int ny, int nx, int th, int tw, int k, int itemsize, int mode, int path) {
  if (itemsize == 2) return blocks_of<__nv_bfloat16>(ny, nx, th, tw, k, mode, path);
  return itemsize == 8 ? blocks_of<double>(ny, nx, th, tw, k, mode, path)
                       : blocks_of<float>(ny, nx, th, tw, k, mode, path);
}

}  // extern "C"

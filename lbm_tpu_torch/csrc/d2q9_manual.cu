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
// Design, the card's form of the TPU kernel's pipeline:
//   * a persistent grid: as many blocks as fit the SMs at once (the
//     occupancy of this kernel at its shared memory, times the SM count);
//     block b walks the tiles b, b + grid, b + 2 grid, ... in order, the tiles
//     of B2 (csrc/d2q9_kstep.cu), edge tiles included;
//   * two shared-memory stages of a tile's region (9 planes of the tile plus
//     its K halo, wrapped at ny and nx). While the block runs the K steps of
//     tile i from one stage, the region of its next tile is in flight into
//     the other through `cp.async` (16 bytes where the region rows are
//     aligned and do not wrap, else one value at a time), waited for with
//     `cp.async.wait_group 1` at the top of the next round. The mask of the
//     next tile travels in registers: loaded at the top of the round, stored
//     to its stage at the bottom, so its latency is hidden as well;
//   * one work buffer: the steps alternate between the stage (free once step
//     1 has read it) and the work buffer, and the last step writes its tile
//     straight to device memory, so there is no separate write-back to wait
//     for;
//   * the step code, the per-tile reduction and the partials[K, ntiles] slot
//     of each tile are B2's (csrc/d2q9_step.cuh), summed by the same
//     fixed-order kernel: at the same tile and K, B3 equals B2 bit for bit.
// Shared memory: three buffers of 9 x (th + 2K)(tw + 2K) values, two mask
// stages, the flags and the reduction scratch: 105,728 B at 16x32, K=4, f32,
// so two blocks an SM (B2: 70,208 B, three). The last round of tiles is only
// partly full (1024^2 at 16x32: 2,048 tiles over 264 blocks, 7.76 rounds).
//
// Interface: plain C, as csrc/d2q9_kstep.cu; returns cudaGetLastError() after
// every launch and allocates nothing.

#include "d2q9_step.cuh"

namespace {

using namespace d2q9;

// Mask bytes of a region that one thread carries in registers: the region
// may hold at most kMaskRegs * kThreads cells (d2q9_kstep_manual.MAX_REGION_CELLS).
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
  } else {
    const float inv_plane = 1.0f / g.plane, inv_rw = 1.0f / g.rw;
    for (int idx = threadIdx.x; idx < 9 * g.plane; idx += kThreads) {
      const int q = div_small(idx, inv_plane);
      const int cell = idx - q * g.plane;
      const int r = div_small(cell, inv_rw);
      const int c = cell - r * g.rw;
      const int gr = wrap(g.r0 - k + r, t.ny);
      const int gc = wrap(g.c0 - k + c, t.nx);
      cp_async<sizeof(T)>(stage + idx, f + q * gplane + (size_t)gr * t.nx + gc);
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

template <typename T, int kMode, bool kEdge>
__global__ void __launch_bounds__(kThreads, 2)
manual_kernel(const T* __restrict__ f, const uint8_t* __restrict__ mask, T* __restrict__ out,
              T* __restrict__ partials, Tiles t, Window win, int accel_row, Coef<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = t.k;
  const int nbuf = buffer_values<T>(t);
  T* const stage0 = reinterpret_cast<T*>(smem_raw);
  T* const stage1 = stage0 + nbuf;
  T* const work = stage1 + nbuf;
  T* const red = work + nbuf;  // 2 * kWarps, alternating by step parity
  uint8_t* const mask0 = reinterpret_cast<uint8_t*>(red + 2 * kWarps);
  uint8_t* const mask1 = mask0 + t.full_plane();
  uint8_t* const row_flag = mask1 + t.full_plane();
  uint8_t* const col_flag = row_flag + t.th + 2 * k;

  const int tid = threadIdx.x;
  const int ntiles = t.nty() * t.ntx();
  uint8_t mregs[kMaskRegs];

  int tile = blockIdx.x;  // the grid never exceeds the tile count
  Region g = tile_region<kEdge>(t, tile);
  issue_region<T>(f, stage0, t, g);
  cp_async_commit();
  load_mask(mask, t, g, mregs);
  store_mask(mask0, g.plane, mregs);

  for (int round = 0; tile < ntiles; ++round, tile += gridDim.x) {
    const bool odd = round & 1;
    T* const stage = odd ? stage1 : stage0;
    const uint8_t* const m = odd ? mask1 : mask0;
    const int next = tile + gridDim.x;
    Region gn = g;
    if (next < ntiles) {
      gn = tile_region<kEdge>(t, next);
      issue_region<T>(f, odd ? stage0 : stage1, t, gn);
      load_mask(mask, t, gn, mregs);
    }
    cp_async_commit();  // an empty group on the last round keeps the count
    cp_async_wait_one();  // this tile's group has landed (for this thread)
    set_flags(t, g, win, accel_row, row_flag, col_flag);
    __syncthreads();  // ... and for every thread; flags set

    if constexpr (kMode == kCopy) {
      store_interior<T>(stage, out, t, g);
      if (tid == 0)
        for (int j = 0; j < k; ++j) partials[(size_t)j * ntiles + tile] = T(0);
      __syncthreads();  // the stage is refilled in the next round
    } else {
      T* src = stage;
      T* dst = work;
      for (int j = 1; j <= k; ++j) {
        // the last step's region is the tile: straight to device memory
        const T acc = j < k
            ? step_region<T, kMode, false>(src, dst, m, row_flag, col_flag, t, g, j, p)
            : step_region<T, kMode, true>(src, out, m, row_flag, col_flag, t, g, j, p);
        // the barrier inside block_sum orders this step's writes before the
        // next step's reads, and the last step's reads of the stage before
        // the next round refills it
        const T tot = block_sum<T>(acc, red + (j & 1) * kWarps);
        if (tid == 0) partials[(size_t)(j - 1) * ntiles + tile] = tot;
        T* tmp = src;
        src = dst;
        dst = tmp;
      }
    }
    if (next < ntiles) store_mask(odd ? mask0 : mask1, gn.plane, mregs);
    g = gn;
  }
}

// Mirrored by d2q9_kstep_manual.smem_bytes on the Python side.
template <typename T>
size_t smem_bytes(const Tiles& t) {
  const size_t plane = t.full_plane();
  return 3 * (size_t)buffer_values<T>(t) * sizeof(T) + 2 * kWarps * sizeof(T) + 2 * plane
         + (t.th + 2 * t.k) + (t.tw + 2 * t.k);
}

// Blocks of the persistent grid: as many as are resident at once, at most
// one per tile. Returns 0 on an error of the occupancy query.
template <typename T, int kMode, bool kEdge>
int grid_blocks(const Tiles& t, size_t smem) {
  if (cudaFuncSetAttribute(manual_kernel<T, kMode, kEdge>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0, device = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, manual_kernel<T, kMode, kEdge>,
                                                    kThreads, smem) != cudaSuccess
      || cudaGetDevice(&device) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const int ntiles = t.nty() * t.ntx();
  return per_sm * sms < ntiles ? per_sm * sms : ntiles;
}

template <typename T, int kMode, bool kEdge>
int launch_edge(const void* f, const void* mask, void* out, void* partials, void* tot,
                Tiles t, Window win, int accel_row, double omega, double w1, double w2,
                cudaStream_t stream) {
  const Coef<T> p{T(omega), T(1.0 - omega), T(w1), T(w2)};
  const size_t smem = smem_bytes<T>(t);
  const int blocks = grid_blocks<T, kMode, kEdge>(t, smem);
  if (blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  manual_kernel<T, kMode, kEdge><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const uint8_t*>(mask), static_cast<T*>(out),
      static_cast<T*>(partials), t, win, accel_row, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<T><<<t.k, kThreads, 0, stream>>>(
      static_cast<const T*>(partials), t.nty() * t.ntx(), static_cast<T*>(tot));
  return (int)cudaGetLastError();
}

template <typename T, int kMode>
int launch_mode(const void* f, const void* mask, void* out, void* partials, void* tot,
                Tiles t, Window win, int accel_row, double omega, double w1, double w2,
                cudaStream_t stream) {
  return has_edges(t) ? launch_edge<T, kMode, true>(f, mask, out, partials, tot, t, win,
                                                    accel_row, omega, w1, w2, stream)
                      : launch_edge<T, kMode, false>(f, mask, out, partials, tot, t, win,
                                                     accel_row, omega, w1, w2, stream);
}

template <typename T>
int launch(const void* f, const void* mask, void* out, void* partials, void* tot, Tiles t,
           Window win, int accel_row, int mode, double omega, double w1, double w2,
           cudaStream_t stream) {
  switch (mode) {
    case kFull:
      return launch_mode<T, kFull>(f, mask, out, partials, tot, t, win, accel_row, omega, w1,
                                   w2, stream);
    case kStreamOnly:
      return launch_mode<T, kStreamOnly>(f, mask, out, partials, tot, t, win, accel_row, omega,
                                         w1, w2, stream);
    case kCopy:
      return launch_mode<T, kCopy>(f, mask, out, partials, tot, t, win, accel_row, omega, w1,
                                   w2, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int blocks_of(int ny, int nx, int th, int tw, int k, int mode) {
  const Tiles t{ny, nx, th, tw, k};
  const size_t smem = smem_bytes<T>(t);
  const bool edge = has_edges(t);
  switch (mode) {
    case kFull:
      return edge ? grid_blocks<T, kFull, true>(t, smem) : grid_blocks<T, kFull, false>(t, smem);
    case kStreamOnly:
      return edge ? grid_blocks<T, kStreamOnly, true>(t, smem)
                  : grid_blocks<T, kStreamOnly, false>(t, smem);
    case kCopy:
      return edge ? grid_blocks<T, kCopy, true>(t, smem) : grid_blocks<T, kCopy, false>(t, smem);
  }
  return 0;
}

}  // namespace

extern "C" {

// B3: out = K steps of f (out must not alias f); tot[K] per-step Sum|u|;
// partials holds K * ceil(ny/th) * ceil(nx/tw) values of scratch, in B2's
// tile order. The region (th + 2K)(tw + 2K) may hold at most 2,048 cells.
int d2q9_manual_f32(const void* f, const void* mask, void* out, void* partials, void* tot,
                    D2Q9_ARGS) {
  return launch<float>(f, mask, out, partials, tot, D2Q9_PASS);
}
int d2q9_manual_f64(const void* f, const void* mask, void* out, void* partials, void* tot,
                    D2Q9_ARGS) {
  return launch<double>(f, mask, out, partials, tot, D2Q9_PASS);
}

// Blocks of B3's persistent grid on the current device for this grid, tile,
// K, itemsize (4 or 8) and mode; 0 on an error.
int d2q9_manual_blocks(int ny, int nx, int th, int tw, int k, int itemsize, int mode) {
  return itemsize == 8 ? blocks_of<double>(ny, nx, th, tw, k, mode)
                       : blocks_of<float>(ny, nx, th, tw, k, mode);
}

}  // extern "C"

// The copy of a (planes, by, bx) tile of a (planes, ny, nx) state between
// device memory and a block, for NVIDIA Hopper (sm_90a): the core of kernel
// B12 (csrc/copy_floor.cu) and of B11's automatic pipeline (auto_kernel in
// csrc/overlap_probe.cu), the card's form of the TPU's BlockSpec copy.
//
// What bounds a tile copy: bytes, a value read once and written once (72 B
// a D2Q9 cell in float32). Three ways to move a box of the tile:
//   * TMA (the rule where the layout allows it): one thread asks the Tensor
//     Memory Accelerator for the whole box, global -> shared, completing on
//     an mbarrier, and back, shared -> global, in a bulk group. The box is
//     described once by a tensor map over the state (encode_map, cached by
//     pointer and shape); TMA computes every address, fills what lies beyond
//     the grid with zeros on the load and clips it on the store, so the
//     threads spend no instruction on an address and many boxes are in
//     flight on an SM, as many as its shared memory holds. It needs a
//     16-byte aligned base, rows of a multiple of 16 bytes and box rows of a
//     multiple of 16 bytes (nx, bx multiples of 16 / sizeof(T)).
//   * the threads, in registers (copy_box_values): one value a piece, U
//     pieces a thread in flight, for any width and alignment;
//   * the threads, through shared memory (load_box_values /
//     store_box_values): one value at a time, for a box that a block works on
//     in shared memory and TMA cannot move.
// The two thread paths walk a box's flat index with Walk: one division for
// the start and one for the stride, none a piece.
//
// Also the mbarrier and bulk-copy primitives that the explicit pipeline of
// B11 (manual_kernel) uses, and the rank-4 box loads of the blocked D3Q19
// kernels B5 and B7 (csrc/d3q19_blocked.cu).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>

namespace tile_copy {

// tiles of one box side by side in x launched as one thread block cluster
// (launch_tiles)
constexpr unsigned kCluster = 4;

// ------------------------------------------------------------ device ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the first 128-byte aligned address at or after p (TMA's shared boxes)
template <typename T>
__device__ __forceinline__ T* align128(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return reinterpret_cast<T*>(p + ((128u - (a & 127u)) & 127u));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The blocks of a cluster (launch_tiles: tiles side by side in a row) meet
// before they issue their loads, so that the DRAM sees the row segments of
// neighbouring tiles together: 0.8-1.3% of a (9, 16, 32) float32 tile copy
// at 1024^2 and 4096^2 on an H100 (experiments/cuda-kstep-tiles/
// copy_variants.py). Every thread of the block calls it.
__device__ __forceinline__ void cluster_meet() {
  uint32_t blocks;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(blocks));
  if (blocks > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" :::
                     "memory");
}

// generic-proxy writes of shared memory become visible to the next bulk copy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// contiguous bytes, global -> shared, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// contiguous bytes, shared -> global, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// the box of `map` at (x, y, z) (innermost first), global -> shared,
// completing its whole box's bytes on bar (zeros beyond the grid)
__device__ __forceinline__ void box_load(const CUtensorMap* map, void* dst, uint64_t* bar, int x,
                                         int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
        "r"(y), "r"(z)
      : "memory");
}

// the box of a rank-4 `map` at (x, y, z, w) (innermost first), global ->
// shared, completing its whole box's bytes on bar (zeros beyond the grid)
__device__ __forceinline__ void box_load4(const CUtensorMap* map, void* dst, uint64_t* bar, int x,
                                          int y, int z, int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
        "r"(y), "r"(z), "r"(w)
      : "memory");
}

// the box at (x, y, z), shared -> global, clipped to the grid, in this
// thread's current bulk group
__device__ __forceinline__ void box_store(const CUtensorMap* map, const void* src, int x, int y,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The flat index i = start, start + step, ... over a (Q, H, W) box as (q, r,
// c), c fastest: a step adds (sq, sr, sc) with one carry at most a digit.
struct Walk {
  int q, r, c, sq, sr, sc, H, W;
  __device__ __forceinline__ Walk(int start, int step, int H_, int W_) : H(H_), W(W_) {
    const int rs = start / W, ss = step / W;
    c = start - rs * W;
    sc = step - ss * W;
    q = rs / H;
    r = rs - q * H;
    sq = ss / H;
    sr = ss - sq * H;
  }
  __device__ __forceinline__ void next() {
    c += sc;
    r += sr;
    q += sq;
    if (c >= W) {
      c -= W;
      ++r;
    }
    if (r >= H) {
      r -= H;
      ++q;
    }
  }
};

// Where a box lies in the state: value (q, r, c) of the box is at
// base + q * plane + r * nx + c, for r < h and c < w (the box cut to the grid).
struct Box {
  size_t base, plane;
  int nx, h, w;
};

// The block copies the (Q, h, w) box one value a piece, U pieces a thread in
// flight before their stores: any width and alignment. No shared memory.
template <typename T, int U>
__device__ __forceinline__ void copy_box_values(const T* __restrict__ in, T* __restrict__ out,
                                                const Box& b, int Q) {
  const int n = Q * b.h * b.w;
  Walk at(threadIdx.x, blockDim.x, b.h, b.w);
  for (int base = threadIdx.x; base < n; base += U * blockDim.x) {
    T v[U];
    size_t off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      off[u] = base + u * blockDim.x < n
                   ? b.base + at.q * b.plane + (size_t)at.r * b.nx + at.c
                   : SIZE_MAX;
      if (off[u] != SIZE_MAX) v[u] = in[off[u]];
      at.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (off[u] != SIZE_MAX) out[off[u]] = v[u];
  }
}

// The (Q, bh, bw) box into shared memory in its dense layout, one value at a
// time; a value beyond the grid (r >= h or c >= w) is 0, as TMA fills it.
template <typename T>
__device__ __forceinline__ void load_box_values(const T* in, T* stage, const Box& b, int Q,
                                                int bh, int bw) {
  const int n = Q * bh * bw;
  Walk at(threadIdx.x, blockDim.x, bh, bw);
  for (int i = threadIdx.x; i < n; i += blockDim.x, at.next())
    stage[i] = at.r < b.h && at.c < b.w
                   ? in[b.base + at.q * b.plane + (size_t)at.r * b.nx + at.c]
                   : T(0);
}

// The values of the box that lie in the grid, from shared memory back.
template <typename T>
__device__ __forceinline__ void store_box_values(const T* stage, T* out, const Box& b, int Q,
                                                 int bh, int bw) {
  const int n = Q * bh * bw;
  Walk at(threadIdx.x, blockDim.x, bh, bw);
  for (int i = threadIdx.x; i < n; i += blockDim.x, at.next())
    if (at.r < b.h && at.c < b.w) out[b.base + at.q * b.plane + (size_t)at.r * b.nx + at.c] = stage[i];
}

// -------------------------------------------------------------- host ----

// cuTensorMapEncodeTiled, reached through the runtime so that no library
// links against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// What a tensor map describes: a (planes, ny, nx) state of `elem`-byte values
// at `base`, in boxes of (bq, by, bx); with nz > 0, a (planes, nz, ny, nx)
// state in boxes of (bq, bz, by, bx), a map of rank 4. Contiguous either way.
struct MapKey {
  const void* base;
  int elem, planes, ny, nx, bq, by, bx;
  int nz = 0, bz = 0;
  bool operator==(const MapKey& o) const {
    return base == o.base && elem == o.elem && planes == o.planes && ny == o.ny && nx == o.nx &&
           bq == o.bq && by == o.by && bx == o.bx && nz == o.nz && bz == o.bz;
  }
};

// *map = the tensor map of key, encoded once and then taken from a small
// cache (a pass ping-pongs two buffers, so a run needs a few maps). Returns 0
// or a cudaError_t: the layout breaks a rule of TMA, or no driver entry.
inline int encode_map(CUtensorMap* map, const MapKey& key) {
  constexpr int kSlots = 32;
  static std::mutex lock;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return 0;
    }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const bool rank4 = key.nz > 0;
  const cuuint64_t row = (cuuint64_t)key.nx * key.elem, plane = row * key.ny;
  const cuuint64_t dims[4] = {(cuuint64_t)key.nx, (cuuint64_t)key.ny,
                              (cuuint64_t)(rank4 ? key.nz : key.planes), (cuuint64_t)key.planes};
  const cuuint64_t strides[3] = {row, plane, plane * (rank4 ? key.nz : 1)};
  const cuuint32_t box[4] = {(cuuint32_t)key.bx, (cuuint32_t)key.by,
                             (cuuint32_t)(rank4 ? key.bz : key.bq), (cuuint32_t)key.bq};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      key.elem == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap m;
  if (encode(&m, type, rank4 ? 4 : 3, const_cast<void*>(key.base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int slot = used < kSlots ? used++ : next;
  next = (slot + 1) % kSlots;
  keys[slot] = key;
  maps[slot] = m;
  *map = m;
  return 0;
}

// kernel<<<grid, threads, smem, stream>>>(args...), the blocks of a row of
// tiles in clusters of kCluster where `cluster` (a tile of one box) and the
// row holds a multiple of it (one a cluster otherwise): a block that streams
// a ring of boxes lost 5-8% at 1024^2 in clusters (copy_variants.py).
template <typename... P, typename... A>
inline cudaError_t launch_tiles(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                                cudaStream_t stream, bool cluster, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = cluster && grid.x % kCluster == 0 ? kCluster : 1;
  dims.val.clusterDim.y = 1;
  dims.val.clusterDim.z = 1;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

// Sets the dynamic shared memory that `kernel` may use to exactly `bytes`
// unless `last` says it is so already: a cluster launch was refused on the
// card while a larger limit was left from an earlier launch.
template <typename K>
inline cudaError_t fit_smem(K kernel, size_t bytes, size_t& last) {
  if (bytes == last) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) last = bytes;
  return err;
}

// Whether TMA takes boxes of (bq, by, bx) over this layout.
inline bool tma_fits(const void* a, const void* b, int elem, int nx, int bq, int by, int bx) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         ((size_t)nx * elem) % 16 == 0 && ((size_t)bx * elem) % 16 == 0 && bx <= 256 &&
         by <= 256 && bq <= 256 && bx > 0 && by > 0 && bq > 0;
}

}  // namespace tile_copy

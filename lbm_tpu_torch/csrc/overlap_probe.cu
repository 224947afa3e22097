// The D2Q9 overlap probes, for NVIDIA Hopper (sm_90a): kernel B11.
//
// Replaces the eight Pallas TPU kernels of experiments/d2q9-overlap/probe.py
// (`build_auto`, `build_manual`, `build_manual_depth`, `build_manual_flat`,
// `build_auto_flat`, `build_manual_alias`, `build_auto_alias`,
// `build_manual_alias_safe`). Each moves the bytes of a D2Q9 pass, a (9, ny,
// nx) float32 state read once and written once, and in place of the LBM
// arithmetic runs R dependent rounds of v * 1.0001 + 0.0001 on every value.
// Timing wall(R) then shows whether the copy and the arithmetic overlap
// (wall ~ max(copy, compute)) or run in series (wall ~ copy + compute).
//
// What bounds it on this card: 72 bytes a cell (2 x 9 float32) against 2R
// float32 operations a value. Each round rounds its product and its sum
// apart (__fmul_rn, __fadd_rn, so every instance equals the plain version bit
// for bit), so the card issues them as two instructions, not one FMA: the
// byte bound and the operation bound cross near R = 40 at 4096^2.
//
// Two kernel families:
//   * auto_kernel<Halo, Smem, Tma>, the "automatic pipeline": one block a
//     (planes, by, bx) tile, which csrc/tile_copy.cuh moves as B12's TMA
//     path does: one TMA load of the whole tile into shared memory (18,432 B
//     at (9, 16, 32)), the R rounds taken shared -> registers -> shared, one
//     TMA store, waited with cp.async.bulk.wait_group.read before the block
//     retires. Where TMA cannot (nx % 4 != 0, unaligned buffers) the threads
//     move the tile one value at a time. A block waits only on its own
//     tile's load; the overlap comes from the other blocks resident on the
//     SM (11 at 128 threads and 18,560 B), the card's form of the TPU's grid
//     pipeline; four tiles side by side are one cluster, whose blocks meet
//     before their loads (tile_copy::launch_tiles). At R = 0 the tile goes
//     back as it came, with no thread touching it: the byte bound (72 B a
//     cell) is the whole of the work,
//     and no thread spends an instruction on an address or a division.
//     `auto_flat` is the same kernel over the (9 ny, nx) view with one plane
//     and tiles of 9 by rows; `auto_alias` is it with out == in. Halo adds
//     input rows band_start - 1 and band_end (mod ny) to a band's first and
//     last rows, in shared memory after the rounds. Smem writes a per-band
//     partial of f[0, band_start, :128] (a warp: four values a lane in order,
//     then a shuffle tree), summed over the bands in band order by
//     sum_partials_kernel, one thread: no float atomics.
//   * manual_kernel<Depth, Flat, Safe, Box>, the explicit pipeline: a
//     persistent grid (as many blocks as are resident at once, like B3);
//     block b walks the tiles b, b + grid, ... in band order through a ring
//     of Depth shared-memory stages, each with an input and an output slot
//     of one tile. Warp 0 issues the copies global -> shared, completing on
//     the stage's mbarrier, Depth - 1 tiles ahead; then shared -> global
//     (bulk_group), drained Depth tiles behind with
//     cp.async.bulk.wait_group.read, as probe.py's out_sem waits. A stage
//     moves in one of two ways ("paths"):
//       - Box (the rule where TMA takes the shape: the state's rows and the
//         tile's of whole 16-byte pieces, sides of at most 256, 16-byte
//         aligned buffers): the strided (9, by, bx) tile is ONE TMA box each
//         way, through a tensor map over the (9, ny, nx) state and one over
//         out (tile_copy::encode_map), the card's form of the TPU stage's one
//         strided descriptor over the nine planes (probe.py:140-150). Edge
//         tiles come zero-filled and go back clipped;
//       - bulk: one Hopper bulk copy (cp.async.bulk) per row segment of the
//         strided tile (9 by copies: 144 of 128 B at 16x32, 9 of 2 KB at
//         1x512, whose 512 columns no box takes), or one contiguous chunk of
//         9 by bx values a stage over the flat view (Flat, the TPU's "9
//         strided descriptors against 1"). A bulk copy needs 16-byte
//         alignment and a multiple of 16 bytes: nx % 4 == 0, bx % 4 == 0 and
//         16-byte aligned pointers (the wrapper checks them).
//     Safe issues tile i's write only after tile i+1's fetch has landed
//     (probe.py:483-493). The aliased engines pass out == in: nothing else
//     differs, so aliasing is no template parameter.
// Shared memory of manual_kernel: each stage slot on 128 bytes (TMA's
// boxes), 128 B of slack to align the base, 2 x Depth slots of 9 x by x bx
// x 4 B and the barriers; at 16x32 or 1x512, 73,872 B at Depth 2 (three
// blocks an SM) up to 221,360 B at Depth 6 (one).
//
// Interface: plain C; launches on the given stream and returns
// cudaGetLastError(); allocates nothing.

#include "tile_copy.cuh"

namespace {

using tile_copy::Box;

constexpr int kThreads = 384;      // manual_kernel
constexpr int kUnroll = 3;         // 16-byte pieces a thread in flight in a pass over a stage
constexpr int kAutoThreads = 128;  // auto_kernel: 11 tiles of 18,432 B an SM
constexpr int kSmemCols = 128;     // the smem trait sums f[0, band_start, :128]

struct Grid {
  int planes, ny, nx, by, bx;
};

__device__ __forceinline__ float round1(float v) {
  return __fadd_rn(__fmul_rn(v, 1.0001f), 0.0001f);
}

__device__ __forceinline__ void rounds_on(float4 (&v)[kUnroll], int rounds) {
  for (int k = 0; k < rounds; ++k) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u].x = round1(v[u].x);
      v[u].y = round1(v[u].y);
      v[u].z = round1(v[u].z);
      v[u].w = round1(v[u].w);
    }
  }
}

// all threads: out_stage = R rounds of in_stage, n values of shared memory
// (16-byte pieces, then the last n % 4 one at a time); in place if the two
// are one
template <int kBlock>
__device__ __forceinline__ void work_stage(const float* in_stage, float* out_stage, int n,
                                           int rounds) {
  const float4* src = reinterpret_cast<const float4*>(in_stage);
  float4* dst = reinterpret_cast<float4*>(out_stage);
  const int n4 = n / 4;
  for (int base = threadIdx.x; base < n4; base += kBlock * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kBlock;
      v[u] = idx < n4 ? src[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    rounds_on(v, rounds);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kBlock;
      if (idx < n4) dst[idx] = v[u];
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kBlock) {
    float v = in_stage[i];
    for (int k = 0; k < rounds; ++k) v = round1(v);
    out_stage[i] = v;
  }
}

// ---------------------------------------------------------------- auto ----

// The halo trait on a tile in shared memory: input rows band_start - 1 and
// band_end (mod ny) added to each band's first and last rows in the tile.
__device__ __forceinline__ void add_halo(float* tile, const float* in, const Grid& g, int band,
                                         int r0, int c0, int h, int w) {
  const size_t plane = (size_t)g.ny * g.nx;
  const int per_row = g.planes * w;
  for (int r = 0; r < h; ++r) {
    const int row = r0 + r, in_band = row % band;
    if (in_band != 0 && in_band != band - 1) continue;
    const int src_row = in_band == 0 ? (row - 1 + g.ny) % g.ny : (row + 1) % g.ny;
    for (int i = threadIdx.x; i < per_row; i += blockDim.x) {
      const int q = i / w, c = i - q * w;
      float& v = tile[(q * g.by + r) * g.bx + c];
      v = __fadd_rn(v, in[q * plane + (size_t)src_row * g.nx + c0 + c]);
    }
  }
}

// One block a (planes, by, bx) tile: the tile into shared memory (one TMA
// load, or the threads one value at a time where TMA cannot), the R rounds
// and the halo rows there, the tile back (one TMA store, or the threads).
// A block waits only on its own tile's load; the overlap comes from the
// other tiles resident on the SM.
template <bool kHalo, bool kSmem, bool kTma>
__global__ void __launch_bounds__(kAutoThreads)
auto_kernel(__grid_constant__ const CUtensorMap src, __grid_constant__ const CUtensorMap dst,
            const float* in, float* out, float* partials, Grid g, int band, int rounds) {
  extern __shared__ unsigned char smem_raw[];
  tile_copy::cluster_meet();
  float* tile = tile_copy::align128<float>(smem_raw);
  const int n = g.planes * g.by * g.bx;
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + n);  // n * 4 B: a multiple of 16
  const int r0 = blockIdx.y * g.by, c0 = blockIdx.x * g.bx;
  const int h = min(g.by, g.ny - r0), w = min(g.bx, g.nx - c0);
  const Box b{(size_t)r0 * g.nx + c0, (size_t)g.ny * g.nx, g.nx, h, w};
  if (kTma) {
    if (threadIdx.x == 0) {
      tile_copy::mbar_init(full, 1);
      tile_copy::mbar_expect_tx(full, (uint32_t)n * 4);
      tile_copy::box_load(&src, tile, full, c0, r0, 0);
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    tile_copy::mbar_wait(full, 0);
  } else {
    tile_copy::load_box_values(in, tile, b, g.planes, g.by, g.bx);
    __syncthreads();
  }
  // does the tile hold a band's first or last row?
  const bool edge_rows = kHalo && ((r0 + band - 1) / band * band < r0 + h ||
                                   (r0 + 1 + band - 1) / band * band < r0 + h + 1);
  if (rounds > 0 || edge_rows) {
    work_stage<kAutoThreads>(tile, tile, n, rounds);
    if (edge_rows) {
      __syncthreads();
      add_halo(tile, in, g, band, r0, c0, h, w);
    }
    if (kTma) tile_copy::fence_proxy_async();
    __syncthreads();
  }
  if (kTma) {
    if (threadIdx.x == 0) {
      tile_copy::box_store(&dst, tile, c0, r0, 0);
      tile_copy::bulk_commit();
      tile_copy::bulk_wait_read<0>();  // the store has read the tile before the block ends
    }
  } else {
    tile_copy::store_box_values(tile, out, b, g.planes, g.by, g.bx);
  }
  if (kSmem && blockIdx.x == 0 && threadIdx.x < 32) {
    // the partial of every band that starts in this tile's rows
    const int lane = threadIdx.x;
    for (int rb = (r0 + band - 1) / band * band; rb < r0 + h; rb += band) {
      const float* p = in + (size_t)rb * g.nx + lane * (kSmemCols / 32);
      float s = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[2]), p[3]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
      if (lane == 0) partials[rb / band] = s;
    }
  }
}

// total = the partials summed in band order, from 0.
__global__ void sum_partials_kernel(const float* partials, int n, float* total) {
  float t = 0.f;
  for (int i = 0; i < n; ++i) t = __fadd_rn(t, partials[i]);
  *total = t;
}

// -------------------------------------------------------------- manual ----

using tile_copy::bulk_commit;
using tile_copy::bulk_load;
using tile_copy::bulk_store;
using tile_copy::bulk_wait_all;
using tile_copy::bulk_wait_read;
using tile_copy::mbar_expect_tx;
using tile_copy::mbar_init;
using tile_copy::mbar_wait;

// A tile of the manual kernel: its values are `rows` segments of `w` values,
// segment j at src + seg_offset(j) in device memory and at stage + j * bx in
// shared memory. Flat tiles are one segment. (r0, c0): its first row and
// column (strided tiles).
struct Tile {
  size_t base;  // offset of the first value
  int rows, h, w, r0, c0;
};

template <bool kFlat>
__device__ __forceinline__ Tile tile_of(const Grid& g, int t) {
  if (kFlat) {
    const size_t stage = (size_t)9 * g.by * g.bx;
    const size_t total = (size_t)9 * g.ny * g.nx;
    const size_t base = (size_t)t * stage;
    return Tile{base, 1, 1, (int)(total - base < stage ? total - base : stage), 0, 0};
  }
  const int ntx = (g.nx + g.bx - 1) / g.bx;
  const int ty = t / ntx, tx = t - ty * ntx;
  const int r0 = ty * g.by, c0 = tx * g.bx;
  const int h = min(g.by, g.ny - r0);
  return Tile{(size_t)r0 * g.nx + c0, 9 * h, h, min(g.bx, g.nx - c0), r0, c0};
}

// device-memory offset of segment j of a strided tile: plane q, row r
__device__ __forceinline__ size_t seg_offset(const Grid& g, const Tile& t, int j) {
  const int q = j / t.h, r = j - q * t.h;
  return t.base + q * (size_t)g.ny * g.nx + (size_t)r * g.nx;
}

// shared-memory offset of segment j: the stage keeps the (9, by, bx) layout
__device__ __forceinline__ int seg_stage(const Grid& g, const Tile& t, int j) {
  const int q = j / t.h, r = j - q * t.h;
  return (q * g.by + r) * g.bx;
}

// Values between two stage slots: a slot of 9 by bx floats rounded up to 128
// bytes, so that every slot starts where a TMA box may land.
__host__ __device__ __forceinline__ int slot_stride(int by, int bx) {
  return (9 * by * bx + 31) / 32 * 32;
}

// warp 0: start the fetch of tile t into stage, completing on bar. Box: one
// TMA box of the whole (9, by, bx) tile, zeros beyond the grid; its bytes
// are the box's, edge tile or not.
template <bool kFlat, bool kBox>
__device__ __forceinline__ void fetch(const CUtensorMap* src, const float* in, float* stage,
                                      uint64_t* bar, const Grid& g, int t) {
  const int lane = threadIdx.x;
  const Tile tl = tile_of<kFlat>(g, t);
  if (kBox) {
    if (lane == 0) {
      mbar_expect_tx(bar, (uint32_t)9 * g.by * g.bx * 4);
      tile_copy::box_load(src, stage, bar, tl.c0, tl.r0, 0);
    }
    return;
  }
  if (lane == 0) mbar_expect_tx(bar, (uint32_t)tl.rows * tl.w * 4);
  __syncwarp();
  if (kFlat) {
    if (lane == 0) bulk_load(stage, in + tl.base, (uint32_t)tl.w * 4, bar);
    return;
  }
  for (int j = lane; j < tl.rows; j += 32)
    bulk_load(stage + seg_stage(g, tl, j), in + seg_offset(g, tl, j), (uint32_t)tl.w * 4, bar);
}

// warp 0: start the write-back of tile t from stage, as one bulk group a
// lane. Box: lane 0 stores the tile as one TMA box, clipped to the grid.
// The threads wrote the stage: the caller has fenced (fence.proxy.async) and
// met at a barrier before this.
template <bool kFlat, bool kBox>
__device__ __forceinline__ void write_back(const CUtensorMap* dst, float* out, const float* stage,
                                           const Grid& g, int t) {
  const int lane = threadIdx.x;
  const Tile tl = tile_of<kFlat>(g, t);
  if (kBox) {
    if (lane == 0) tile_copy::box_store(dst, stage, tl.c0, tl.r0, 0);
  } else if (kFlat) {
    if (lane == 0) bulk_store(out + tl.base, stage, (uint32_t)tl.w * 4);
  } else {
    for (int j = lane; j < tl.rows; j += 32)
      bulk_store(out + seg_offset(g, tl, j), stage + seg_stage(g, tl, j), (uint32_t)tl.w * 4);
  }
  bulk_commit();
}

// The pipeline's hazards, each kept at its place below:
//   * stage s's mbarrier completes once per use, so round i waits on parity
//     (i / Depth) & 1, the number of its earlier uses mod 2;
//   * a stage's in-slot is refilled (Depth - 1 tiles ahead) only in the round
//     after the threads have read it: the fetch at the top of round i goes to
//     the slot of round i - 1, whose reads ended at that round's last barrier;
//   * an out-slot is written by the threads only after the store that last
//     read it has read it (bulk_wait_read<Depth - 1>, then a barrier);
//   * the threads' writes of an out-slot reach the async proxy that stores it
//     through fence_proxy_async and a barrier before the store is issued.
template <int kDepth, bool kFlat, bool kSafe, bool kBox>
__global__ void __launch_bounds__(kThreads)
manual_kernel(__grid_constant__ const CUtensorMap src, __grid_constant__ const CUtensorMap dst,
              const float* in, float* out, Grid g, int rounds, int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const int stage = 9 * g.by * g.bx, stride = slot_stride(g.by, g.bx);
  float* in_sl = tile_copy::align128<float>(smem_raw);
  float* out_sl = in_sl + kDepth * stride;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_sl + kDepth * stride);
  const bool producer = threadIdx.x < 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) mbar_init(&full[s], 1);
  }
  __syncthreads();
  // this block's tiles: blockIdx.x + i * gridDim.x for i < mine
  const int b = blockIdx.x, nb = gridDim.x;
  const int mine = b < ntiles ? (ntiles - 1 - b) / nb + 1 : 0;
  const auto tile = [&](int i) { return b + i * nb; };
  if (producer)
    for (int j = 0; j < kDepth - 1 && j < mine; ++j)
      fetch<kFlat, kBox>(&src, in, in_sl + j * stride, &full[j], g, tile(j));
  for (int i = 0; i < mine; ++i) {
    const int slot = i % kDepth;
    const int ahead = i + kDepth - 1;  // its in-slot was read in round i - 1
    if (producer && ahead < mine)
      fetch<kFlat, kBox>(&src, in, in_sl + (ahead % kDepth) * stride, &full[ahead % kDepth], g,
                         tile(ahead));
    mbar_wait(&full[slot], (uint32_t)(i / kDepth) & 1u);
    if (kSafe && producer && i >= 1)  // tile i has landed: flush tile i - 1
      write_back<kFlat, kBox>(&dst, out, out_sl + ((i - 1) % kDepth) * stride, g, tile(i - 1));
    // the out-slot of tile i - Depth must have been read by its write-back
    if (producer) bulk_wait_read<kDepth - 1>();
    __syncthreads();
    const int n = kFlat ? tile_of<kFlat>(g, tile(i)).w : stage;
    work_stage<kThreads>(in_sl + slot * stride, out_sl + slot * stride, n, rounds);
    tile_copy::fence_proxy_async();  // the threads' out-slot, before the store reads it
    __syncthreads();
    if (!kSafe && producer)
      write_back<kFlat, kBox>(&dst, out, out_sl + slot * stride, g, tile(i));
  }
  if (kSafe && producer && mine > 0)
    write_back<kFlat, kBox>(&dst, out, out_sl + ((mine - 1) % kDepth) * stride, g,
                            tile(mine - 1));
  if (producer) bulk_wait_all();  // drain: the writes land before the block ends
}

// Mirrored by overlap_probe.manual_smem_bytes.
size_t manual_smem(int depth, int by, int bx) {
  return 128 + (size_t)2 * depth * slot_stride(by, bx) * sizeof(float) +
         (size_t)depth * sizeof(uint64_t);
}

int manual_tiles(const Grid& g, bool flat) {
  if (flat) {
    const size_t stage = (size_t)9 * g.by * g.bx, total = (size_t)9 * g.ny * g.nx;
    return (int)((total + stage - 1) / stage);
  }
  return ((g.ny + g.by - 1) / g.by) * ((g.nx + g.bx - 1) / g.bx);
}

// Whether the box path takes a strided tile over this layout (mirrored by
// overlap_probe.choose_path): TMA's rules and a tile no larger than the grid.
bool manual_box_fits(const void* in, const void* out, const Grid& g) {
  return tile_copy::tma_fits(in, out, 4, g.nx, 9, g.by, g.bx) && g.by <= g.ny && g.bx <= g.nx;
}

template <int kDepth, bool kFlat, bool kSafe, bool kBox>
int manual_launch(const float* in, float* out, const Grid& g, int rounds, int blocks,
                  cudaStream_t stream) {
  CUtensorMap src{}, dst{};
  if (kBox) {
    if (!manual_box_fits(in, out, g)) return (int)cudaErrorInvalidValue;
    int rc = tile_copy::encode_map(&src, {in, 4, 9, g.ny, g.nx, 9, g.by, g.bx});
    if (rc == 0) rc = tile_copy::encode_map(&dst, {out, 4, 9, g.ny, g.nx, 9, g.by, g.bx});
    if (rc) return rc;
  }
  const size_t smem = manual_smem(kDepth, g.by, g.bx);
  cudaError_t err = cudaFuncSetAttribute(manual_kernel<kDepth, kFlat, kSafe, kBox>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  manual_kernel<kDepth, kFlat, kSafe, kBox><<<blocks, kThreads, smem, stream>>>(
      src, dst, in, out, g, rounds, manual_tiles(g, kFlat));
  return (int)cudaGetLastError();
}

template <int kDepth, bool kFlat, bool kSafe, bool kBox>
int manual_per_sm(int by, int bx) {
  const size_t smem = manual_smem(kDepth, by, bx);
  if (cudaFuncSetAttribute(manual_kernel<kDepth, kFlat, kSafe, kBox>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, manual_kernel<kDepth, kFlat, kSafe, kBox>, kThreads, smem) != cudaSuccess)
    return 0;
  return per_sm;
}

// Calls F<Depth, Flat, Safe, Box>::run(args...) for the runtime quadruple; -1
// for one no engine uses. The engines use depth 2, 3, 4 and 6 strided, depth
// 2 flat (manual_flat, bulk only) and depth 2 safe (manual_alias_safe); each
// strided one on either path.
template <template <int, bool, bool, bool> class F, typename... A>
int dispatch(int depth, bool flat, bool safe, bool box, A... args) {
  if (flat) {
    if (depth != 2 || safe || box) return -1;
    return F<2, true, false, false>::run(args...);
  }
  if (safe) {
    if (depth != 2) return -1;
    return box ? F<2, false, true, true>::run(args...) : F<2, false, true, false>::run(args...);
  }
  if (box) {
    switch (depth) {
      case 2: return F<2, false, false, true>::run(args...);
      case 3: return F<3, false, false, true>::run(args...);
      case 4: return F<4, false, false, true>::run(args...);
      case 6: return F<6, false, false, true>::run(args...);
    }
    return -1;
  }
  switch (depth) {
    case 2: return F<2, false, false, false>::run(args...);
    case 3: return F<3, false, false, false>::run(args...);
    case 4: return F<4, false, false, false>::run(args...);
    case 6: return F<6, false, false, false>::run(args...);
  }
  return -1;
}

template <int kDepth, bool kFlat, bool kSafe, bool kBox>
struct Launch {
  static int run(const float* in, float* out, Grid g, int rounds, int blocks,
                 cudaStream_t stream) {
    return manual_launch<kDepth, kFlat, kSafe, kBox>(in, out, g, rounds, blocks, stream);
  }
};

template <int kDepth, bool kFlat, bool kSafe, bool kBox>
struct PerSm {
  static int run(int by, int bx) { return manual_per_sm<kDepth, kFlat, kSafe, kBox>(by, bx); }
};

size_t auto_smem(int values) {
  return 128 + (size_t)values * sizeof(float) + sizeof(uint64_t);
}

// the dynamic shared memory last set on auto_kernel<kHalo, kSmem, kTma>
template <bool kHalo, bool kSmem, bool kTma>
size_t& auto_smem_set() {
  static size_t bytes = 0;
  return bytes;
}

template <bool kHalo, bool kSmem, bool kTma>
int auto_launch(const float* in, float* out, float* partials, float* total, Grid g, int band,
                int rounds, cudaStream_t stream) {
  g.by = min(g.by, g.ny);  // a tile longer than the grid is the grid
  g.bx = min(g.bx, g.nx);
  CUtensorMap src{}, dst{};
  if (kTma) {
    if (!tile_copy::tma_fits(in, out, 4, g.nx, g.planes, g.by, g.bx))
      return (int)cudaErrorInvalidValue;
    int rc = tile_copy::encode_map(&src, {in, 4, g.planes, g.ny, g.nx, g.planes, g.by, g.bx});
    if (rc == 0)
      rc = tile_copy::encode_map(&dst, {out, 4, g.planes, g.ny, g.nx, g.planes, g.by, g.bx});
    if (rc) return rc;
  }
  const size_t smem = auto_smem(g.planes * g.by * g.bx);
  cudaError_t err = tile_copy::fit_smem(auto_kernel<kHalo, kSmem, kTma>, smem,
                                        auto_smem_set<kHalo, kSmem, kTma>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.nx + g.bx - 1) / g.bx, (g.ny + g.by - 1) / g.by);
  err = tile_copy::launch_tiles(auto_kernel<kHalo, kSmem, kTma>, grid, kAutoThreads, smem,
                                stream, true, src, dst, in, out, partials, g, band, rounds);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || !kSmem) return (int)err;
  sum_partials_kernel<<<1, 1, 0, stream>>>(partials, g.ny / band, total);
  return (int)cudaGetLastError();
}

template <bool kHalo, bool kSmem, bool kTma>
int auto_per_sm(int values) {
  const size_t smem = auto_smem(values);
  if (tile_copy::fit_smem(auto_kernel<kHalo, kSmem, kTma>, smem,
                          auto_smem_set<kHalo, kSmem, kTma>()) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, auto_kernel<kHalo, kSmem, kTma>,
                                                    kAutoThreads, smem) != cudaSuccess)
    return 0;
  return per_sm;
}

template <bool kHalo, bool kSmem, bool kTma>
struct AutoLaunch {
  static int run(const float* in, float* out, float* partials, float* total, Grid g, int band,
                 int rounds, cudaStream_t stream) {
    return auto_launch<kHalo, kSmem, kTma>(in, out, partials, total, g, band, rounds, stream);
  }
};

template <bool kHalo, bool kSmem, bool kTma>
struct AutoPerSm {
  static int run(int values) { return auto_per_sm<kHalo, kSmem, kTma>(values); }
};

// F<Halo, Smem, Tma>::run(args...) for the runtime triple
template <template <bool, bool, bool> class F, typename... A>
int auto_dispatch(bool halo, bool smem, bool tma, A... args) {
  if (tma) {
    if (halo) return smem ? F<true, true, true>::run(args...) : F<true, false, true>::run(args...);
    return smem ? F<false, true, true>::run(args...) : F<false, false, true>::run(args...);
  }
  if (halo) return smem ? F<true, true, false>::run(args...) : F<true, false, false>::run(args...);
  return smem ? F<false, true, false>::run(args...) : F<false, false, false>::run(args...);
}

}  // namespace

extern "C" {

// auto_kernel: out = R rounds of in over (planes, ny, nx) in (planes, by, bx)
// tiles; halo adds the rows outside each band of `band` rows; smem writes
// ny / band partials and their sum to total; tma moves each tile with TMA
// (16-byte aligned buffers, nx % 4 == 0, bx % 4 == 0), else the threads move
// it. out may be in when halo is 0.
int overlap_auto(const void* in, void* out, void* partials, void* total, int planes, int ny,
                 int nx, int by, int bx, int band, int rounds, int halo, int smem, int tma,
                 void* stream) {
  return auto_dispatch<AutoLaunch>(halo != 0, smem != 0, tma != 0, static_cast<const float*>(in),
                                   static_cast<float*>(out), static_cast<float*>(partials),
                                   static_cast<float*>(total), Grid{planes, ny, nx, by, bx}, band,
                                   rounds, static_cast<cudaStream_t>(stream));
}

// manual_kernel over a (9, ny, nx) state on a persistent grid of `blocks`
// blocks; depth 2, 3, 4 or 6 strided, depth 2 flat or safe; box: each
// strided stage as one TMA box (16-byte aligned buffers, nx % 4 == 0, bx % 4
// == 0, by <= min(256, ny), bx <= min(256, nx); else an error), bulk copies
// otherwise. out may be in (the aliased engines).
int overlap_manual(const void* in, void* out, int ny, int nx, int by, int bx, int rounds,
                   int depth, int flat, int safe, int box, int blocks, void* stream) {
  const int rc = dispatch<Launch>(depth, flat != 0, safe != 0, box != 0,
                                  static_cast<const float*>(in),
                                  static_cast<float*>(out), Grid{9, ny, nx, by, bx}, rounds,
                                  blocks, static_cast<cudaStream_t>(stream));
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

// Blocks of each kernel resident on one SM of the current device (auto: with
// tiles of `values` values); 0 on an error of the query or a triple with no
// instance.
int overlap_auto_blocks(int halo, int smem, int tma, int values) {
  return auto_dispatch<AutoPerSm>(halo != 0, smem != 0, tma != 0, values);
}

int overlap_manual_blocks(int depth, int flat, int safe, int box, int by, int bx) {
  const int n = dispatch<PerSm>(depth, flat != 0, safe != 0, box != 0, by, bx);
  return n < 0 ? 0 : n;
}

}  // extern "C"

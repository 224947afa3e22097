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
//   * auto_kernel<Halo, Smem>, the "automatic pipeline": one block per
//     (planes, by, bx) tile, 16 bytes a load, three loads a thread in flight,
//     the R rounds in registers, then the store: the blocking of B12
//     (csrc/copy_floor.cu) with arithmetic added. The overlap comes from the
//     other blocks resident on the SM, the card's form of the TPU's grid
//     pipeline. `auto_flat` is the same kernel over the (9 ny, nx) view with
//     one plane and tiles of 9 by rows; `auto_alias` is it with out == in.
//     Halo adds input rows band_start - 1 and band_end (mod ny) to a band's
//     first and last rows. Smem writes a per-band partial of f[0,
//     band_start, :128] (a warp: four values a lane in order, then a shuffle
//     tree), summed over the bands in band order by sum_partials_kernel, one
//     thread: no float atomics.
//   * manual_kernel<Depth, Flat, Safe>, the explicit pipeline: a persistent
//     grid (as many blocks as are resident at once, like B3); block b walks
//     the tiles b, b + grid, ... in band order through a ring of Depth
//     shared-memory stages, each with an input and an output slot of one
//     tile. Warp 0 issues the copies: Hopper bulk copies (cp.async.bulk)
//     global -> shared, completing on the stage's mbarrier, Depth - 1 tiles
//     ahead; then shared -> global (bulk_group), drained Depth tiles behind
//     with cp.async.bulk.wait_group.read, as probe.py's out_sem waits. The
//     strided (9, by, bx) tile is one copy per row segment (9 by copies:
//     144 of 128 B at 16x32, 9 of 2 KB at 1x512, the TPU stage's 9 strided
//     descriptors); Flat copies one contiguous chunk of 9 by bx values of
//     the flat view per stage, the TPU's "9 strided descriptors against 1".
//     Safe issues tile i's write only after tile i+1's fetch has landed
//     (probe.py:483-493). The aliased engines pass out == in: nothing else
//     differs, so aliasing is no template parameter. A bulk copy needs 16-byte
//     alignment and a multiple of 16 bytes: nx % 4 == 0, bx % 4 == 0 and
//     16-byte aligned pointers (the wrapper checks them).
// Shared memory of manual_kernel: 2 x Depth x 9 x by x bx x 4 B + the
// barriers; at 16x32 or 1x512, 73,744 B at Depth 2 (three blocks an SM) up
// to 221,232 B at Depth 6 (one).
//
// Interface: plain C; launches on the given stream and returns
// cudaGetLastError(); allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;
constexpr int kUnroll = 3;  // 384 threads x 3 x 16 B: one (9, 16, 32) float32 tile a sweep
constexpr int kSmemCols = 128;  // the smem trait sums f[0, band_start, :128]

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

__device__ __forceinline__ void add4(float4& v, const float4 h) {
  v.x = __fadd_rn(v.x, h.x);
  v.y = __fadd_rn(v.y, h.y);
  v.z = __fadd_rn(v.z, h.z);
  v.w = __fadd_rn(v.w, h.w);
}

// ---------------------------------------------------------------- auto ----

template <bool kHalo, bool kSmem>
__global__ void __launch_bounds__(kThreads)
auto_kernel(const float* in, float* out, float* partials, Grid g, int band, int rounds) {
  constexpr int V = 4;
  const int r0 = blockIdx.y * g.by, c0 = blockIdx.x * g.bx;
  const int h = min(g.by, g.ny - r0), w = min(g.bx, g.nx - c0);
  const size_t plane = (size_t)g.ny * g.nx;
  const bool vec = g.nx % V == 0 && c0 % V == 0 && w % V == 0
                   && reinterpret_cast<uintptr_t>(in) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_row = vec ? w / V : w;
  const int n = g.planes * h * per_row;
  for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    float4 v[kUnroll];
    size_t at[kUnroll];
    int row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kThreads;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      at[u] = 0;
      row[u] = 0;
      if (idx < n) {
        const int rr = idx / per_row;  // (q, r) of the tile
        const int piece = idx - rr * per_row;
        const int q = rr / h;
        row[u] = r0 + rr - q * h;
        at[u] = q * plane + (size_t)row[u] * g.nx + c0 + (vec ? piece * V : piece);
        if (vec)
          v[u] = *reinterpret_cast<const float4*>(in + at[u]);
        else
          v[u].x = in[at[u]];
      }
    }
    rounds_on(v, rounds);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads >= n) continue;
      if (kHalo) {
        // the input rows just outside the band, wrapped at ny
        const int in_band = row[u] % band;
        const size_t line = at[u] - (size_t)row[u] * g.nx;
        if (in_band == 0) {
          const size_t src = line + (size_t)((row[u] - 1 + g.ny) % g.ny) * g.nx;
          if (vec)
            add4(v[u], *reinterpret_cast<const float4*>(in + src));
          else
            v[u].x = __fadd_rn(v[u].x, in[src]);
        }
        if (in_band == band - 1) {
          const size_t src = line + (size_t)((row[u] + 1) % g.ny) * g.nx;
          if (vec)
            add4(v[u], *reinterpret_cast<const float4*>(in + src));
          else
            v[u].x = __fadd_rn(v[u].x, in[src]);
        }
      }
      if (vec)
        *reinterpret_cast<float4*>(out + at[u]) = v[u];
      else
        out[at[u]] = v[u].x;
    }
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
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

// global -> shared, completing `bytes` on bar
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
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

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A tile of the manual kernel: its values are `rows` segments of `w` values,
// segment j at src + seg_offset(j) in device memory and at stage + j * bx in
// shared memory. Flat tiles are one segment.
struct Tile {
  size_t base;  // offset of the first value
  int rows, h, w;
};

template <bool kFlat>
__device__ __forceinline__ Tile tile_of(const Grid& g, int t) {
  if (kFlat) {
    const size_t stage = (size_t)9 * g.by * g.bx;
    const size_t total = (size_t)9 * g.ny * g.nx;
    const size_t base = (size_t)t * stage;
    return Tile{base, 1, 1, (int)(total - base < stage ? total - base : stage)};
  }
  const int ntx = (g.nx + g.bx - 1) / g.bx;
  const int ty = t / ntx, tx = t - ty * ntx;
  const int r0 = ty * g.by, c0 = tx * g.bx;
  const int h = min(g.by, g.ny - r0);
  return Tile{(size_t)r0 * g.nx + c0, 9 * h, h, min(g.bx, g.nx - c0)};
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

// warp 0: start the fetch of tile t into stage, completing on bar
template <bool kFlat>
__device__ __forceinline__ void fetch(const float* in, float* stage, uint64_t* bar, const Grid& g,
                                      int t) {
  const int lane = threadIdx.x;
  const Tile tl = tile_of<kFlat>(g, t);
  if (lane == 0) mbar_expect_tx(bar, (uint32_t)tl.rows * tl.w * 4);
  __syncwarp();
  if (kFlat) {
    if (lane == 0) bulk_load(stage, in + tl.base, (uint32_t)tl.w * 4, bar);
    return;
  }
  for (int j = lane; j < tl.rows; j += 32)
    bulk_load(stage + seg_stage(g, tl, j), in + seg_offset(g, tl, j), (uint32_t)tl.w * 4, bar);
}

// warp 0: start the write-back of tile t from stage, as one bulk group a lane
template <bool kFlat>
__device__ __forceinline__ void write_back(float* out, const float* stage, const Grid& g, int t) {
  const int lane = threadIdx.x;
  const Tile tl = tile_of<kFlat>(g, t);
  if (kFlat) {
    if (lane == 0) bulk_store(out + tl.base, stage, (uint32_t)tl.w * 4);
  } else {
    for (int j = lane; j < tl.rows; j += 32)
      bulk_store(out + seg_offset(g, tl, j), stage + seg_stage(g, tl, j), (uint32_t)tl.w * 4);
  }
  bulk_commit();
}

// all threads: out_stage = R rounds of in_stage, n4 pieces of 16 bytes
__device__ __forceinline__ void work_stage(const float* in_stage, float* out_stage, int n4,
                                           int rounds) {
  const float4* src = reinterpret_cast<const float4*>(in_stage);
  float4* dst = reinterpret_cast<float4*>(out_stage);
  for (int base = threadIdx.x; base < n4; base += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kThreads;
      v[u] = idx < n4 ? src[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    rounds_on(v, rounds);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kThreads;
      if (idx < n4) dst[idx] = v[u];
    }
  }
}

template <int kDepth, bool kFlat, bool kSafe>
__global__ void __launch_bounds__(kThreads)
manual_kernel(const float* in, float* out, Grid g, int rounds, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int stage = 9 * g.by * g.bx;
  float* in_sl = reinterpret_cast<float*>(smem_raw);
  float* out_sl = in_sl + kDepth * stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_sl + kDepth * stage);
  const bool producer = threadIdx.x < 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block's tiles: blockIdx.x + i * gridDim.x for i < mine
  const int b = blockIdx.x, nb = gridDim.x;
  const int mine = b < ntiles ? (ntiles - 1 - b) / nb + 1 : 0;
  const auto tile = [&](int i) { return b + i * nb; };
  if (producer)
    for (int j = 0; j < kDepth - 1 && j < mine; ++j)
      fetch<kFlat>(in, in_sl + j * stage, &full[j], g, tile(j));
  for (int i = 0; i < mine; ++i) {
    const int slot = i % kDepth;
    const int ahead = i + kDepth - 1;  // its in-slot was read in round i - 1
    if (producer && ahead < mine)
      fetch<kFlat>(in, in_sl + (ahead % kDepth) * stage, &full[ahead % kDepth], g, tile(ahead));
    mbar_wait(&full[slot], (uint32_t)(i / kDepth) & 1u);
    if (kSafe && producer && i >= 1)  // tile i has landed: flush tile i - 1
      write_back<kFlat>(out, out_sl + ((i - 1) % kDepth) * stage, g, tile(i - 1));
    // the out-slot of tile i - Depth must have been read by its write-back
    if (producer) bulk_wait_read<kDepth - 1>();
    __syncthreads();
    const int n4 = (kFlat ? tile_of<kFlat>(g, tile(i)).w : stage) / 4;
    work_stage(in_sl + slot * stage, out_sl + slot * stage, n4, rounds);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (!kSafe && producer) write_back<kFlat>(out, out_sl + slot * stage, g, tile(i));
  }
  if (kSafe && producer && mine > 0)
    write_back<kFlat>(out, out_sl + ((mine - 1) % kDepth) * stage, g, tile(mine - 1));
  if (producer) bulk_wait_all();  // drain: the writes land before the block ends
}

size_t manual_smem(int depth, int by, int bx) {
  return (size_t)2 * depth * 9 * by * bx * sizeof(float) + (size_t)depth * sizeof(uint64_t);
}

int manual_tiles(const Grid& g, bool flat) {
  if (flat) {
    const size_t stage = (size_t)9 * g.by * g.bx, total = (size_t)9 * g.ny * g.nx;
    return (int)((total + stage - 1) / stage);
  }
  return ((g.ny + g.by - 1) / g.by) * ((g.nx + g.bx - 1) / g.bx);
}

template <int kDepth, bool kFlat, bool kSafe>
int manual_launch(const float* in, float* out, const Grid& g, int rounds, int blocks,
                  cudaStream_t stream) {
  const size_t smem = manual_smem(kDepth, g.by, g.bx);
  cudaError_t err = cudaFuncSetAttribute(manual_kernel<kDepth, kFlat, kSafe>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  manual_kernel<kDepth, kFlat, kSafe><<<blocks, kThreads, smem, stream>>>(
      in, out, g, rounds, manual_tiles(g, kFlat));
  return (int)cudaGetLastError();
}

template <int kDepth, bool kFlat, bool kSafe>
int manual_per_sm(int by, int bx) {
  const size_t smem = manual_smem(kDepth, by, bx);
  if (cudaFuncSetAttribute(manual_kernel<kDepth, kFlat, kSafe>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, manual_kernel<kDepth, kFlat, kSafe>,
                                                    kThreads, smem) != cudaSuccess)
    return 0;
  return per_sm;
}

// Calls F<Depth, Flat, Safe>::run(args...) for the runtime triple; -1 for a
// triple no engine uses. The engines use six: depth 2, 3, 4 and 6 strided,
// depth 2 flat (manual_flat) and depth 2 safe (manual_alias_safe).
template <template <int, bool, bool> class F, typename... A>
int dispatch(int depth, bool flat, bool safe, A... args) {
  if (flat || safe) {
    if (depth != 2 || (flat && safe)) return -1;
    return flat ? F<2, true, false>::run(args...) : F<2, false, true>::run(args...);
  }
  switch (depth) {
    case 2: return F<2, false, false>::run(args...);
    case 3: return F<3, false, false>::run(args...);
    case 4: return F<4, false, false>::run(args...);
    case 6: return F<6, false, false>::run(args...);
  }
  return -1;
}

template <int kDepth, bool kFlat, bool kSafe>
struct Launch {
  static int run(const float* in, float* out, Grid g, int rounds, int blocks,
                 cudaStream_t stream) {
    return manual_launch<kDepth, kFlat, kSafe>(in, out, g, rounds, blocks, stream);
  }
};

template <int kDepth, bool kFlat, bool kSafe>
struct PerSm {
  static int run(int by, int bx) { return manual_per_sm<kDepth, kFlat, kSafe>(by, bx); }
};

template <bool kHalo, bool kSmem>
int auto_launch(const float* in, float* out, float* partials, float* total, const Grid& g,
                int band, int rounds, cudaStream_t stream) {
  const dim3 grid((g.nx + g.bx - 1) / g.bx, (g.ny + g.by - 1) / g.by);
  auto_kernel<kHalo, kSmem><<<grid, kThreads, 0, stream>>>(in, out, partials, g, band, rounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !kSmem) return (int)err;
  sum_partials_kernel<<<1, 1, 0, stream>>>(partials, g.ny / band, total);
  return (int)cudaGetLastError();
}

template <bool kHalo, bool kSmem>
int auto_per_sm() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, auto_kernel<kHalo, kSmem>, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return per_sm;
}

}  // namespace

extern "C" {

// auto_kernel: out = R rounds of in over (planes, ny, nx) in (planes, by, bx)
// tiles; halo adds the rows outside each band of `band` rows; smem writes
// ny / band partials and their sum to total. out may be in when halo is 0.
int overlap_auto(const void* in, void* out, void* partials, void* total, int planes, int ny,
                 int nx, int by, int bx, int band, int rounds, int halo, int smem,
                 void* stream) {
  const Grid g{planes, ny, nx, by, bx};
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  float* part = static_cast<float*>(partials);
  float* tot = static_cast<float*>(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo)
    return smem ? auto_launch<true, true>(src, dst, part, tot, g, band, rounds, s)
                : auto_launch<true, false>(src, dst, part, tot, g, band, rounds, s);
  return smem ? auto_launch<false, true>(src, dst, part, tot, g, band, rounds, s)
              : auto_launch<false, false>(src, dst, part, tot, g, band, rounds, s);
}

// manual_kernel over a (9, ny, nx) state on a persistent grid of `blocks`
// blocks; depth 2, 3, 4 or 6 strided, depth 2 flat or safe. out may be in
// (the aliased engines).
int overlap_manual(const void* in, void* out, int ny, int nx, int by, int bx, int rounds,
                   int depth, int flat, int safe, int blocks, void* stream) {
  const int rc = dispatch<Launch>(depth, flat != 0, safe != 0, static_cast<const float*>(in),
                                  static_cast<float*>(out), Grid{9, ny, nx, by, bx}, rounds,
                                  blocks, static_cast<cudaStream_t>(stream));
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

// Blocks of each kernel resident on one SM of the current device; 0 on an
// error of the query or a triple with no instance.
int overlap_auto_blocks(int halo, int smem) {
  if (halo) return smem ? auto_per_sm<true, true>() : auto_per_sm<true, false>();
  return smem ? auto_per_sm<false, true>() : auto_per_sm<false, false>();
}

int overlap_manual_blocks(int depth, int flat, int safe, int by, int bx) {
  const int n = dispatch<PerSm>(depth, flat != 0, safe != 0, by, bx);
  return n < 0 ? 0 : n;
}

}  // extern "C"

// The 3x3 Gaussian blur (1 2 1; 2 4 2; 1 2 1)/16, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of lbm_tpu/ops/stencil.py:
//   B10  _blur_kernel      one pass, the direct 9-point sum
//   B9   _blur_kernel_k    k passes per trip through device memory
//   B8   _resident_kernel  a whole run of passes with the image on chip
// The image is (C, h, w), float32 or bfloat16 in memory; the arithmetic is
// float32 in both, and a value is rounded to the storage type only where it
// is stored to `out`. `interior` is an (h, w) mask in the image's type; every
// pass multiplies its result by it. Edges are periodic in both directions, as
// in the TPU kernels (modular row index maps, column rolls): the zero ring
// that pad_to_tile puts around an image makes that equal to "zero outside".
//
// Arithmetic order, kept from each TPU kernel so that each equals its plain
// PyTorch version bit for bit (every factor is a power of two, so a fused
// multiply-add would round the same; the library is built with -fmad=false
// all the same):
//   B10  acc = 4m; acc += 2(((n + s) + left(m)) + right(m));
//        acc += ((left(n) + right(n)) + left(s)) + right(s)
//   B9   rows = (above + 2 mid) + below; acc = (right + 2 rows) + left
//   B8   rows = (below + 2 mid) + above; acc = (right + 2 rows) + left
//   all  out = (acc * 1/16) * interior
//
// What bounds them on this card. One pass moves (2C + 1) values per pixel
// (image in, image out, mask) for about 12 operations per value: at
// 3.35 TB/s and 67 TFLOP/s (f32) the bytes take some 15 times longer, so a
// pass is bound by memory. B9 divides the bytes per pass by k: the
// operations would bind only beyond k ~ 20, if every instruction were an
// operation; what B9 adds (shuffles, shared loads, the halo columns and
// rows it recomputes) it has to hide under the trip. B8 moves the image
// once per run, so its bound is the operations of its passes; what it pays
// in practice is its exchanges of tile edges, one every k passes.
//
// Design.
//   B10  one thread per column of a short run of rows: it keeps the three
//        values of the two previous rows in registers, so a value is loaded
//        three times instead of nine; neighbouring threads read
//        neighbouring addresses and the rest comes from L1/L2. The channel
//        is the fastest grid dimension, so the blocks that read one part of
//        the mask run together and it crosses device memory once, not C
//        times.
//   B9   a row pipeline down a band of rows, each input value crossing
//        shared memory once and the k passes held in registers. A block of
//        B9 is (group of channels, group of column windows, band of rows):
//        `band` output rows plus k halo rows above and below (periodic row
//        indices). Its last warp produces: for each row of the band it
//        starts one bulk copy (cp.async.bulk) of the block's span of the
//        mask row and one of each channel's image row into a ring of rows in
//        shared memory, completing on the row's mbarrier, a few rows ahead
//        of the consumers, and two copies an array where the span crosses
//        the array's edge (the periodic wrap). The mask row crosses L2 into
//        the block once for all its channels: L2 on this card moves little
//        more than device memory, and a mask brought in by each channel's
//        block cost half again the trip (PERF.md). Each other warp owns a
//        window of 32 V columns of one channel, a lane V adjacent ones (one
//        16-byte vector: V = 4 in float32, 8 in bfloat16 at k <= 4, 4
//        beyond, for the registers). At each row the lane reads its V values
//        of the new row with one shared load, and pass j, a stage of the
//        pipeline, turns the row that pass j - 1 just produced and the two
//        before it, kept in registers, into its own row one behind: the
//        vertical sums in registers, the edge sums of the V columns from
//        lane -1 and lane +1 by shuffles, then the horizontal sum, the scale
//        and the mask row, read from the ring (which keeps a row until its
//        k-th pass has used its mask). Pass k's row goes out with one
//        16-byte store a lane. A window loses a column a side each pass, so
//        the lanes that store are those whose columns lie k (rounded up to
//        16 bytes) from its edges and windows overlap by that; neighbouring
//        windows and bands recompute their overlap identically, so the
//        result does not depend on the tiling. A row that is not whole
//        16-byte pieces takes the thread path: the same pipeline, with the
//        producer warp loading the span one value a lane (`wrap` for each
//        column) and the lanes storing one value at a time. float32 runs at
//        what its trip costs; bfloat16 at k = 4 and both types at k = 8 are
//        bound by instructions (PERF.md). (The design before it held a tile
//        and its halo in shared memory and ran each pass over all of it
//        between block barriers, three shared loads and a store a value and
//        pass: bound by instructions, 3.6x one trip at k = 4.)
//   B8   the card has no fast memory that holds a whole image, so the image
//        is spread over the shared memory of the SMs: ONE cooperative launch
//        of at most one block per SM, each keeping its tile (plus a k-cell
//        halo, two buffers, and its part of the mask) in shared memory as
//        float32 for the whole run, k passes a block between two exchanges
//        of tile edges through L2, and no grid barrier: a block polls its
//        neighbours' tagged edge words. It is the V0 instance of the
//        resident template of blur_resident.cuh, which has the design and
//        which B13's variants share.
//
// Interface: plain C, one entry per (kernel, storage type), each launching on
// the given stream and returning cudaGetLastError(), or a negative code of
// its own where it refuses a launch. The kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "blur_common.cuh"
#include "blur_resident.cuh"
#include "tile_copy.cuh"

namespace {

constexpr int kThreads = 256;          // B10
constexpr int kRowsPerThread = 8;      // B10: rows one thread walks down

// ---------------------------------------------------------------- B10 ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
blur_step_kernel(const T* __restrict__ img, const T* __restrict__ interior,
                 T* __restrict__ out, int h, int w) {
  // the channel is the fastest grid dimension: the blocks that read one part
  // of the mask run together, and all but the first find it in L2
  const int x = blockIdx.y * kThreads + threadIdx.x;
  if (x >= w) return;
  const int y0 = blockIdx.z * kRowsPerThread;
  const T* plane = img + (size_t)blockIdx.x * h * w;
  T* oplane = out + (size_t)blockIdx.x * h * w;
  const int xl = x == 0 ? w - 1 : x - 1;
  const int xr = x == w - 1 ? 0 : x + 1;

  const T* row = plane + (size_t)wrap(y0 - 1, h) * w;
  float nl = ld(row + xl), nm = ld(row + x), nr = ld(row + xr);  // north
  row = plane + (size_t)y0 * w;
  float ml = ld(row + xl), mm = ld(row + x), mr = ld(row + xr);
  for (int i = 0; i < kRowsPerThread && y0 + i < h; ++i) {
    const int y = y0 + i;
    row = plane + (size_t)(y + 1 == h ? 0 : y + 1) * w;
    const float sl = ld(row + xl), sm = ld(row + x), sr = ld(row + xr);  // south
    float acc = 4.0f * mm;
    acc = acc + 2.0f * (((nm + sm) + ml) + mr);
    acc = acc + (((nl + nr) + sl) + sr);
    st(oplane + (size_t)y * w + x, acc * 0.0625f * ld(interior + (size_t)y * w + x));
    nl = ml; nm = mm; nr = mr;
    ml = sl; mm = sm; mr = sr;
  }
}

template <typename T>
int launch_step(const void* img, const void* interior, void* out, int c, int h,
                int w, cudaStream_t stream) {
  const dim3 grid(c, (w + kThreads - 1) / kThreads,
                  (h + kRowsPerThread - 1) / kRowsPerThread);
  blur_step_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(interior),
      static_cast<T*>(out), h, w);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- B9 ----

// A thread owns V adjacent columns, a warp a window of 32 V columns. Pass j
// of a window is valid on its columns [j, 32 V - j); the lanes whose V
// columns all lie in [halo, 32 V - halo) store, and the next window starts
// `step` columns on. The halo is k rounded up to whole 16-byte pieces, so
// every window, and every block's span of windows, starts on a 16-byte
// boundary. Mirrored by stencil.k_plan on the Python side.
template <typename T, int K>
__host__ __device__ constexpr int k_values() {  // bfloat16 at k > 4: 4 values, for the registers
  return sizeof(T) == 4 ? 4 : (K <= 4 ? 8 : 4);
}
template <typename T, int K>
__host__ __device__ constexpr int k_halo() {
  return (int)(16 / sizeof(T)) * ((K + (int)(16 / sizeof(T)) - 1) / (int)(16 / sizeof(T)));
}
template <typename T, int K>
__host__ __device__ constexpr int k_step() {
  return 32 * k_values<T, K>() - 2 * k_halo<T, K>();
}
// Rows of the ring: a row's slot is free again once its mask row has served
// the last pass (k rows later), and kRingLead more rows are in flight ahead
// of the consumers. A deeper ring costs shared memory, and so blocks an SM,
// and does not pay (PERF.md).
constexpr int kRingLead = 4;
__host__ __device__ constexpr int k_ring_rows(int k) { return k + 1 + kRingLead; }
constexpr int kMaxWarps = 8;  // consumer warps a block; one more produces
enum KPath { kVectorPath = 0, kThreadPath = 1 };

// The channels a block takes (mirrored by stencil.k_grid): as many as fit
// kMaxWarps warps of `windows` windows each, so that a mask row crosses L2
// into the block once for all of them.
__host__ __device__ inline int k_channels(int c, int windows) {
  return min(c, max(1, kMaxWarps / windows));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tile_copy::smem_addr(bar))
               : "memory");
}

// V values of the storage type at p (aligned to their size) as float32; a
// bfloat16 is the upper half of its float32
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ void load_values(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_values(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
}
__device__ __forceinline__ void load_values(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z); v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
}
// and back, rounded to the storage type, as one store
__device__ __forceinline__ void store_values(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store_values(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}
__device__ __forceinline__ void store_values(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// x + 2 y, as the reference rounds it: 2 y is exact, so one fused
// multiply-add rounds the same sum (it differs only where 2 y overflows)
__device__ __forceinline__ float plus_twice(float x, float y) { return __fmaf_rn(2.0f, y, x); }

// What a consumer warp's lane needs at every step of its row pipeline.
template <typename T, int K>
struct KLane {
  static constexpr int V = k_values<T, K>(), D = k_ring_rows(K);
  static constexpr int KA = K > 0 ? K : 1;  // register rows of K = 0 (the trip alone)
  const T* image;       // the lane's first value of the image in slot 0 of the ring
  const T* mask;        // and of the mask
  uint64_t* full;       // full[s]: the row in slot s has arrived
  uint64_t* empty;      // empty[s]: every warp is done with the row in slot s
  int slot_elems;       // elements of one slot of the ring (the mask, then each channel)
  T* out;               // the channel's output plane
  int w, r0, gcol;      // width, first output row, the lane's first global column
  bool writes, vector;  // the lane stores; 16-byte stores (else one value at a time)

  // pass K's row t - K, rounded to the storage type, as output row t - 2K
  __device__ __forceinline__ void store(const float (&o)[V], int t) const {
    T* dst = out + (size_t)(r0 + t - 2 * K) * w + gcol;
    if (vector) {
      if (gcol < w) store_values(dst, o);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (gcol + v < w) st(dst + v, o[v]);
    }
  }

  // Step t: row t of the band's input (global row r0 - K + t) arrives;
  // pass j + 1 turns rows t - j - 2 .. t - j of pass j (a, m, b: above,
  // middle, below) into its row t - j - 1, which is b[j + 1] for the next
  // pass, and pass K's row t - K is output row t - 2K. The caller rotates
  // the three arrays, so no value moves between registers.
  __device__ __forceinline__ void step(float (&a)[KA][V], float (&m)[KA][V], float (&b)[KA][V],
                                       int t) const {
    const int s = t % D;
    tile_copy::mbar_wait(&full[s], (t / D) & 1);
    load_values(image + s * slot_elems, b[0]);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float rows[V];
#pragma unroll
      for (int v = 0; v < V; ++v) rows[v] = plus_twice(a[j][v], m[j][v]) + b[j][v];
      const float left = __shfl_up_sync(0xffffffffu, rows[V - 1], 1);  // lane - 1
      const float right = __shfl_down_sync(0xffffffffu, rows[0], 1);   // lane + 1
      // this pass's output row t - j - 1 takes its mask row (row 0 before
      // the pipeline is full: those rows are never stored)
      const int sm = t <= j ? 0 : (s - j - 1 + D) % D;
      float mk[V];
      load_values(mask + sm * slot_elems, mk);
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float r = v + 1 < V ? rows[v + 1] : right;
        const float l = v > 0 ? rows[v - 1] : left;
        o[v] = ((plus_twice(r, rows[v]) + l) * 0.0625f) * mk[v];
      }
      if (j + 1 < K) {
#pragma unroll
        for (int v = 0; v < V; ++v) b[j + 1][v] = o[v];
      } else if (writes && t >= 2 * K) {
        store(o, t);
      }
    }
    if (K == 0) store(b[0], t);  // the trip alone: the row out as it came in
    // row t - K has served its last pass: its slot may be refilled
    if (t >= K) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[(s - K + D) % D]);
    }
  }
};

template <typename T, int K>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32)
blur_k_kernel(const T* __restrict__ img, const T* __restrict__ interior,
              T* __restrict__ out, int c, int h, int w, int band, int windows, int wpb,
              int path) {
  constexpr int V = k_values<T, K>(), H = k_halo<T, K>(), S = k_step<T, K>();
  constexpr int D = k_ring_rows(K);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + D;
  T* ring = reinterpret_cast<T*>(empty + D);  // 16 D bytes in: 16-byte aligned

  // grid: (channels, group of windows, band), the channels fastest as in
  // B10; the block's warps are (channel, window), `wpb` windows a channel,
  // and its last warp produces
  const int warps = blockDim.x / 32 - 1;
  const int cpb = warps / wpb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch0 = blockIdx.x * cpb, win0 = blockIdx.y * wpb;
  const int chans = min(cpb, c - ch0), wins = min(wpb, windows - win0);
  const int span_max = (wpb - 1) * S + 32 * V;
  const int span = (wins - 1) * S + 32 * V;  // columns of the block's windows
  const int slot = (cpb + 1) * span_max;     // the mask, then each channel
  const int col0 = win0 * S - H;             // the span's first column, unwrapped
  const int r0 = blockIdx.z * band;
  const int rows = min(band, h - r0) + 2 * K;  // input rows of the band
  const size_t plane = (size_t)h * w;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D; ++s) {
      tile_copy::mbar_init(&full[s], path == kVectorPath ? 1 : 32);
      tile_copy::mbar_init(&empty[s], chans * wins);
    }
  }
  __syncthreads();

  if (warp == warps) {
    // the producer: row t of the band into slot t % D once every warp is
    // done with the row D before it, the mask and each channel. The vector
    // path takes a row's span of an array in one bulk copy, or two where it
    // crosses the array's edge (the periodic wrap; a TMA box would fill
    // zeros there); the thread path copies one value a lane at a time.
    if (path == kVectorPath && lane != 0) return;
    const int first = wrap(col0, w);
    for (int t = 0; t < rows; ++t) {
      const int s = t % D;
      if (t >= D) tile_copy::mbar_wait(&empty[s], (t / D - 1) & 1);
      const size_t row = (size_t)wrap(r0 - K + t, h) * w;
      T* dst = ring + (size_t)s * slot;
      if (path == kVectorPath) {
        tile_copy::mbar_expect_tx(&full[s], (chans + 1u) * span * sizeof(T));
        for (int done = 0, pos = first; done < span; pos = 0) {
          const int n = min(span - done, w - pos);
          tile_copy::bulk_load(dst + done, interior + row + pos, n * sizeof(T), &full[s]);
          for (int ci = 0; ci < chans; ++ci)
            tile_copy::bulk_load(dst + (1 + ci) * span_max + done,
                                 img + (ch0 + ci) * plane + row + pos, n * sizeof(T), &full[s]);
          done += n;
        }
      } else {
        for (int e = lane; e < span; e += 32) {
          const size_t col = row + wrap(col0 + e, w);
          dst[e] = interior[col];
          for (int ci = 0; ci < chans; ++ci)
            dst[(1 + ci) * span_max + e] = img[(ch0 + ci) * plane + col];
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  const int ci = warp / wpb, wi = warp - ci * wpb;
  if (ci >= chans || wi >= wins) return;

  const int off = wi * S + lane * V;  // the lane's first column in the span
  KLane<T, K> lane_state{ring + (1 + ci) * span_max + off, ring + off, full, empty, slot,
                         out + (ch0 + ci) * plane, w, r0, col0 + off,
                         lane * V >= H && lane * V + V <= 32 * V - H,
                         path == kVectorPath};
  float a[KLane<T, K>::KA][V], m[KLane<T, K>::KA][V], b[KLane<T, K>::KA][V];
#pragma unroll
  for (int j = 0; j < KLane<T, K>::KA; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) a[j][v] = m[j][v] = b[j][v] = 0.0f;
  int t = 0;
  for (; t + 3 <= rows; t += 3) {
    lane_state.step(a, m, b, t);
    lane_state.step(m, b, a, t + 1);
    lane_state.step(b, a, m, t + 2);
  }
  if (t < rows) lane_state.step(a, m, b, t);
  if (t + 1 < rows) lane_state.step(m, b, a, t + 1);
}

// Mirrored by stencil.blur_k_smem_bytes on the Python side: for each row of
// the ring its full and empty barriers, and the block's span of the mask row
// and of each channel's image row.
template <typename T, int K>
size_t blur_k_smem_bytes(int channels, int windows) {
  const int span = (windows - 1) * k_step<T, K>() + 32 * k_values<T, K>();
  return (size_t)k_ring_rows(K) *
         (2 * sizeof(uint64_t) + (size_t)(channels + 1) * span * sizeof(T));
}

template <typename T, int K>
int launch_k_instance(const T* img, const T* interior, T* out, int c, int h, int w,
                      int band, int wpb, int path, cudaStream_t stream) {
  const int windows = (w + k_step<T, K>() - 1) / k_step<T, K>();
  wpb = min(wpb, windows);
  const int cpb = k_channels(c, wpb);
  const int groups = (windows + wpb - 1) / wpb, bands = (h + band - 1) / band;
  if (groups > 65535 || bands > 65535) return kBadArgument;
  const size_t smem = blur_k_smem_bytes<T, K>(cpb, wpb);
  cudaError_t err = cudaFuncSetAttribute(
      blur_k_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  blur_k_kernel<T, K><<<dim3((c + cpb - 1) / cpb, groups, bands), (cpb * wpb + 1) * 32, smem,
                        stream>>>(img, interior, out, c, h, w, band, windows, wpb, path);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* img, const void* interior, void* out, int c, int h, int w,
             int band, int k, int wpb, int path, cudaStream_t stream) {
  const bool aligned = ((size_t)w * sizeof(T)) % 16 == 0 &&
                       ((uintptr_t)img | (uintptr_t)interior | (uintptr_t)out) % 16 == 0;
  if (c < 1 || h < 1 || w < 1 || band < 1 || wpb < 1 ||
      wpb > kMaxWarps || (path != kVectorPath && path != kThreadPath) ||
      (path == kVectorPath && !aligned))
    return kBadArgument;
  const T* i = static_cast<const T*>(img);
  const T* m = static_cast<const T*>(interior);
  T* o = static_cast<T*>(out);
  switch (k) {
    case 0: return launch_k_instance<T, 0>(i, m, o, c, h, w, band, wpb, path, stream);
    case 1: return launch_k_instance<T, 1>(i, m, o, c, h, w, band, wpb, path, stream);
    case 2: return launch_k_instance<T, 2>(i, m, o, c, h, w, band, wpb, path, stream);
    case 3: return launch_k_instance<T, 3>(i, m, o, c, h, w, band, wpb, path, stream);
    case 4: return launch_k_instance<T, 4>(i, m, o, c, h, w, band, wpb, path, stream);
    case 5: return launch_k_instance<T, 5>(i, m, o, c, h, w, band, wpb, path, stream);
    case 6: return launch_k_instance<T, 6>(i, m, o, c, h, w, band, wpb, path, stream);
    case 7: return launch_k_instance<T, 7>(i, m, o, c, h, w, band, wpb, path, stream);
    case 8: return launch_k_instance<T, 8>(i, m, o, c, h, w, band, wpb, path, stream);
    default: return kBadArgument;
  }
}

}  // namespace

extern "C" {

// B10: out = one pass over img (C, h, w); out must not alias img.
int stencil_step_f32(const void* img, const void* interior, void* out, int c,
                     int h, int w, void* stream) {
  return launch_step<float>(img, interior, out, c, h, w,
                            static_cast<cudaStream_t>(stream));
}
int stencil_step_bf16(const void* img, const void* interior, void* out, int c,
                      int h, int w, void* stream) {
  return launch_step<__nv_bfloat16>(img, interior, out, c, h, w,
                                    static_cast<cudaStream_t>(stream));
}

// B9: out = k passes over img, bands of `band` rows, `windows` column
// windows a channel in a block, as many channels a block as fit eight
// consumer warps (k = 0: the trip alone, out = img through the ring, for
// measurements); path 0 (vector: bulk copies and 16-byte accesses, which
// need rows of whole 16-byte pieces and 16-byte aligned arrays) or 1
// (thread: one value at a time); out must not alias img. Returns -3 on an
// argument the kernel does not take.
int stencil_k_f32(const void* img, const void* interior, void* out, int c,
                  int h, int w, int band, int k, int windows, int path,
                  void* stream) {
  return launch_k<float>(img, interior, out, c, h, w, band, k, windows, path,
                         static_cast<cudaStream_t>(stream));
}
int stencil_k_bf16(const void* img, const void* interior, void* out, int c,
                   int h, int w, int band, int k, int windows, int path,
                   void* stream) {
  return launch_k<__nv_bfloat16>(img, interior, out, c, h, w, band, k, windows, path,
                                 static_cast<cudaStream_t>(stream));
}

// Shared memory of a block of B9 with `channels` channels of `windows`
// windows (the ring and its barriers); 0 for a k or type it does not take.
// Mirrored by stencil.blur_k_smem_bytes.
int stencil_k_smem_bytes(int channels, int windows, int k, int itemsize) {
  if (itemsize != 4 && itemsize != 2) return 0;
  switch (k) {
#define B9_SMEM(K)                                                                   \
  case K:                                                                            \
    return (int)(itemsize == 4 ? blur_k_smem_bytes<float, K>(channels, windows)     \
                               : blur_k_smem_bytes<__nv_bfloat16, K>(channels, windows));
    B9_SMEM(1) B9_SMEM(2) B9_SMEM(3) B9_SMEM(4) B9_SMEM(5) B9_SMEM(6) B9_SMEM(7) B9_SMEM(8)
#undef B9_SMEM
    default: return 0;
  }
}

// B8: out = num_passes passes over img, in one cooperative launch of
// c * ceil(h/th) * ceil(w/tw) blocks of `threads` threads, k passes a block
// between two exchanges of tile edges; out must not alias img. xrow holds
// 2 * c * ceil(h/th) * 2 * k * w exchange words (unsigned 64-bit) and xcol
// 2 * c * ceil(w/tw) * 2 * k * h; no word of either may carry a tag above
// tag0. Returns -1 when the blocks cannot all be resident at once, -2 when
// the device has no cooperative launch, -3 on a tile, depth or thread count
// the kernel does not take.
int stencil_resident_f32(const void* img, const void* interior, void* out,
                         void* xrow, void* xcol, int c, int h, int w, int th,
                         int tw, int num_passes, int k, unsigned tag0, int threads,
                         void* stream) {
  return launch_resident<float, V0>(img, interior, out, xrow, xcol, c, h, w, th, tw,
                                    0, 0, num_passes, k, tag0, threads,
                                    static_cast<cudaStream_t>(stream));
}
int stencil_resident_bf16(const void* img, const void* interior, void* out,
                          void* xrow, void* xcol, int c, int h, int w, int th,
                          int tw, int num_passes, int k, unsigned tag0, int threads,
                          void* stream) {
  return launch_resident<__nv_bfloat16, V0>(img, interior, out, xrow, xcol, c, h, w,
                                            th, tw, 0, 0, num_passes, k, tag0, threads,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

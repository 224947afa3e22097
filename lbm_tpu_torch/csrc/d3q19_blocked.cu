// K D3Q19 lattice-Boltzmann steps of every (tz, ty, tx) tile in ONE trip
// through device memory, for NVIDIA Hopper (sm_90a).
//
// Replaces the (z, y)-blocked Pallas TPU kernels of the JAX package:
//   B7  lbm_tpu/ops/d3q19_pallas.py                  _blocked_kernel (in -> out)
//   B5  lbm_tpu/ops/d3q19_pallas_inplace_blocked.py  _kernel  (written back in place)
// Both compute, for every block of the (19, nz, ny, nx) lattice, K times:
// periodic pull streaming of the block extended by a K-cell halo, then the
// collision of d3q19.collide_fields (bounce-back on obstacles, the force on
// the accelerated plane) on a region that shrinks by one cell per side and
// step; and per step Sum|u| over the block's own free cells inside planes
// [valid_lo, valid_hi) x rows [row_lo, row_hi). They return the state after K
// steps and the K sums. A plane is tested for the force at its wrapped index,
// ((z mod nz) + plane_offset) mod global_nz == accel_plane, halo planes too,
// so K steps of the whole periodic array (d3q19_kstep.stepk_plain, and the
// one-step kernels B4 and B6) give the same cells for every window.
//
// What bounds it on this card: a pass reads the lattice and the mask once and
// writes the lattice once (153 bytes a cell at f32, whatever K), against
// ~180 K floating-point operations a cell: the bytes take longer up to K = 8.
// The one-step kernels of d3q19_kstep.cu move those bytes K times. Measured on
// an H100 (700 W) at 32x256x256 float32, this kernel is nevertheless the
// slower at every K (0.34 ms per K=2 pass against 2 x 0.12): what it spends is
// not the bytes but the steps in shared memory, on a region 1.5 to 4 times
// the tile, with the one or two blocks an SM holds (PERF.md).
//
// Design. The TPU blocks hold whole nx rows of (bz + 2K) x (by + 2K) rows in
// VMEM. A block here has 227 KB of shared memory, 76 bytes a cell at f32, so
// x is blocked too and a tile is small:
//   * a thread block loads its (tz, ty, tx) tile and the K-cell halo on all
//     six sides into shared memory (periodic wrap by index; any grid shape,
//     edge tiles are masked at the store), steps K times there and writes
//     its tile once. One launch advances the whole lattice K steps. Of the
//     outermost cells it loads only the speeds that point inwards: a slot is
//     loaded if the first step reads it, which makes 19 values per cell of
//     the first step's region. The last step's region is the tile itself
//     and goes straight from registers to device memory;
//   * ONE buffer holds the extended tile through all K steps. Two buffers
//     would halve the tile, and the halo already costs 3 to 5 cells loaded
//     per cell kept. The steps alternate as B4's do in device memory (the AA
//     pattern): an odd step pulls speed q of cell x from slot (x - e_q, q)
//     and writes the collided value of the opposite speed back to that slot;
//     an even step finds all it would pull in its own cell, slot (x, opp(q)),
//     and writes slot (x, q). Each slot has one reader and writer per step,
//     so a step needs one barrier, and no swap pass follows an odd K;
//   * a thread walks the cells of the step's region with stride blockDim.x
//     and adds |u| of the tile's own cells in that order; the block's sum
//     goes to partials[step, block] and a last small kernel adds the blocks
//     in a fixed order. No float atomics: reruns are bit-identical;
//   * B7 is one launch of blocked_kernel over all tiles, f -> out;
//   * B5 (in place): blocks run in no order, and a tile's store would
//     destroy halo cells its neighbours have yet to load. As on the TPU the
//     z-rows of tiles go in order, here as stream-ordered launches of the
//     same kernel, one per z-row. Row iz writes its tiles to a ring of
//     lag + 1 rows in device memory (lag = ceil(K / tz), 1 when K <= tz);
//     once row iz has run, no later row reads the old planes of row
//     iz - lag, and a copy kernel flushes that row from the ring into f. The
//     last rows read planes [0, K) as they were from a snapshot taken first
//     (row 0 was flushed long before). So every cell still makes one trip per
//     K steps, plus one through the ring, which a z-row mostly leaves in L2,
//     and memory stays at the lattice plus lag + 1 rows and K planes;
//   * B5 and B7 run the same kernel with the same tile on the same values:
//     bit-identical state and, tile for tile, Sum|u|. With -fmad=false and
//     the shared collide_cell a recomputed halo cell gets its owner's bits,
//     so the state also equals B6's.
//
// Interface: plain C, one entry per (kernel, dtype), launching on the given
// stream and returning cudaGetLastError() after every launch. The kernels
// allocate nothing; the caller passes every buffer.

#include "d3q19_collide.cuh"

namespace {

// cells a block keeps
struct Tile {
  int tz, ty, tx;
};

// 128 registers a thread at float32, 255 at float64 (19 + 19 values in flight)
template <typename T>
struct MaxThreads {
  static constexpr int value = sizeof(T) == 4 ? 512 : 256;
};

// Shared memory of a block: 19 values and a mask byte per cell of the
// extended tile (d3q19_kstep_blocked.shared_bytes computes the same).
template <typename T>
size_t shared_bytes(const Tile& t, int k) {
  const size_t cells = (size_t)(t.tz + 2 * k) * (t.ty + 2 * k) * (t.tx + 2 * k);
  return cells * (kQ * sizeof(T) + 1);
}

// Where a launch reads old planes that f no longer holds, and where it writes.
template <typename T>
struct Route {
  const T* snap;    // planes [0, nsnap) of the old state, or null
  int nsnap;
  T* out;           // out[q * out_vol + (z - out_z0) * ny * nx + y * nx + x]
  size_t out_vol;
  int out_z0;
  int row0;         // blockIdx.z = 0 is this z-row of tiles
  int nblocks;      // tiles of the whole lattice (the stride of partials)
};

// i / d for 0 <= i < 65536 and 1 <= d < 65536 by one multiply-high: the cells
// of a region are walked by a flat index, decoded per cell and step.
struct FastDiv {
  unsigned magic;  // ceil(2^32 / d), 0 for d == 1
  int d;
};

__device__ __forceinline__ FastDiv fast_div(int d) {
  return FastDiv{d == 1 ? 0u : (unsigned)((0x100000000ull + d - 1) / d), d};
}

__device__ __forceinline__ int div(int i, const FastDiv& f) {
  return f.d == 1 ? i : (int)__umulhi((unsigned)i, f.magic);
}

// x mod n without a division where x lies within n of [0, n), as the
// coordinates of an extended tile do on all but the smallest grids
__device__ __forceinline__ int wrap_near(int x, int n) {
  if (x < 0) x += n;
  else if (x >= n) x -= n;
  return (unsigned)x < (unsigned)n ? x : wrap(x, n);
}

// (z, y, x) of flat index i in a box whose rows hold f_x cells and whose
// planes hold f_y rows
__device__ __forceinline__ void decode(int i, const FastDiv& f_x, const FastDiv& f_y, int* z,
                                       int* y, int* x) {
  const int rest = div(i, f_x);
  *x = i - rest * f_x.d;
  *z = div(rest, f_y);
  *y = rest - *z * f_y.d;
}

template <typename T>
__global__ void __launch_bounds__(MaxThreads<T>::value)
blocked_kernel(const T* __restrict__ f, const uint8_t* __restrict__ mask,
               T* __restrict__ partials, Grid g, Tile t, int k, Route<T> r,
               Window win, Coef<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[MaxThreads<T>::value / 32];
  const int ez = t.tz + 2 * k, ey = t.ty + 2 * k, ex = t.tx + 2 * k;
  const int ecells = ez * ey * ex;
  T* buf = reinterpret_cast<T*>(smem);   // buf[q * ecells + cell]
  uint8_t* obst = smem + (size_t)kQ * ecells * sizeof(T);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row = r.row0 + blockIdx.z;
  // unwrapped coordinates of the extended tile's first cell
  const int z0 = row * t.tz - k, y0 = blockIdx.y * t.ty - k, x0 = blockIdx.x * t.tx - k;
  const size_t plane = (size_t)g.ny * g.nx, vol = plane * g.nz;

  // Load. Slot (cell, q) is read once, in the first step, by the cell at
  // cell + e_q: it is loaded only if that cell lies in the first step's
  // region (the extended tile less one cell per side). So a block loads 19
  // values per cell of that region, not per cell of the extended tile.
  {
    const FastDiv f_x = fast_div(ex), f_y = fast_div(ey);
    for (int i = tid; i < ecells; i += nthreads) {
      int lz, ly, lx;
      decode(i, f_x, f_y, &lz, &ly, &lx);
      const int uz = z0 + lz;
      const int z = wrap_near(uz, g.nz), y = wrap_near(y0 + ly, g.ny),
                x = wrap_near(x0 + lx, g.nx);
      const size_t in_plane = (size_t)y * g.nx + x;
      // whether coordinate - 1, itself, + 1 lies in the first step's region
      const bool zin[3] = {lz >= 2, lz >= 1 && lz < ez - 1, lz < ez - 2};
      const bool yin[3] = {ly >= 2, ly >= 1 && ly < ey - 1, ly < ey - 2};
      const bool xin[3] = {lx >= 2, lx >= 1 && lx < ex - 1, lx < ex - 2};
      if (zin[1] && yin[1] && xin[1]) obst[i] = mask[(size_t)z * plane + in_plane];
      const T* src = f + (size_t)z * plane + in_plane;
      size_t src_vol = vol;
      if (r.snap != nullptr && uz >= g.nz && z < r.nsnap) {
        src = r.snap + (size_t)z * plane + in_plane;
        src_vol = (size_t)r.nsnap * plane;
      }
      // all the loads first, each under its own predicate, so that they are
      // in flight together; a slot nobody reads gets a zero
      T v[kQ];
#define LOAD(q, dz, dy, dx, opp) \
  v[q] = (zin[1 + (dz)] && yin[1 + (dy)] && xin[1 + (dx)]) ? src[(size_t)(q) * src_vol] : T(0);
      D3Q19_SPEEDS(LOAD)
#undef LOAD
#pragma unroll
      for (int q = 0; q < kQ; ++q) buf[q * ecells + i] = v[q];
    }
  }
  __syncthreads();

  const int sz = ey * ex, sy = ex;  // strides of the extended tile
  for (int j = 1; j <= k; ++j) {
    const int ry = ey - 2 * j, rx = ex - 2 * j;
    const int rcells = (ez - 2 * j) * ry * rx;
    const FastDiv f_x = fast_div(rx), f_y = fast_div(ry);
    const bool pull = (j & 1) != 0;
    const bool last = j == k;  // the region is the tile: straight to device memory
    T usum = T(0);
    for (int i = tid; i < rcells; i += nthreads) {
      int lz, ly, lx;
      decode(i, f_x, f_y, &lz, &ly, &lx);
      lz += j, ly += j, lx += j;
      const int oz = z0 + lz, oy = y0 + ly, ox = x0 + lx;  // unwrapped
      // the tile's own cells inside the grid
      const bool own = lz >= k && lz < k + t.tz && ly >= k && ly < k + t.ty && lx >= k &&
                       lx < k + t.tx && oz < g.nz && oy < g.ny && ox < g.nx;
      if (last && !own) continue;
      const int c = lz * sz + ly * sy + lx;
      T s[kQ], o[kQ];
      if (pull) {
#define LOAD(q, dz, dy, dx, opp) s[q] = buf[(q) * ecells + c - ((dz) * sz + (dy) * sy + (dx))];
        D3Q19_SPEEDS(LOAD)
#undef LOAD
      } else {
#define LOAD(q, dz, dy, dx, opp) s[q] = buf[(opp) * ecells + c];
        D3Q19_SPEEDS(LOAD)
#undef LOAD
      }
      const int z = wrap_near(oz, g.nz);
      const bool accel = wrap_near(z + win.plane_offset, win.global_nz) == win.accel_plane;
      const T u = collide_cell<T>(s, obst[c] != 0, accel, p, o);
      if (last) {
        T* dst = r.out + (size_t)(oz - r.out_z0) * plane + (size_t)oy * g.nx + ox;
#pragma unroll
        for (int q = 0; q < kQ; ++q) dst[(size_t)q * r.out_vol] = o[q];
      } else if (pull) {
#define STORE(q, dz, dy, dx, opp) buf[(q) * ecells + c - ((dz) * sz + (dy) * sy + (dx))] = o[opp];
        D3Q19_SPEEDS(STORE)
#undef STORE
      } else {
#define STORE(q, dz, dy, dx, opp) buf[(q) * ecells + c] = o[q];
        D3Q19_SPEEDS(STORE)
#undef STORE
      }
      if (own && oz >= win.valid_lo && oz < win.valid_hi && oy >= win.row_lo && oy < win.row_hi)
        usum += u;
    }
    const T tot = block_sum<T>(usum, red, tid, nthreads >> 5);
    if (tid == 0) {
      const size_t bid = ((size_t)row * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      partials[(size_t)(j - 1) * r.nblocks + bid] = tot;
    }
    __syncthreads();
  }
}

// dst[q * dst_vol + i] = src[q * src_vol + i] for the 19 speeds, i < count:
// the snapshot of B5's first planes and the flush of a ring row into f.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
copy_planes_kernel(const T* __restrict__ src, T* __restrict__ dst, size_t src_vol,
                   size_t dst_vol, size_t count) {
  const T* s = src + (size_t)blockIdx.y * src_vol;
  T* d = dst + (size_t)blockIdx.y * dst_vol;
  for (size_t i = (size_t)blockIdx.x * kMaxThreads + threadIdx.x; i < count;
       i += (size_t)gridDim.x * kMaxThreads)
    d[i] = s[i];
}

template <typename T>
cudaError_t copy_planes(const T* src, T* dst, size_t src_vol, size_t dst_vol, size_t count,
                        cudaStream_t stream) {
  const size_t want = (count + kMaxThreads - 1) / kMaxThreads;
  const dim3 grid((unsigned)(want < 4096 ? want : 4096), kQ);
  copy_planes_kernel<T><<<grid, kMaxThreads, 0, stream>>>(src, dst, src_vol, dst_vol, count);
  return cudaGetLastError();
}

struct Tiling {
  int gz, gy, gx, nblocks;
  size_t smem;
};

template <typename T>
cudaError_t make_tiling(const Grid& g, const Tile& t, int threads, int k, Tiling* out) {
  if (t.tz < 1 || t.ty < 1 || t.tx < 1 || k < 1) return cudaErrorInvalidValue;
  if (threads < 32 || threads % 32 || threads > MaxThreads<T>::value) return cudaErrorInvalidValue;
  out->gz = (g.nz + t.tz - 1) / t.tz;
  out->gy = (g.ny + t.ty - 1) / t.ty;
  out->gx = (g.nx + t.tx - 1) / t.tx;
  if (out->gy > 65535 || out->gz > 65535) return cudaErrorInvalidValue;
  out->nblocks = out->gz * out->gy * out->gx;
  out->smem = shared_bytes<T>(t, k);
  return cudaFuncSetAttribute(blocked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)out->smem);
}

// B7: out = K steps of f, one launch over all tiles. out and f are distinct.
template <typename T>
int launch_two_stream(const void* f, const void* mask, void* out, void* partials, void* tot,
                      Grid g, Tile t, int threads, int k, Window win, Coef<T> p,
                      cudaStream_t stream) {
  Tiling tl;
  cudaError_t err = make_tiling<T>(g, t, threads, k, &tl);
  if (err != cudaSuccess) return (int)err;
  const Route<T> r{nullptr, 0, static_cast<T*>(out), (size_t)g.nz * g.ny * g.nx, 0, 0,
                   tl.nblocks};
  blocked_kernel<T><<<dim3(tl.gx, tl.gy, tl.gz), threads, tl.smem, stream>>>(
      static_cast<const T*>(f), static_cast<const uint8_t*>(mask), static_cast<T*>(partials),
      g, t, k, r, win, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials<T>(static_cast<const T*>(partials), tl.nblocks, k, static_cast<T*>(tot),
                         stream);
}

// B5: f = K steps of f. ring holds lag + 1 rows of 19 x tz planes, snap 19 x
// min(K, nz) planes (d3q19_kstep_inplace_blocked.scratch_planes).
template <typename T>
int launch_inplace(void* f, const void* mask, void* ring, void* snap, void* partials,
                   void* tot, Grid g, Tile t, int threads, int k, Window win, Coef<T> p,
                   cudaStream_t stream) {
  Tiling tl;
  cudaError_t err = make_tiling<T>(g, t, threads, k, &tl);
  if (err != cudaSuccess) return (int)err;
  T* lattice = static_cast<T*>(f);
  const size_t plane = (size_t)g.ny * g.nx, vol = plane * g.nz;
  const size_t row_vol = plane * t.tz;
  const int lag = (k + t.tz - 1) / t.tz, ring_rows = lag + 1;
  const int nsnap = k < g.nz ? k : g.nz;
  err = copy_planes<T>(lattice, static_cast<T*>(snap), vol, nsnap * plane, nsnap * plane, stream);
  if (err != cudaSuccess) return (int)err;
  for (int row = 0; row < tl.gz + lag; ++row) {
    if (row < tl.gz) {
      T* slot = static_cast<T*>(ring) + (size_t)(row % ring_rows) * kQ * row_vol;
      const Route<T> r{static_cast<const T*>(snap), nsnap, slot, row_vol, row * t.tz, row,
                       tl.nblocks};
      blocked_kernel<T><<<dim3(tl.gx, tl.gy, 1), threads, tl.smem, stream>>>(
          lattice, static_cast<const uint8_t*>(mask), static_cast<T*>(partials), g, t, k, r,
          win, p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int done = row - lag;  // no later row reads this row's old planes
    if (done >= 0) {
      const int z = done * t.tz;
      const int planes = g.nz - z < t.tz ? g.nz - z : t.tz;
      const T* slot = static_cast<const T*>(ring) + (size_t)(done % ring_rows) * kQ * row_vol;
      err = copy_planes<T>(slot, lattice + (size_t)z * plane, row_vol, vol, planes * plane,
                           stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return sum_partials<T>(static_cast<const T*>(partials), tl.nblocks, k, static_cast<T*>(tot),
                         stream);
}

}  // namespace

#define BLOCKED_ARGS                                                           \
  int nz, int ny, int nx, int tz, int ty, int tx, int threads, int k,          \
      int plane_offset, int valid_lo, int valid_hi, int global_nz, int row_lo, \
      int row_hi, int accel_plane, double omo, double wo0, double wo1,         \
      double wo2, double fw1, double fw2, void *stream
#define BLOCKED_PASS(T)                                                        \
  Grid{nz, ny, nx}, Tile{tz, ty, tx}, threads, k,                              \
      Window{plane_offset, valid_lo, valid_hi, global_nz, row_lo, row_hi,      \
             accel_plane},                                                     \
      make_coef<T>(omo, wo0, wo1, wo2, fw1, fw2),                              \
      static_cast<cudaStream_t>(stream)

extern "C" {

// B7: out = K steps of f; tot[K] is the per-step Sum|u|; partials holds
// K * (number of tiles) values of scratch.
int d3q19_blocked_f32(const void* f, const void* mask, void* out, void* partials, void* tot,
                      BLOCKED_ARGS) {
  return launch_two_stream<float>(f, mask, out, partials, tot, BLOCKED_PASS(float));
}
int d3q19_blocked_f64(const void* f, const void* mask, void* out, void* partials, void* tot,
                      BLOCKED_ARGS) {
  return launch_two_stream<double>(f, mask, out, partials, tot, BLOCKED_PASS(double));
}

// B5: f = K steps of f, in place, through the ring and the snapshot.
int d3q19_blocked_inplace_f32(void* f, const void* mask, void* ring, void* snap,
                              void* partials, void* tot, BLOCKED_ARGS) {
  return launch_inplace<float>(f, mask, ring, snap, partials, tot, BLOCKED_PASS(float));
}
int d3q19_blocked_inplace_f64(void* f, const void* mask, void* ring, void* snap,
                              void* partials, void* tot, BLOCKED_ARGS) {
  return launch_inplace<double>(f, mask, ring, snap, partials, tot, BLOCKED_PASS(double));
}

}  // extern "C"

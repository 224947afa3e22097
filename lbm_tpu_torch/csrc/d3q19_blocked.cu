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
//     the first step's region. The last step's region is the tile itself;
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
//     lag + 2 rows in device memory (lag = ceil(K / tz), 1 when K <= tz);
//     once row iz has run, no later row reads the old planes of row
//     iz - lag, so the launch of row iz + 1 flushes ring row iz - lag into f
//     with extra blocks of its own grid (blockIdx.z = 1): that launch reads
//     planes of rows >= iz - lag + 1 and writes another ring slot, so the
//     two touch disjoint memory, and no launch of its own and no serial wait
//     are spent on a flush. One launch after the last row flushes the rows
//     left. The last rows read planes [0, K) as they were from a snapshot
//     taken first (row 0 was flushed long before). So every cell still
//     makes one trip per K steps, plus one through the ring, which a z-row
//     mostly leaves in L2, and memory stays at the lattice plus lag + 2 rows
//     and K planes (the schedule's model: tests/test_torch_d3q19_box_plan.py);
//   * two paths move a tile's region (Path, chosen by the wrapper from the
//     shape, d3q19_kstep_blocked.choose_path):
//       - thread: each thread walks the extended tile by a flat index and
//         issues 19 predicated scalar loads a cell (above);
//       - box: the Tensor Memory Accelerator brings the region in as 19
//         rank-4 boxes of a tensor map over the lattice, one a speed, on one
//         mbarrier, while the threads load the mask. Speed q's box is taken
//         one streaming step early in z and y (shifted by -e_q's z and y
//         parts), so it holds planes and rows [1, e - 1) of the extended
//         tile as the first step pulls them: 19 values a cell of the first
//         step's region and its x neighbours, not of the whole extended
//         tile, and a pull then moves in x only (Ext). A box's row starts
//         on 16 bytes (an H100 traps on a box load 8 bytes off 16),
//         round_up(K, 16 / sizeof(T)) columns before the tile, and is as
//         wide after it: at K = 2 in float32 4 columns a side where the halo
//         needs 2, and the kernel indexes 2 columns in. The values that lie
//         outside the grid (a periodic edge) arrive as the boxes' zeros, and
//         the threads then load them from where the thread path reads them
//         (the wrapped cell, or B5's snapshot). Where TMA does not take the
//         shape (rows not whole 16-byte pieces, e.g. nx = 70 in float32;
//         sides over 256, a region beyond the grid), the thread path runs.
//     On both paths the last step stores 19 scalars a cell from registers.
//     A box store of the tile, packed dense in shared memory, made B7's K=2
//     pass at (8, 6, 16) 27.5% slower on an H100 (0.4665 against 0.3658
//     ms), and the last step writing a dense area for it in place of the
//     pack 9.4% slower at the best tiles (0.3752 against 0.3431; PERF.md):
//     with one block an SM, a block waits for the store to read its
//     shared memory before the next may start, where the threads' stores
//     leave at once;
//   * modes (the TPU kernel's diagnostic modes, d3q19_pallas_inplace_blocked
//     .py:353-379): full; stream_only, K pull-streams with no collision and
//     no bounce-back, the rest speed as |u|; copy, the loaded tile written
//     out unchanged through the same store (and B5's ring), Sum|u| zeros;
//   * B5 and B7 run the same kernel with the same tile on the same values:
//     bit-identical state and, tile for tile, Sum|u|, on either path. With
//     -fmad=false and the shared collide_cell a recomputed halo cell gets
//     its owner's bits, so the state also equals B6's.
//
// Interface: plain C, one entry per (kernel, dtype), launching on the given
// stream and returning cudaGetLastError() after every launch (or the error
// of a tensor map that does not encode). The kernels allocate nothing; the
// caller passes every buffer.

#include <cstring>

#include "d3q19_collide.cuh"
#include "tile_copy.cuh"

namespace {

enum Mode { kFull = 0, kStreamOnly = 1, kCopy = 2 };  // d2q9_kstep.MODES
enum Path { kThreadPath = 0, kBoxPath = 1 };          // d3q19_kstep_blocked.PATHS

// Shared memory a block may use on Hopper, and what the wrapper keeps aside
// for the kernel's static shared memory (d3q19_kstep_blocked.STATIC_SMEM).
constexpr size_t kSmemPerBlock = 232448;
constexpr size_t kStaticSmem = 128;

// e_q's z and y parts by speed, for a speed known only at run time
#define D3Q19_DZ(q, dz, dy, dx, opp) dz,
#define D3Q19_DY(q, dz, dy, dx, opp) dy,
__constant__ int kDz[kQ] = {D3Q19_SPEEDS(D3Q19_DZ)};
__constant__ int kDy[kQ] = {D3Q19_SPEEDS(D3Q19_DY)};
#undef D3Q19_DZ
#undef D3Q19_DY

// cells a block keeps
struct Tile {
  int tz, ty, tx;
};

// 128 registers a thread at float32, 255 at float64 (19 + 19 values in flight)
template <typename T>
struct MaxThreads {
  static constexpr int value = sizeof(T) == 4 ? 512 : 256;
};

// The extended tile, (ez, ey, ex) cells (the tile and K a side), and the
// buffer that holds it in shared memory: nz_b planes of ny_b rows of sx
// values, from plane oz and row oy of the extended tile, its first column lp
// values into a row; `pitch` values a speed, `cells` = nz_b ny_b sx.
//   * thread path: the whole extended tile (oz = oy = lp = 0, sx = ex, pitch
//     = cells), speed q of cell c in slot (c, q);
//   * box path: speed q's box is taken one streaming step early in z and y
//     (e_q's z and y parts), so that every first-step cell finds what it
//     pulls in its own plane and row: the buffer holds planes [1, ez - 1)
//     and rows [1, ey - 1) of the extended tile (oz = oy = 1), whatever
//     each speed's shift. Value (cell c, speed q) of the extended tile's
//     state lies at buf[q pitch + c + dz_q sz + dy_q sy]: the z and y parts
//     of a pull cancel, so a pull only moves in x. A row runs from
//     round_up(K, a) columns before the tile to as many after it (a = 16 /
//     sizeof(T) values: a box load starts on 16 bytes), lp = round_up(K, a) -
//     K; each speed's plane starts on 128 bytes (where a box lands).
// Box path: 19 boxes of nz_b x ny_b x sx values move the 19 speeds of the
// first step's region and its neighbours in x only, not of the whole
// extended tile: 1,920 cells at (8, 6, 16), K = 2, against the thread
// path's 2,400.
struct Ext {
  int ez, ey, ex, oz, oy, sx, lp, cells, pitch;
};

__host__ __device__ inline Ext ext_of(const Tile& t, int k, int elem, bool box) {
  const int a = 16 / elem, rk = (k + a - 1) / a * a;
  Ext e;
  e.ez = t.tz + 2 * k;
  e.ey = t.ty + 2 * k;
  e.ex = t.tx + 2 * k;
  e.oz = e.oy = box ? 1 : 0;
  e.lp = box ? rk - k : 0;
  e.sx = box ? t.tx + 2 * rk : e.ex;
  e.cells = (e.ez - 2 * e.oz) * (e.ey - 2 * e.oy) * e.sx;
  e.pitch = box ? (e.cells * elem + 127) / 128 * 128 / elem : e.cells;
  return e;
}

// Byte offset of the box path's mbarrier from the aligned base: after the
// 19 speeds and the mask byte of every cell, on 8 bytes.
template <typename T>
__host__ __device__ inline size_t bar_offset(const Ext& e) {
  return ((size_t)kQ * e.pitch * sizeof(T) + e.cells + 7) / 8 * 8;
}

// Dynamic shared memory of a block: 19 values and a mask byte a cell of the
// buffer; the box path adds 128 bytes of slack to align the base and the
// mbarrier (d3q19_kstep_blocked.shared_bytes and box_shared_bytes).
template <typename T>
size_t shared_bytes(const Ext& e, bool box) {
  return box ? 128 + bar_offset<T>(e) + 8 : (size_t)e.cells * (kQ * sizeof(T) + 1);
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
  int tile_rows;    // blockIdx.z < tile_rows: a tile; the rest flush (B5)
  int nblocks;      // tiles of the whole lattice (the stride of partials)
  // B5's flush: block z = tile_rows + i copies ring row flush_row0 + i into
  // the lattice; ring row d lies in slot d % ring_rows
  const T* ring;
  int ring_rows;
  int flush_row0;
  T* lattice;
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

// A flush block's share of B5's ring row d: its planes of the lattice from
// the row's ring slot, 16 bytes a piece where both sides allow it.
template <typename T>
__device__ void flush_share(const Grid& g, const Tile& t, const Route<T>& r, int d) {
  const size_t plane = (size_t)g.ny * g.nx, vol = plane * g.nz, row_vol = plane * t.tz;
  const int planes = min(t.tz, g.nz - d * t.tz);
  const T* slot = r.ring + (size_t)(d % r.ring_rows) * kQ * row_vol;
  T* dst = r.lattice + (size_t)d * t.tz * plane;
  const size_t count = (size_t)planes * plane;
  const size_t first = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * gridDim.y * blockDim.x;
  const bool wide = (count * sizeof(T)) % 16 == 0 && (row_vol * sizeof(T)) % 16 == 0 &&
                    (vol * sizeof(T)) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(slot) | reinterpret_cast<uintptr_t>(dst)) % 16 == 0;
  for (int q = 0; q < kQ; ++q) {
    const T* s = slot + q * row_vol;
    T* o = dst + q * vol;
    if (wide) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* o4 = reinterpret_cast<uint4*>(o);
      const size_t n4 = count * sizeof(T) / 16;
      for (size_t i = first; i < n4; i += stride) o4[i] = s4[i];
    } else {
      for (size_t i = first; i < count; i += stride) o[i] = s[i];
    }
  }
}

template <typename T, int kMode, bool kBox>
__global__ void __launch_bounds__(MaxThreads<T>::value)
blocked_kernel(const __grid_constant__ CUtensorMap region, const T* __restrict__ f,
               const uint8_t* __restrict__ mask, T* __restrict__ partials, Grid g, Tile t, int k,
               Route<T> r, Window win, Coef<T> p) {
  if ((int)blockIdx.z >= r.tile_rows) {  // B5: an extra block that flushes a ring row
    flush_share<T>(g, t, r, r.flush_row0 + (int)blockIdx.z - r.tile_rows);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[MaxThreads<T>::value / 32];
  const Ext e = ext_of(t, k, sizeof(T), kBox);
  unsigned char* smem = kBox ? tile_copy::align128<unsigned char>(smem_raw) : smem_raw;
  // speed q of extended-tile cell (lz, ly, lx) at buf[q * pitch + c + SHIFT(q)],
  // c = (lz - oz) * sz + (ly - oy) * sy + lp + lx (see Ext)
  T* buf = reinterpret_cast<T*>(smem);
  uint8_t* obst = smem + (size_t)kQ * e.pitch * sizeof(T);  // obst[c]
  const int ez = e.ez, ey = e.ey, ex = e.ex, pitch = e.pitch;
  const int sz = (ey - 2 * e.oy) * e.sx, sy = e.sx;  // strides of the buffer
  // the box path's shift of speed q: SHIFT(q) = dz_q zs + dy_q ys (none in
  // copy mode, whose boxes are not shifted: it steps nothing)
  constexpr int kShift = kBox && kMode != kCopy ? 1 : 0;
  const int zs = kShift * sz, ys = kShift * sy;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row = r.row0 + blockIdx.z;
  // unwrapped coordinates of the extended tile's first cell
  const int z0 = row * t.tz - k, y0 = blockIdx.y * t.ty - k, x0 = blockIdx.x * t.tx - k;
  const size_t plane = (size_t)g.ny * g.nx, vol = plane * g.nz;

  if (!kBox) {
    // Load. Slot (cell, q) is read once, in the first step, by the cell at
    // cell + e_q: it is loaded only if that cell lies in the first step's
    // region (the extended tile less one cell per side). So a block loads 19
    // values per cell of that region, not per cell of the extended tile. The
    // copy mode loads every speed of the tile's own cells too.
    const FastDiv fe_x = fast_div(ex), fe_y = fast_div(ey);
    for (int i = tid; i < e.cells; i += nthreads) {
      int lz, ly, lx;
      decode(i, fe_x, fe_y, &lz, &ly, &lx);
      const int uz = z0 + lz;
      const int z = wrap_near(uz, g.nz), y = wrap_near(y0 + ly, g.ny),
                x = wrap_near(x0 + lx, g.nx);
      const size_t in_plane = (size_t)y * g.nx + x;
      // whether coordinate - 1, itself, + 1 lies in the first step's region
      const bool zin[3] = {lz >= 2, lz >= 1 && lz < ez - 1, lz < ez - 2};
      const bool yin[3] = {ly >= 2, ly >= 1 && ly < ey - 1, ly < ey - 2};
      const bool xin[3] = {lx >= 2, lx >= 1 && lx < ex - 1, lx < ex - 2};
      const bool keep = kMode == kCopy && lz >= k && lz < k + t.tz && ly >= k &&
                        ly < k + t.ty && lx >= k && lx < k + t.tx;
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
#define LOAD(q, dz, dy, dx, opp)                                     \
  v[q] = (keep || (zin[1 + (dz)] && yin[1 + (dy)] && xin[1 + (dx)])) \
             ? src[(size_t)(q) * src_vol]                            \
             : T(0);
      D3Q19_SPEEDS(LOAD)
#undef LOAD
#pragma unroll
      for (int q = 0; q < kQ; ++q) buf[q * pitch + i] = v[q];
    }
  } else {
    // Load by 19 boxes, speed q's at planes and rows shifted back by its
    // e_q (copy mode: none, it steps nothing). The mbarrier completes once,
    // on parity 0, when all their bytes (zeros beyond the grid included)
    // have landed.
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + bar_offset<T>(e));
    if (tid == 0) {
      tile_copy::mbar_init(bar, 1);
      tile_copy::mbar_expect_tx(bar, (uint32_t)((size_t)kQ * e.cells * sizeof(T)));
#define BOX(q, dz, dy, dx, opp)                                                   \
  tile_copy::box_load4(&region, buf + (q) * pitch, bar, x0 - e.lp, y0 + 1 - (dy) * kShift, \
                       z0 + 1 - (dz) * kShift, q);
      D3Q19_SPEEDS(BOX)
#undef BOX
    }
    // while the boxes are in flight: the mask of the first step's region
    {
      const FastDiv fr_x = fast_div(ex - 2), fr_y = fast_div(ey - 2);
      for (int i = tid; i < (ez - 2) * (ey - 2) * (ex - 2); i += nthreads) {
        int lz, ly, lx;
        decode(i, fr_x, fr_y, &lz, &ly, &lx);
        obst[lz * sz + ly * sy + e.lp + lx + 1] =
            mask[(size_t)wrap_near(z0 + 1 + lz, g.nz) * plane +
                 (size_t)wrap_near(y0 + 1 + ly, g.ny) * g.nx + wrap_near(x0 + 1 + lx, g.nx)];
      }
    }
    __syncthreads();  // the mbarrier is initialised before anyone waits on it
    tile_copy::mbar_wait(bar, 0);
    // The values beyond a periodic edge came as the boxes' zeros: each from
    // where the thread path reads it (the wrapped cell; B5's last rows from
    // the snapshot), after the wait (the boxes wrote them too). A thread a
    // buffer row of one speed: the whole row where its plane or row lies
    // beyond the grid, else the columns that do.
    const bool x_wraps = x0 < 0 || x0 + ex > g.nx;
    if (z0 < 0 || z0 + ez > g.nz || y0 < 0 || y0 + ey > g.ny || x_wraps) {
      const int nzb = ez - 2, nyb = ey - 2;
      for (int i = tid; i < kQ * nzb * nyb; i += nthreads) {
        const int q = i / (nzb * nyb), zy = i - q * (nzb * nyb), bz = zy / nyb, by = zy - bz * nyb;
        const int uz = z0 + 1 - kDz[q] * kShift + bz, uy = y0 + 1 - kDy[q] * kShift + by;
        const bool row_out = (unsigned)uz >= (unsigned)g.nz || (unsigned)uy >= (unsigned)g.ny;
        if (!row_out && !x_wraps) continue;
        const int z = wrap_near(uz, g.nz);
        const T* src = f + (size_t)q * vol + (size_t)z * plane;
        if (r.snap != nullptr && uz >= g.nz && z < r.nsnap)
          src = r.snap + (size_t)q * r.nsnap * plane + (size_t)z * plane;
        src += (size_t)wrap_near(uy, g.ny) * g.nx;
        T* dst = buf + q * pitch + bz * sz + by * sy + e.lp;
        for (int lx = 0; lx < ex; ++lx) {
          const int ux = x0 + lx;
          if (row_out || (unsigned)ux >= (unsigned)g.nx) dst[lx] = src[wrap_near(ux, g.nx)];
        }
      }
    }
  }
  __syncthreads();

  const size_t bid = ((size_t)row * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (kMode == kCopy) {
    if (tid == 0)
      for (int j = 0; j < k; ++j) partials[(size_t)j * r.nblocks + bid] = T(0);
    // the tile's own cells in the grid, as loaded
    const FastDiv ft_x = fast_div(t.tx), ft_y = fast_div(t.ty);
    for (int i = tid; i < t.tz * t.ty * t.tx; i += nthreads) {
      int z, y, x;
      decode(i, ft_x, ft_y, &z, &y, &x);
      const int oz = row * t.tz + z, oy = blockIdx.y * t.ty + y, ox = blockIdx.x * t.tx + x;
      if (oz >= g.nz || oy >= g.ny || ox >= g.nx) continue;
      const int c = (k + z - e.oz) * sz + (k + y - e.oy) * sy + e.lp + k + x;
      T* dst = r.out + (size_t)(oz - r.out_z0) * plane + (size_t)oy * g.nx + ox;
#pragma unroll
      for (int q = 0; q < kQ; ++q) dst[(size_t)q * r.out_vol] = buf[q * pitch + c];
    }
  } else {
    for (int j = 1; j <= k; ++j) {
      const int ry = ey - 2 * j, rx = ex - 2 * j;
      const int rcells = (ez - 2 * j) * ry * rx;
      const FastDiv f_x = fast_div(rx), f_y = fast_div(ry);
      const bool pull = (j & 1) != 0;
      const bool last = j == k;  // the region is the tile
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
        const int c = (lz - e.oz) * sz + (ly - e.oy) * sy + e.lp + lx;
        T s[kQ], o[kQ];
        // an odd step pulls speed q of cell c from slot (c - e_q, q); an even
        // one finds it in (c, opp(q)) (the AA pattern)
        if (pull) {
#define LOAD(q, dz, dy, dx, opp) \
  s[q] = buf[(q) * pitch + c - ((dz) * (sz - zs) + (dy) * (sy - ys) + (dx))];
          D3Q19_SPEEDS(LOAD)
#undef LOAD
        } else {
#define LOAD(q, dz, dy, dx, opp) s[q] = buf[(opp) * pitch + c - ((dz) * zs + (dy) * ys)];
          D3Q19_SPEEDS(LOAD)
#undef LOAD
        }
        T u;
        if (kMode == kStreamOnly) {
#pragma unroll
          for (int q = 0; q < kQ; ++q) o[q] = s[q];
          u = s[0];
        } else {
          const int z = wrap_near(oz, g.nz);
          const bool accel = wrap_near(z + win.plane_offset, win.global_nz) == win.accel_plane;
          u = collide_cell<T>(s, obst[c] != 0, accel, p, o);
        }
        if (last) {  // straight to device memory
          T* dst = r.out + (size_t)(oz - r.out_z0) * plane + (size_t)oy * g.nx + ox;
#pragma unroll
          for (int q = 0; q < kQ; ++q) dst[(size_t)q * r.out_vol] = o[q];
        } else if (pull) {
#define STORE(q, dz, dy, dx, opp) \
  buf[(q) * pitch + c - ((dz) * (sz - zs) + (dy) * (sy - ys) + (dx))] = o[opp];
          D3Q19_SPEEDS(STORE)
#undef STORE
        } else {
#define STORE(q, dz, dy, dx, opp) buf[(q) * pitch + c + (dz) * zs + (dy) * ys] = o[q];
          D3Q19_SPEEDS(STORE)
#undef STORE
        }
        if (own && oz >= win.valid_lo && oz < win.valid_hi && oy >= win.row_lo &&
            oy < win.row_hi)
          usum += u;
      }
      const T tot = block_sum<T>(usum, red, tid, nthreads >> 5);
      if (tid == 0) partials[(size_t)(j - 1) * r.nblocks + bid] = tot;
      __syncthreads();
    }
  }

}

// dst[q * dst_vol + i] = src[q * src_vol + i] for the 19 speeds, i < count:
// the snapshot of B5's first planes.
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

template <typename T, int kMode, bool kBox>
cudaError_t make_tiling(const Grid& g, const Tile& t, int threads, int k, Tiling* out) {
  if (t.tz < 1 || t.ty < 1 || t.tx < 1 || k < 1) return cudaErrorInvalidValue;
  if (threads < 32 || threads % 32 || threads > MaxThreads<T>::value) return cudaErrorInvalidValue;
  out->gz = (g.nz + t.tz - 1) / t.tz;
  out->gy = (g.ny + t.ty - 1) / t.ty;
  out->gx = (g.nx + t.tx - 1) / t.tx;
  if (out->gy > 65535 || out->gz > 65535) return cudaErrorInvalidValue;
  out->nblocks = out->gz * out->gy * out->gx;
  out->smem = shared_bytes<T>(ext_of(t, k, sizeof(T), kBox), kBox);
  return cudaFuncSetAttribute(blocked_kernel<T, kMode, kBox>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out->smem);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the box path takes this launch (mirrored by
// d3q19_kstep_blocked.choose_path): rows of the lattice and of the tile
// whole 16-byte pieces; box sides of at most 256, the extended tile no
// larger than the grid; the block in shared memory; the lattice on 16 bytes.
template <typename T>
bool box_fits(const Grid& g, const Tile& t, int k, const void* f) {
  constexpr int E = sizeof(T);
  const Ext e = ext_of(t, k, E, true);
  return (t.tx * E) % 16 == 0 && ((size_t)g.nx * E) % 16 == 0 && e.sx <= 256 && e.ey <= 256 &&
         e.ez <= 256 && e.ez <= g.nz && e.ey <= g.ny && e.sx <= g.nx &&
         shared_bytes<T>(e, true) + kStaticSmem <= kSmemPerBlock && aligned16(f);
}

// The map of the region's boxes over the lattice f, (1, ez - 2, ey - 2, sx)
// values each, encoded once per pointer and shape; zeroed on the thread path.
template <typename T, bool kBox>
int region_map(CUtensorMap* map, const void* f, const Grid& g, const Tile& t, int k) {
  memset(map, 0, sizeof *map);
  if (!kBox) return 0;
  if (!box_fits<T>(g, t, k, f)) return (int)cudaErrorInvalidValue;
  const Ext e = ext_of(t, k, sizeof(T), true);
  return tile_copy::encode_map(map, {f, (int)sizeof(T), kQ, g.ny, g.nx, 1, e.ey - 2, e.sx, g.nz,
                                     e.ez - 2});
}

// B7: out = K steps of f, one launch over all tiles. out and f are distinct.
template <typename T, int kMode, bool kBox>
int two_stream(const void* f, const void* mask, void* out, void* partials, void* tot, Grid g,
               Tile t, int threads, int k, Window win, Coef<T> p, cudaStream_t stream) {
  Tiling tl;
  cudaError_t err = make_tiling<T, kMode, kBox>(g, t, threads, k, &tl);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  const int rc = region_map<T, kBox>(&map, f, g, t, k);
  if (rc) return rc;
  const Route<T> r{nullptr, 0, static_cast<T*>(out), (size_t)g.nz * g.ny * g.nx, 0, 0, tl.gz,
                   tl.nblocks, nullptr, 0, 0, nullptr};
  blocked_kernel<T, kMode, kBox><<<dim3(tl.gx, tl.gy, tl.gz), threads, tl.smem, stream>>>(
      map, static_cast<const T*>(f), static_cast<const uint8_t*>(mask),
      static_cast<T*>(partials), g, t, k, r, win, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials<T>(static_cast<const T*>(partials), tl.nblocks, k, static_cast<T*>(tot),
                         stream);
}

// B5: f = K steps of f. ring holds lag + 2 rows of 19 x tz planes, snap 19 x
// min(K, nz) planes (d3q19_kstep_inplace_blocked.scratch_planes). Launch
// `row` steps z-row `row` of tiles into ring slot row % (lag + 2) and, with
// a second z-layer of blocks, flushes ring row row - lag - 1 into f; one
// last launch of flush blocks alone flushes the rows left.
template <typename T, int kMode, bool kBox>
int in_place(void* f, const void* mask, void* ring, void* snap, void* partials, void* tot,
             Grid g, Tile t, int threads, int k, Window win, Coef<T> p, cudaStream_t stream) {
  Tiling tl;
  cudaError_t err = make_tiling<T, kMode, kBox>(g, t, threads, k, &tl);
  if (err != cudaSuccess) return (int)err;
  T* lattice = static_cast<T*>(f);
  const size_t plane = (size_t)g.ny * g.nx, vol = plane * g.nz;
  const size_t row_vol = plane * t.tz;
  const int lag = (k + t.tz - 1) / t.tz, ring_rows = lag + 2;
  const int nsnap = k < g.nz ? k : g.nz;
  CUtensorMap map;
  const int rc = region_map<T, kBox>(&map, f, g, t, k);
  if (rc) return rc;
  err = copy_planes<T>(lattice, static_cast<T*>(snap), vol, nsnap * plane, nsnap * plane, stream);
  if (err != cudaSuccess) return (int)err;
  T* ring_t = static_cast<T*>(ring);
  for (int row = 0; row < tl.gz; ++row) {
    T* slot = ring_t + (size_t)(row % ring_rows) * kQ * row_vol;
    const int flush = row - lag - 1;  // no launch from this one on reads its old planes
    const Route<T> r{static_cast<const T*>(snap), nsnap, slot, row_vol, row * t.tz, row, 1,
                     tl.nblocks, ring_t, ring_rows, flush, lattice};
    blocked_kernel<T, kMode, kBox>
        <<<dim3(tl.gx, tl.gy, flush >= 0 ? 2 : 1), threads, tl.smem, stream>>>(
            map, lattice, static_cast<const uint8_t*>(mask), static_cast<T*>(partials), g, t,
            k, r, win, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the rows not flushed yet, together: no launch reads them any more
  const int first = tl.gz - lag - 1 > 0 ? tl.gz - lag - 1 : 0;
  const Route<T> r{nullptr, 0, nullptr, 0, 0, 0, 0, tl.nblocks, ring_t, ring_rows, first, lattice};
  blocked_kernel<T, kMode, kBox><<<dim3(tl.gx, tl.gy, tl.gz - first), threads, 0, stream>>>(
      map, lattice, static_cast<const uint8_t*>(mask), static_cast<T*>(partials), g, t, k, r,
      win, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials<T>(static_cast<const T*>(partials), tl.nblocks, k, static_cast<T*>(tot),
                         stream);
}

// F<Mode, Box>::run(args...) for the runtime (mode, path); an error for
// values with no instance.
template <template <int, bool> class F, typename... A>
int dispatch(int mode, int path, A... args) {
  if (path != kThreadPath && path != kBoxPath) return (int)cudaErrorInvalidValue;
  const bool box = path == kBoxPath;
  switch (mode) {
    case kFull: return box ? F<kFull, true>::run(args...) : F<kFull, false>::run(args...);
    case kStreamOnly:
      return box ? F<kStreamOnly, true>::run(args...) : F<kStreamOnly, false>::run(args...);
    case kCopy: return box ? F<kCopy, true>::run(args...) : F<kCopy, false>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
struct TwoStream {
  template <int kMode, bool kBox>
  struct Of {
    template <typename... A>
    static int run(A... args) {
      return two_stream<T, kMode, kBox>(args...);
    }
  };
};

template <typename T>
struct InPlace {
  template <int kMode, bool kBox>
  struct Of {
    template <typename... A>
    static int run(A... args) {
      return in_place<T, kMode, kBox>(args...);
    }
  };
};

}  // namespace

#define BLOCKED_ARGS                                                           \
  int mode, int path, int nz, int ny, int nx, int tz, int ty, int tx,          \
      int threads, int k, int plane_offset, int valid_lo, int valid_hi,        \
      int global_nz, int row_lo, int row_hi, int accel_plane, double omo,      \
      double wo0, double wo1, double wo2, double fw1, double fw2, void *stream
#define BLOCKED_PASS(T)                                                        \
  Grid{nz, ny, nx}, Tile{tz, ty, tx}, threads, k,                              \
      Window{plane_offset, valid_lo, valid_hi, global_nz, row_lo, row_hi,      \
             accel_plane},                                                     \
      make_coef<T>(omo, wo0, wo1, wo2, fw1, fw2),                              \
      static_cast<cudaStream_t>(stream)

extern "C" {

// B7: out = K steps of f in mode `mode` (d2q9_kstep.MODES) on path `path`
// (d3q19_kstep_blocked.PATHS; the box path returns an error on a shape it
// does not take); tot[K] is the per-step Sum|u|; partials holds K * (number
// of tiles) values of scratch.
int d3q19_blocked_f32(const void* f, const void* mask, void* out, void* partials, void* tot,
                      BLOCKED_ARGS) {
  return dispatch<TwoStream<float>::Of>(mode, path, f, mask, out, partials, tot,
                                         BLOCKED_PASS(float));
}
int d3q19_blocked_f64(const void* f, const void* mask, void* out, void* partials, void* tot,
                      BLOCKED_ARGS) {
  return dispatch<TwoStream<double>::Of>(mode, path, f, mask, out, partials, tot,
                                          BLOCKED_PASS(double));
}

// B5: f = K steps of f, in place, through the ring and the snapshot.
int d3q19_blocked_inplace_f32(void* f, const void* mask, void* ring, void* snap,
                              void* partials, void* tot, BLOCKED_ARGS) {
  return dispatch<InPlace<float>::Of>(mode, path, f, mask, ring, snap, partials, tot,
                                       BLOCKED_PASS(float));
}
int d3q19_blocked_inplace_f64(void* f, const void* mask, void* ring, void* snap,
                              void* partials, void* tot, BLOCKED_ARGS) {
  return dispatch<InPlace<double>::Of>(mode, path, f, mask, ring, snap, partials, tot,
                                        BLOCKED_PASS(double));
}

}  // extern "C"

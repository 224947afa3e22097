// The copy floor of a 2-D pass, for NVIDIA Hopper (sm_90a): kernel B12.
//
// Replaces the Pallas TPU kernel of experiments/d2q9-blocked-floor/run.py
// (`run_copy`, kernel `_copy_kernel`): one pass of out = in over the (9, ny,
// nx) D2Q9 state in (9, by, bx) tiles, the TPU's BlockSpec blocks. No real
// pass can move the lattice faster, so it bounds every K-step kernel's load
// and store from below, for the K-step tiles as for full-width bands.
//
// What bounds it: bytes, 2 x 9 values a cell and pass (72 B in float32), no
// arithmetic.
//
// Design: one block a tile, ceil(ny/by) x ceil(nx/bx) of them, the tile's 9 x
// by row segments read and written as its work (csrc/tile_copy.cuh moves
// them). Two paths, chosen by the caller from the layout:
//   * tma (rows and tile rows of a multiple of 16 bytes, aligned buffers):
//     one thread walks the tile as chunks, boxes of (cq, cy, cx) that divide
//     it and fit a stage of shared memory; each chunk is one TMA load, an
//     mbarrier wait and one TMA store. A ring of `stages` stages keeps the
//     next chunks' loads in flight while a chunk is stored; a stage is
//     refilled as soon as its store has read it. A (9, 16, 32)
//     float32 tile is one chunk of 18,432 B, so 11 tiles are in flight on
//     an SM, and no thread computes an address: the division and the one
//     round trip of 16-byte pieces a block that held the register copy
//     below `copy_` are gone. Four tiles of one chunk side by side are one
//     cluster, whose blocks meet before their loads (tile_copy::launch_tiles);
//   * scalar, any other width or alignment: the threads copy the tile one
//     value a piece in registers, three in flight a thread, indexed without
//     a division a piece.
//
// Interface: plain C; launches on the given stream and returns
// cudaGetLastError(); allocates nothing.

#include "tile_copy.cuh"

namespace {

using tile_copy::Box;

constexpr int kMaxStages = 4;
constexpr int kThreads = 384;  // scalar path: 384 x 3 values in flight
constexpr int kUnroll = 3;

enum Path { kTma = 0, kScalar = 1 };

struct Chunk {
  int q, y, x;  // a box of the tile: q divides 9, y divides by, x divides bx
};

// bytes from one stage of the ring to the next: TMA's boxes start on 128 B
__host__ __device__ inline int stage_stride(const Chunk& ch, int elem) {
  return (ch.q * ch.y * ch.x * elem + 127) / 128 * 128;
}

template <typename T>
__global__ void __launch_bounds__(32)
copy_tma_kernel(__grid_constant__ const CUtensorMap src, __grid_constant__ const CUtensorMap dst,
                int ny, int nx, int by, int bx, Chunk ch, int stages) {
  extern __shared__ unsigned char smem_raw[];
  tile_copy::cluster_meet();
  if (threadIdx.x) return;  // one thread issues every copy
  const int chunk_bytes = ch.q * ch.y * ch.x * (int)sizeof(T);
  const int stride = stage_stride(ch, sizeof(T));
  unsigned char* ring = tile_copy::align128<unsigned char>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stride);
  const int r0 = blockIdx.y * by, c0 = blockIdx.x * bx;
  const int h = min(by, ny - r0), w = min(bx, nx - c0);
  // chunks of the tile that start in the grid, x fastest, then y, then q
  const int kx = (w + ch.x - 1) / ch.x, ky = (h + ch.y - 1) / ch.y;
  const int n = kx * ky * (9 / ch.q);
  const int ring_len = min(stages, n);
  const auto at = [&](int i, int& x, int& y, int& z) {
    const int row = i / kx;
    x = c0 + (i - row * kx) * ch.x;
    z = row / ky;
    y = r0 + (row - z * ky) * ch.y;
    z *= ch.q;
  };
  const auto fetch = [&](int i) {
    int x, y, z;
    at(i, x, y, z);
    uint64_t* bar = &full[i % ring_len];
    tile_copy::mbar_expect_tx(bar, (uint32_t)chunk_bytes);
    tile_copy::box_load(&src, ring + (i % ring_len) * stride, bar, x, y, z);
  };
  for (int s = 0; s < ring_len; ++s) tile_copy::mbar_init(&full[s], 1);
  for (int i = 0; i < ring_len; ++i) fetch(i);
  for (int i = 0; i < n; ++i) {
    tile_copy::mbar_wait(&full[i % ring_len], (uint32_t)(i / ring_len) & 1u);
    int x, y, z;
    at(i, x, y, z);
    tile_copy::box_store(&dst, ring + (i % ring_len) * stride, x, y, z);
    tile_copy::bulk_commit();
    if (i + ring_len < n) {  // refill the stage once the store has read it
      tile_copy::bulk_wait_read<0>();
      fetch(i + ring_len);
    }
  }
  tile_copy::bulk_wait_read<0>();  // the stores have read the ring before it is freed
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_values_kernel(const T* __restrict__ in, T* __restrict__ out, int ny, int nx, int by,
                   int bx) {
  const int r0 = blockIdx.y * by, c0 = blockIdx.x * bx;
  const Box b{(size_t)r0 * nx + c0, (size_t)ny * nx, nx, min(by, ny - r0), min(bx, nx - c0)};
  tile_copy::copy_box_values<T, kUnroll>(in, out, b, 9);
}

// the dynamic shared memory last set on copy_tma_kernel<T>
template <typename T>
size_t& tma_smem_set() {
  static size_t bytes = 0;
  return bytes;
}

size_t tma_smem(const Chunk& ch, int stages, int elem) {
  return 128 + (size_t)stages * stage_stride(ch, elem) + (size_t)stages * sizeof(uint64_t);
}

template <typename T>
int launch(const void* in, void* out, int ny, int nx, int by, int bx, int path, Chunk ch,
           int stages, cudaStream_t stream) {
  constexpr int E = sizeof(T);
  by = min(by, ny);  // a tile wider than the grid is the grid
  bx = min(bx, nx);
  const dim3 grid((nx + bx - 1) / bx, (ny + by - 1) / by);
  if (path == kTma) {
    if (ch.q < 1 || 9 % ch.q || by % ch.y || bx % ch.x || stages < 1 || stages > kMaxStages ||
        !tile_copy::tma_fits(in, out, E, nx, ch.q, ch.y, ch.x))
      return (int)cudaErrorInvalidValue;
    CUtensorMap src, dst;
    int rc = tile_copy::encode_map(&src, {in, E, 9, ny, nx, ch.q, ch.y, ch.x});
    if (rc == 0) rc = tile_copy::encode_map(&dst, {out, E, 9, ny, nx, ch.q, ch.y, ch.x});
    if (rc) return rc;
    const size_t smem = tma_smem(ch, stages, E);
    const bool one_box = ch.q == 9 && ch.y == by && ch.x == bx;
    cudaError_t err = tile_copy::fit_smem(copy_tma_kernel<T>, smem, tma_smem_set<T>());
    if (err == cudaSuccess)
      err = tile_copy::launch_tiles(copy_tma_kernel<T>, grid, 32, smem, stream, one_box, src, dst,
                                    ny, nx, by, bx, ch, stages);
    if (err != cudaSuccess) return (int)err;
  } else if (path == kScalar) {
    copy_values_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), ny, nx, by, bx);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int tma_blocks_per_sm(int cq, int cy, int cx, int stages) {
  const Chunk ch{cq, cy, cx};
  const size_t smem = tma_smem(ch, stages, sizeof(T));
  if (tile_copy::fit_smem(copy_tma_kernel<T>, smem, tma_smem_set<T>()) != cudaSuccess) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, copy_tma_kernel<T>, 32, smem) !=
      cudaSuccess)
    return 0;
  return per_sm;
}

}  // namespace

extern "C" {

// B12: one pass of out = in over a (9, ny, nx) state of `itemsize`-byte
// values (4 or 8) in (9, by, bx) tiles. `plan` holds {itemsize, ny, nx, by,
// bx, path, cq, cy, cx, stages}: path 0 is TMA, in chunks of (cq, cy, cx)
// through a ring of `stages`, 1 one value a piece in registers. The
// caller keeps the plan for its passes, so that a pass crosses from the
// host in four arguments. out must not alias in.
int copy_floor_run(const int* plan, const void* in, void* out, void* stream) {
  const int itemsize = plan[0], ny = plan[1], nx = plan[2], by = plan[3], bx = plan[4];
  const int path = plan[5], stages = plan[9];
  const Chunk ch{plan[6], plan[7], plan[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return itemsize == 8 ? launch<double>(in, out, ny, nx, by, bx, path, ch, stages, s)
                       : launch<float>(in, out, ny, nx, by, bx, path, ch, stages, s);
}

// Blocks of the TMA path resident on one SM of the current device with
// chunks of (cq, cy, cx) and `stages` stages; 0 on an error.
int copy_floor_tma_blocks(int itemsize, int cq, int cy, int cx, int stages) {
  return itemsize == 8 ? tma_blocks_per_sm<double>(cq, cy, cx, stages)
                       : tma_blocks_per_sm<float>(cq, cy, cx, stages);
}

}  // extern "C"

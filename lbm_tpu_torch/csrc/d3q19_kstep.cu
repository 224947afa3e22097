// K D3Q19 lattice-Boltzmann steps per pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the two z-slab Pallas TPU kernels of the JAX package:
//   B6  lbm_tpu/ops/d3q19_pallas.py          _kernel  (two-stream, in -> out)
//   B4  lbm_tpu/ops/d3q19_pallas_inplace.py  _kernel  (written back in place)
// Both compute, per step, on the (19, nz, ny, nx) lattice: periodic pull
// streaming (speed q at x comes from x - e_q), bounce-back on obstacle cells,
// BGK collision in the 'paired' grouping of d3q19.collide_fields (three
// divisions by rho, one square root), the accelerated-plane force on planes
// with (z + plane_offset) mod global_nz == accel_plane, and |u| zeroed on
// obstacles. They return the state after K steps and, per step, Sum|u| over
// free cells inside planes [valid_lo, valid_hi) x rows [row_lo, row_hi).
//
// What bounds it on this card: memory. A step reads 19 values and a mask
// byte per cell and writes 19 values, 153 bytes at f32, against ~200
// floating-point operations: at 3.35 TB/s and 67 TFLOP/s (f32) the bytes
// take 15x as long as the operations.
//
// Design. The TPU kernels hold whole (ny, nx) planes of a z-slab in VMEM,
// run K steps there and so divide the traffic by K. One f32 plane of
// 128x256 x 19 speeds is 2.4 MB against 227 KB of shared memory per block,
// and a tile small enough to fit with a K-cell halo on six sides is mostly
// halo: 4x4x16 at K=2 loads 5 cells for every cell it keeps. So a step here
// needs no shared memory at all:
//   * one thread per cell, blocks of bx*by*bz threads with x fastest; a
//     thread pulls its 19 values straight from global memory (every value
//     has exactly one reader, so nothing is re-read), collides in registers
//     and stores 19 values. A pass of K steps is K launches; the state
//     crosses device memory once per step;
//   * each block writes its partial Sum|u| to partials[step, block]; a last
//     small kernel sums them in a fixed order. No float atomics, so reruns
//     are bit-identical and chunked runs equal uninterrupted ones;
//   * B6 alternates between two lattices (out and scratch), ending in out;
//   * B4 (in place) cannot let a block overwrite cells a neighbour has yet
//     to pull, and blocks run in no order. The TPU's answer (slabs in order,
//     delayed write-back, a snapshot of planes [0, K)) has no counterpart
//     here, and a snapshot of every block's shell would be most of the
//     lattice. B4 instead alternates two kinds of step that each read and
//     write the SAME 19 slots per cell (the AA pattern), so no thread
//     touches another's slots:
//       step A  pulls s[q] from slot (x - e_q, q) as B6 does and writes the
//               collided value of the opposite speed back to that slot:
//               f[q][x - e_q] = out[opp(q)];
//       step B  finds what B6 would pull in its own cell, s[q] = f[opp(q)][x],
//               and writes f[q][x] = out[q]: the natural layout again.
//     After an odd number of steps a swap kernel exchanges slot (x, q) with
//     slot (x + e_q, opp(q)) for each of the nine pairs, which restores the
//     natural layout in place. So an even K costs the traffic of K steps and
//     an odd K one more read and write of the lattice;
//   * all three kinds of step share the block shape, the collision code and
//     the reduction order, so B4 is bit-identical to B6 on state and Sum|u|.
// The library is compiled with -fmad=false: every product, sum, division and
// the square root rounds on its own, as in collide_fields.
//
// Interface: plain C, one entry per (kernel, dtype), each launching on the
// given stream and returning cudaGetLastError() after every launch. The
// kernels allocate nothing; the caller passes every buffer. The collision
// coefficients come from the caller as doubles, computed as collide_fields
// computes them, and are rounded to the working type here.

#include "d3q19_collide.cuh"

namespace {

// The three kinds of step (see the note at the top).
constexpr int kTwoStream = 0;  // B6: pull from src, natural store to dst
constexpr int kPullSwap = 1;   // B4 step A: pull, store swapped to the pulled slots
constexpr int kLocal = 2;      // B4 step B: swapped local load, natural store

// Offsets of the cell's neighbours along each axis, index 0, 1, 2 for
// coordinate - 1, itself, + 1 (periodic).
struct Neighbours {
  size_t zo[3], yo[3], xo[3];
};

__device__ __forceinline__ Neighbours neighbours(const Grid& g, int z, int y,
                                                 int x) {
  const size_t plane = (size_t)g.ny * g.nx;
  Neighbours n;
  n.zo[0] = (size_t)(z == 0 ? g.nz - 1 : z - 1) * plane;
  n.zo[1] = (size_t)z * plane;
  n.zo[2] = (size_t)(z == g.nz - 1 ? 0 : z + 1) * plane;
  n.yo[0] = (size_t)(y == 0 ? g.ny - 1 : y - 1) * g.nx;
  n.yo[1] = (size_t)y * g.nx;
  n.yo[2] = (size_t)(y == g.ny - 1 ? 0 : y + 1) * g.nx;
  n.xo[0] = (size_t)(x == 0 ? g.nx - 1 : x - 1);
  n.xo[1] = (size_t)x;
  n.xo[2] = (size_t)(x == g.nx - 1 ? 0 : x + 1);
  return n;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
step_kernel(const T* src, T* dst, const uint8_t* __restrict__ mask,
            T* __restrict__ partials, Grid g, Window win, Coef<T> p) {
  __shared__ T red[kMaxWarps];
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y * blockDim.z) >> 5;

  T u = T(0);
  if (x < g.nx && y < g.ny && z < g.nz) {
    const size_t vol = (size_t)g.nz * g.ny * g.nx;
    const Neighbours n = neighbours(g, z, y, x);
    const size_t c = n.zo[1] + n.yo[1] + n.xo[1];
    T s[kQ], o[kQ];
    if (kMode == kLocal) {
#define LOAD(q, dz, dy, dx, opp) s[q] = src[(size_t)(opp) * vol + c];
      D3Q19_SPEEDS(LOAD)
#undef LOAD
    } else {
      // pull: speed q comes from the cell at x - e_q
#define LOAD(q, dz, dy, dx, opp) \
  s[q] = src[(size_t)(q) * vol + n.zo[1 - (dz)] + n.yo[1 - (dy)] + n.xo[1 - (dx)]];
      D3Q19_SPEEDS(LOAD)
#undef LOAD
    }
    const bool accel = wrap(z + win.plane_offset, win.global_nz) == win.accel_plane;
    u = collide_cell<T>(s, mask[c] != 0, accel, p, o);
    if (kMode == kPullSwap) {
#define STORE(q, dz, dy, dx, opp) \
  dst[(size_t)(q) * vol + n.zo[1 - (dz)] + n.yo[1 - (dy)] + n.xo[1 - (dx)]] = o[opp];
      D3Q19_SPEEDS(STORE)
#undef STORE
    } else {
#define STORE(q, dz, dy, dx, opp) dst[(size_t)(q) * vol + c] = o[q];
      D3Q19_SPEEDS(STORE)
#undef STORE
    }
    if (z < win.valid_lo || z >= win.valid_hi || y < win.row_lo || y >= win.row_hi)
      u = T(0);
  }
  const T tot = block_sum<T>(u, red, tid, nwarps);
  if (tid == 0) {
    const size_t bid = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partials[bid] = tot;
  }
}

// After step A the value of natural slot (x, q) lies in slot (x + e_q,
// opp(q)) and the other way round: exchange the two, for each of the nine
// pairs q < opp(q). Every slot belongs to exactly one exchange.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
swap_kernel(T* f, Grid g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  if (x >= g.nx || y >= g.ny || z >= g.nz) return;
  const size_t vol = (size_t)g.nz * g.ny * g.nx;
  const Neighbours n = neighbours(g, z, y, x);
  const size_t c = n.zo[1] + n.yo[1] + n.xo[1];
#define SWAP(q, dz, dy, dx, opp)                                              \
  if ((q) < (opp)) {                                                          \
    T* a = f + (size_t)(q) * vol + c;                                         \
    T* b = f + (size_t)(opp) * vol + n.zo[1 + (dz)] + n.yo[1 + (dy)] + n.xo[1 + (dx)]; \
    const T va = *a, vb = *b;                                                 \
    *a = vb;                                                                  \
    *b = va;                                                                  \
  }
  D3Q19_SPEEDS(SWAP)
#undef SWAP
}

struct Launch {
  dim3 grid, block;
  int nblocks;
};

bool make_launch(const Grid& g, int bx, int by, int bz, Launch* l) {
  const long threads = (long)bx * by * bz;
  if (bx < 1 || by < 1 || bz < 1 || threads > kMaxThreads || threads % 32) return false;
  l->block = dim3(bx, by, bz);
  l->grid = dim3((g.nx + bx - 1) / bx, (g.ny + by - 1) / by, (g.nz + bz - 1) / bz);
  if (l->grid.y > 65535 || l->grid.z > 65535) return false;
  l->nblocks = (int)(l->grid.x * l->grid.y * l->grid.z);
  return true;
}

// B6: K steps from f, alternating between out and scratch so that the last
// step lands in out.
template <typename T>
int launch_two_stream(const void* f, const void* mask, void* out, void* scratch,
                      void* partials, void* tot, Grid g, int bx, int by, int bz,
                      int k, Window win, Coef<T> p, cudaStream_t stream) {
  Launch l;
  if (!make_launch(g, bx, by, bz, &l) || k < 1) return (int)cudaErrorInvalidValue;
  if (k > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(f);
  for (int j = 1; j <= k; ++j) {
    T* dst = static_cast<T*>((k - j) % 2 == 0 ? out : scratch);
    step_kernel<T, kTwoStream><<<l.grid, l.block, 0, stream>>>(
        src, dst, static_cast<const uint8_t*>(mask),
        static_cast<T*>(partials) + (size_t)(j - 1) * l.nblocks, g, win, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return sum_partials<T>(static_cast<const T*>(partials), l.nblocks, k,
                         static_cast<T*>(tot), stream);
}

// B4: K steps of f in place: A, B, A, B, ... and the swap after an odd K.
template <typename T>
int launch_inplace(void* f, const void* mask, void* partials, void* tot, Grid g,
                   int bx, int by, int bz, int k, Window win, Coef<T> p,
                   cudaStream_t stream) {
  Launch l;
  if (!make_launch(g, bx, by, bz, &l) || k < 1) return (int)cudaErrorInvalidValue;
  T* lattice = static_cast<T*>(f);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  for (int j = 1; j <= k; ++j) {
    T* part = static_cast<T*>(partials) + (size_t)(j - 1) * l.nblocks;
    if (j % 2)
      step_kernel<T, kPullSwap><<<l.grid, l.block, 0, stream>>>(lattice, lattice, m, part,
                                                              g, win, p);
    else
      step_kernel<T, kLocal><<<l.grid, l.block, 0, stream>>>(lattice, lattice, m, part, g,
                                                           win, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (k % 2) {
    swap_kernel<T><<<l.grid, l.block, 0, stream>>>(lattice, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return sum_partials<T>(static_cast<const T*>(partials), l.nblocks, k,
                         static_cast<T*>(tot), stream);
}

}  // namespace

#define LBM3_ARGS                                                              \
  int nz, int ny, int nx, int bx, int by, int bz, int k, int plane_offset,     \
      int valid_lo, int valid_hi, int global_nz, int row_lo, int row_hi,       \
      int accel_plane, double omo, double wo0, double wo1, double wo2,         \
      double fw1, double fw2, void *stream
#define LBM3_PASS(T)                                                           \
  Grid{nz, ny, nx}, bx, by, bz, k,                                             \
      Window{plane_offset, valid_lo, valid_hi, global_nz, row_lo, row_hi,      \
             accel_plane},                                                     \
      make_coef<T>(omo, wo0, wo1, wo2, fw1, fw2),                              \
      static_cast<cudaStream_t>(stream)

extern "C" {

// B6: out = K steps of f. Step j writes out when K - j is even and scratch (a
// second lattice, null for K = 1) otherwise; out and scratch are distinct.
// Only the first step reads f, so for an even K out may be f's own storage,
// and for an odd K > 1 scratch may be. tot[K] is the per-step Sum|u|;
// partials holds K * (number of blocks) values of scratch.
int d3q19_kstep_f32(const void* f, const void* mask, void* out, void* scratch,
                    void* partials, void* tot, LBM3_ARGS) {
  return launch_two_stream<float>(f, mask, out, scratch, partials, tot, LBM3_PASS(float));
}
int d3q19_kstep_f64(const void* f, const void* mask, void* out, void* scratch,
                    void* partials, void* tot, LBM3_ARGS) {
  return launch_two_stream<double>(f, mask, out, scratch, partials, tot, LBM3_PASS(double));
}

// B4: f = K steps of f, in place, with no other lattice.
int d3q19_kstep_inplace_f32(void* f, const void* mask, void* partials, void* tot,
                            LBM3_ARGS) {
  return launch_inplace<float>(f, mask, partials, tot, LBM3_PASS(float));
}
int d3q19_kstep_inplace_f64(void* f, const void* mask, void* partials, void* tot,
                            LBM3_ARGS) {
  return launch_inplace<double>(f, mask, partials, tot, LBM3_PASS(double));
}

}  // extern "C"

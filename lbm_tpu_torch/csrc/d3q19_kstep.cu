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
// take 15x as long as the operations. One step through device memory
// already runs at ~94% of copy_'s rate, so the only gain left is to cross
// device memory fewer times than once a step.
//
// The TPU kernels hold a z-slab's planes in VMEM, run K steps there and
// cross HBM once a pass. Shared memory is far too small for that (a 128x256
// plane of 19 f32 speeds is 2.5 MB; a tile with a K-cell halo on six sides
// is mostly halo, which B5 and B7 measure), but the 50 MB L2 holds several
// whole planes. So a pass is a z-wavefront through L2 (`wave_kernel`, the
// "wave" path):
//   * one persistent launch a pass, sized to the blocks the card keeps
//     resident. A work item is (stage j of the pass, plane z, a chunk of
//     that plane's step-path blocks). Stage j sweeps the planes from plane
//     j - 1 (0-based: stage s from plane s), so that an item of stage j
//     needs stage j - 1 only at planes z - 1, z and z + 1, which that stage
//     reached at its positions i, i + 1 and i + 2: the periodic wrap in z
//     needs no deferred tail;
//   * blocks take items from one atomic ticket. The tickets run in rounds:
//     round r holds stage s at position r - s * lag, stages in order, so
//     each stage trails the one before by `lag` planes. Every wait is on an
//     item of a smaller ticket, which a running block already holds, so the
//     launch cannot deadlock whatever the number of resident blocks and
//     needs no cooperative launch. A block takes its next ticket as it
//     starts an item, which keeps that true;
//   * an item that finishes adds one to the counter of its (stage, plane)
//     (a fence, then the add: a release); a waiting block polls the three
//     counters together until each reaches the chunks of a plane, then
//     fences (the acquire). A poll that runs absurdly long traps, so that a
//     fault fails the launch instead of hanging the card. The counters, the
//     ticket and an exit word start each launch at zero, and the launch
//     leaves them so: each block adds one to the exit word as it leaves,
//     after its last access to the others, and the last block to leave
//     resets them all. So nothing is reset between passes, and a launch
//     captured in a CUDA graph may be replayed;
//   * what stage j reads was written by stage j - 1 a few planes earlier and
//     is still in L2, so device memory sees the pass's input read once and
//     its output written once. A line the front spills costs one more trip,
//     which is what every step costs on the step path. What bounds a pass
//     then is L2: measured on an H100 (experiments/cuda-kstep-tiles/
//     breakdown3d.py, PERF.md section 5), a wave pass in copy mode, its
//     loads and stores alone, takes ~0.085 ms a stage at 64x128x256 f32,
//     about 3.7 TB/s of L2 traffic and hardly less than a trip through
//     device memory (0.096 ms at 3.35 TB/s), and the loads and stores are
//     87-91% of a full pass. So a K-step pass costs about K sweeps of L2:
//     13-18% less than K trips at K = 2..4, not the one trip of the TPU. Lattice values move
//     through L2 only (.cg: never a stale L1 line), with L2 eviction
//     policies: evict-first for what the pass reads from in and writes
//     last, evict-last for what a later stage reads again;
//   * both kernels step in the AA pattern of the step path's B4 (below),
//     so that a stage reads and writes the same slots and no other lattice
//     is needed: stage A at cell x owns the slots (x - e_q, q), stage B the
//     slots (x, q), and a swap the pairs of slots it exchanges. Each slot
//     has one owner a stage, and its owners in two consecutive stages lie at
//     most one plane apart, so the wait on planes z - 1 .. z + 1 orders
//     every read and write of a slot. B4 runs A, B, A, ... in place and,
//     after an odd K, the swap as the pass's last stage, so an odd K is one
//     launch too. B6 reads its first stage from in and writes out: an even
//     K runs A, B, ..., whose first A pulls from in into out's slots; an odd
//     K first takes a two-stream step from in into out's natural layout,
//     then A, B, ... in out, and needs no swap. So B6 holds out and nothing
//     more, and for an even K out may be in's own storage (then it is B4);
//   * the diagnostic modes of B6 take the same stages with the pull along
//     e_q (full, stream_only), along z only (collide_no_roll) or not at all
//     (copy), and the collision or none;
//   * each step-path block of an item sums its |u| in the step path's order
//     and writes it to partials[step, block id of the step path], and
//     sum_partials adds them as after the step path: the state and Sum|u|
//     of the two paths are equal bit for bit, and so are B4's and B6's.
// The "step" path, kept for the shapes the wave path does not take (a block
// more than one plane deep, fewer than three planes) and for the K where it
// measured faster: one launch of `step_kernel` per step, one thread per cell, blocks
// of bx*by*bz threads with x fastest, a thread pulling its 19 values
// straight from device memory and storing 19; B6 alternates between two
// lattices (out and scratch); B4 alternates two kinds of step that each read
// and write the SAME 19 slots per cell (the AA pattern):
//   step A  pulls s[q] from slot (x - e_q, q) as B6 does and writes the
//           collided value of the opposite speed back to that slot:
//           f[q][x - e_q] = out[opp(q)];
//   step B  finds what B6 would pull in its own cell, s[q] = f[opp(q)][x],
//           and writes f[q][x] = out[q]: the natural layout again.
// After an odd number of steps a swap exchanges slot (x, q) with slot
// (x + e_q, opp(q)) for each of the nine pairs, which restores the natural
// layout in place. B6's diagnostic modes (stream_only, copy,
// collide_no_roll of the TPU kernel) run on the wave path only.
// Every kind of step shares the collision code (step_cell) and the
// reduction order; the library is compiled with -fmad=false: every product,
// sum, division and the square root rounds on its own, as in
// collide_fields.
//
// bfloat16 lattices (B4, B6) round once a pass as the TPU kernels do (they
// step in float32 and cast at the store). The AA pattern would keep a pass's
// middle steps in the lattice's own slots and round every step, so a pass
// of K > 1 steps its first step from the bfloat16 lattice into a float
// scratch lattice (19 x 4 bytes a cell, the caller's), its middle steps
// there in the AA pattern, and its last back into a bfloat16 lattice: a
// two-stream step where the scratch is in its natural layout (an even K),
// else a step B. On the step path that is K launches (launch_rounded); a
// step moves 77 bytes a cell in bfloat16 (19 x 2 in, 19 x 2 out, the mask),
// 115 from or to the scratch and 153 within it. B4 takes the same stages
// on the wave path as one launch (wave_kernel<__nv_bfloat16, float>, the
// "rounded" plan): stage 0 reads the bfloat16 lattice and stores to the
// scratch, the last stage reads the scratch and stores to the lattice in
// place. That is safe because the last stage at plane z waits, through K - 1
// chained waits, on stage 0 at planes z - 1 .. z + 1, the only items that
// read the lattice's plane z; the wrapped planes too. So the pass reads
// and writes the bfloat16 lattice once, and its scratch traffic stays in
// L2 where the front keeps it: at 64x128x256, K = 4, 0.362 ms a pass
// against the step path's 0.425 on an H100, but at K = 2 no faster
// (PATH_MS). B6's bfloat16 pass (out != in) stays on the step path. K = 1
// runs in the lattice itself, on the step path.
//
// Layouts (B6): the lattice is (19, nz, ny, nx), speed-major ("q-major"), or
// (nz, 19, ny, nx), plane-major ("z-major", the JAX package's layout='zmajor'):
// the same lattice with other strides. Every access goes through a speed
// stride and the offsets of planes z - 1, z, z + 1 (`Planes`), so a z-major
// pass takes the speed stride ny*nx and the plane stride 19*ny*nx where a
// q-major one takes nz*ny*nx and ny*nx, for the lattice and for a bfloat16
// pass's float scratch alike; the (nz, ny, nx) mask keeps its plane stride
// ny*nx. The arithmetic and both reductions are the same, so a z-major pass
// is bit-equal to a q-major one. The layout is a template switch (kZ) of the
// kernels B6 launches, not a runtime stride: with runtime strides
// wave_kernel<float, full> spilled and B4 and B6 ran ~1% slower in q-major
// (PERF.md section 6). B4 runs q-major only.
//
// Interface: plain C, one entry per (kernel, path, dtype), each launching on
// the given stream and returning cudaGetLastError() after every launch. The
// kernels allocate nothing; the caller passes every buffer. The collision
// coefficients come from the caller as doubles, computed as collide_fields
// computes them, and are rounded to the working type here.

#include <type_traits>

#include "d3q19_collide.cuh"

namespace {

// The kinds of step (see the note at the top).
constexpr int kTwoStream = 0;  // pull from src, natural store to dst
constexpr int kPullSwap = 1;   // step A: pull, store swapped to the pulled slots
constexpr int kLocal = 2;      // step B: swapped local load, natural store
constexpr int kSwap = 3;       // B4's swap after an odd K (a wave stage)
// B6's modes in the order of ops/d3q19_kstep.py MODES; B4 and the step path
// take kFull
constexpr int kFull = 0;        // pull along e_q, collide
constexpr int kStreamOnly = 1;  // pull along e_q, no collision, u = the rest speed
constexpr int kCopy = 2;        // no pull, no collision, u = 0
constexpr int kNoRoll = 3;      // pull along z only, collide

constexpr int kMaxStages = 4;  // K <= 4 steps, or an odd K <= 3 and its swap
// polls of one counter before the launch traps: seconds, where an item waits
// for items that take microseconds
constexpr int kMaxPolls = 1 << 24;

// Offsets of the cell's neighbours along each axis, index 0, 1, 2 for
// coordinate - 1, itself, + 1 (periodic), in a lattice's natural layout:
// zo in units of the lattice's plane stride, yo and xo within a plane.
struct Neighbours {
  size_t zo[3], yo[3], xo[3];
};

// A lattice's speed stride and plane stride, q-major or (kZ) z-major.
template <bool kZ>
__device__ __forceinline__ size_t speed_stride(const Grid& g) {
  return kZ ? (size_t)g.ny * g.nx : (size_t)g.nz * g.ny * g.nx;
}
template <bool kZ>
__device__ __forceinline__ size_t plane_stride(const Grid& g) {
  return (kZ ? (size_t)kQ : (size_t)1) * g.ny * g.nx;
}

__device__ __forceinline__ void row_neighbours(const Grid& g, int y, int x, size_t yo[3],
                                               size_t xo[3]) {
  yo[0] = (size_t)(y == 0 ? g.ny - 1 : y - 1) * g.nx;
  yo[1] = (size_t)y * g.nx;
  yo[2] = (size_t)(y == g.ny - 1 ? 0 : y + 1) * g.nx;
  xo[0] = (size_t)(x == 0 ? g.nx - 1 : x - 1);
  xo[1] = (size_t)x;
  xo[2] = (size_t)(x == g.nx - 1 ? 0 : x + 1);
}

template <bool kZ>
__device__ __forceinline__ Neighbours neighbours(const Grid& g, int z, int y, int x) {
  const size_t plane = plane_stride<kZ>(g);
  Neighbours n;
  n.zo[0] = (size_t)(z == 0 ? g.nz - 1 : z - 1) * plane;
  n.zo[1] = (size_t)z * plane;
  n.zo[2] = (size_t)(z == g.nz - 1 ? 0 : z + 1) * plane;
  row_neighbours(g, y, x, n.yo, n.xo);
  return n;
}

// The wave path moves lattice values through L2 only (.cg: never a stale L1
// line), each access with an L2 eviction policy (createpolicy), and orders
// each with the stores around it (__ldcg's asm carries no memory clobber, so
// the compiler might move it past a store to the same slot).
struct Policy {
  uint64_t ld, st;  // of the loads and of the stores
};

__device__ __forceinline__ uint64_t make_policy(int priority) {
  uint64_t p;
  if (priority == 1)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  else if (priority == 2)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_unchanged.b64 %0, 1.0;" : "=l"(p));
  return p;
}
constexpr int kEvictFirst = 1, kEvictLast = 2, kEvictUnchanged = 3;

__device__ __forceinline__ float ld_l2(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.cg.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(p), "l"(pol) : "memory");
  return v;
}
__device__ __forceinline__ double ld_l2(const double* p, uint64_t pol) {
  double v;
  asm volatile("ld.global.cg.L2::cache_hint.f64 %0, [%1], %2;"
               : "=d"(v) : "l"(p), "l"(pol) : "memory");
  return v;
}
__device__ __forceinline__ void st_l2(float* p, float v, uint64_t pol) {
  asm volatile("st.global.cg.L2::cache_hint.f32 [%0], %1, %2;"
               ::"l"(p), "f"(v), "l"(pol) : "memory");
}
__device__ __forceinline__ void st_l2(double* p, double v, uint64_t pol) {
  asm volatile("st.global.cg.L2::cache_hint.f64 [%0], %1, %2;"
               ::"l"(p), "d"(v), "l"(pol) : "memory");
}
__device__ __forceinline__ __nv_bfloat16 ld_l2(const __nv_bfloat16* p, uint64_t pol) {
  unsigned short v;
  asm volatile("ld.global.cg.L2::cache_hint.b16 %0, [%1], %2;"
               : "=h"(v) : "l"(p), "l"(pol) : "memory");
  return __ushort_as_bfloat16(v);
}
__device__ __forceinline__ void st_l2(__nv_bfloat16* p, __nv_bfloat16 v, uint64_t pol) {
  asm volatile("st.global.cg.L2::cache_hint.b16 [%0], %1, %2;"
               ::"l"(p), "h"(__bfloat16_as_ushort(v)), "l"(pol) : "memory");
}

template <typename T, bool kL2>
__device__ __forceinline__ T ld(const T* p, const Policy& pol) {
  if constexpr (kL2) return ld_l2(p, pol.ld);
  return *p;
}
template <typename T, bool kL2>
__device__ __forceinline__ void st(T* p, T v, const Policy& pol) {
  if constexpr (kL2)
    st_l2(p, v, pol.st);
  else
    *p = v;
}

// Where a step reads or writes: speed 0 of a buffer, its speed stride and
// the offsets of planes z - 1, z and z + 1 in it.
template <typename T>
struct Planes {
  T* base;
  size_t qs;
  size_t zo[3];
};

// One cell of one step of kind kKind (kTwoStream, kPullSwap or kLocal) in
// mode kMode; yo, xo its neighbours along y and x. The pull moves speed q by
// the mode's displacement: e_q, its z part (kNoRoll) or none (kCopy).
// Returns |u| (the rest speed in stream_only, 0 in copy). Src and Dst are
// the types of the two lattices; the step runs in T, the compute type of
// both (a bfloat16 pass reads or writes a float lattice between its first
// and its last step).
template <typename Src, typename Dst, int kKind, int kMode, bool kL2,
          typename T = typename storage::Compute<Src>::type>
__device__ __forceinline__ T step_cell(const Planes<const Src>& src, const Planes<Dst>& dst,
                                       const size_t yo[3], const size_t xo[3], bool obstacle,
                                       bool accel, const Coef<T>& p, const Policy& pol) {
  constexpr bool kPull = kMode != kCopy, kPlane = kMode == kFull || kMode == kStreamOnly;
  const size_t c = yo[1] + xo[1];
  T s[kQ], o[kQ];
  if (kKind == kLocal) {
#define LOAD(q, dz, dy, dx, opp) \
  s[q] = storage::load(ld<Src, kL2>(src.base + (size_t)(opp) * src.qs + src.zo[1] + c, pol));
    D3Q19_SPEEDS(LOAD)
#undef LOAD
  } else {
    // pull: speed q comes from the cell at x - e_q (in the mode's displacement)
#define LOAD(q, dz, dy, dx, opp)                                                        \
  s[q] = storage::load(ld<Src, kL2>(src.base + (size_t)(q) * src.qs +                     \
                                    src.zo[1 - kPull * (dz)] + yo[1 - kPlane * (dy)] +     \
                                    xo[1 - kPlane * (dx)], pol));
    D3Q19_SPEEDS(LOAD)
#undef LOAD
  }
  T u;
  if (kMode == kCopy || kMode == kStreamOnly) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) o[q] = s[q];
    u = kMode == kCopy ? T(0) : s[0];
  } else {
    u = collide_cell<T>(s, obstacle, accel, p, o);
  }
  Dst r[kQ];  // rounded to the storage type of dst
#pragma unroll
  for (int q = 0; q < kQ; ++q) storage::put(r[q], o[q]);
  if (kKind == kPullSwap) {
#define STORE(q, dz, dy, dx, opp)                                                      \
  st<Dst, kL2>(dst.base + (size_t)(q) * dst.qs + dst.zo[1 - kPull * (dz)] +             \
                   yo[1 - kPlane * (dy)] + xo[1 - kPlane * (dx)], r[opp], pol);
    D3Q19_SPEEDS(STORE)
#undef STORE
  } else {
#define STORE(q, dz, dy, dx, opp) \
  st<Dst, kL2>(dst.base + (size_t)(q) * dst.qs + dst.zo[1] + c, r[q], pol);
    D3Q19_SPEEDS(STORE)
#undef STORE
  }
  return u;
}

// After step A the value of natural slot (x, q) lies in slot (x + e_q,
// opp(q)) and the other way round: exchange the two, for each of the nine
// pairs q < opp(q). Every slot belongs to exactly one exchange.
template <typename T, bool kCg>
__device__ __forceinline__ void swap_cell(const Planes<T>& f, const size_t yo[3],
                                          const size_t xo[3], const Policy& pol) {
  const size_t c = yo[1] + xo[1];
#define SWAP(q, dz, dy, dx, opp)                                                  \
  if ((q) < (opp)) {                                                              \
    T* a = f.base + (size_t)(q) * f.qs + f.zo[1] + c;                             \
    T* b = f.base + (size_t)(opp) * f.qs + f.zo[1 + (dz)] + yo[1 + (dy)] + xo[1 + (dx)]; \
    const T va = ld<T, kCg>(a, pol), vb = ld<T, kCg>(b, pol);                     \
    st<T, kCg>(a, vb, pol);                                                       \
    st<T, kCg>(b, va, pol);                                                       \
  }
  D3Q19_SPEEDS(SWAP)
#undef SWAP
}

// ---------------------------------------------------------------- step path

// One step of kind kKind from src (of type Src) to dst (Dst), in the compute
// type T of both; kZ: z-major lattices.
template <typename Src, typename Dst, int kKind, bool kZ,
          typename T = typename storage::Compute<Src>::type>
__global__ void __launch_bounds__(kMaxThreads)
step_kernel(const Src* src, Dst* dst, const uint8_t* __restrict__ mask,
            T* __restrict__ partials, Grid g, Window win, Coef<T> p) {
  __shared__ T red[kMaxWarps];
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y * blockDim.z) >> 5;

  T u = T(0);
  if (x < g.nx && y < g.ny && z < g.nz) {
    const size_t vol = speed_stride<kZ>(g);
    const Neighbours n = neighbours<kZ>(g, z, y, x);
    const Planes<const Src> from{src, vol, {n.zo[0], n.zo[1], n.zo[2]}};
    const Planes<Dst> to{dst, vol, {n.zo[0], n.zo[1], n.zo[2]}};
    const bool accel = wrap(z + win.plane_offset, win.global_nz) == win.accel_plane;
    // the mask's plane offset: the lattice's in q-major
    const size_t mz = kZ ? (size_t)z * g.ny * g.nx : n.zo[1];
    u = step_cell<Src, Dst, kKind, kFull, false>(from, to, n.yo, n.xo,
                                          mask[mz + n.yo[1] + n.xo[1]] != 0, accel, p,
                                          Policy{});
    if (z < win.valid_lo || z >= win.valid_hi || y < win.row_lo || y >= win.row_hi)
      u = T(0);
  }
  const T tot = block_sum<T>(u, red, tid, nwarps);
  if (tid == 0) {
    const size_t bid = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partials[bid] = tot;
  }
}

// B4's swap after an odd K (q-major: B4 takes no other layout).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
swap_kernel(T* f, Grid g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  if (x >= g.nx || y >= g.ny || z >= g.nz) return;
  const Neighbours n = neighbours<false>(g, z, y, x);
  const Planes<T> lattice{f, speed_stride<false>(g), {n.zo[0], n.zo[1], n.zo[2]}};
  swap_cell<T, false>(lattice, n.yo, n.xo, Policy{});
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
// step lands in out; kZ: z-major lattices.
template <typename T, bool kZ>
int launch_two_stream(const void* f, const void* mask, void* out, void* scratch,
                      void* partials, void* tot, Grid g, int bx, int by, int bz,
                      int k, Window win, Coef<T> p, cudaStream_t stream) {
  Launch l;
  if (!make_launch(g, bx, by, bz, &l) || k < 1) return (int)cudaErrorInvalidValue;
  if (k > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(f);
  for (int j = 1; j <= k; ++j) {
    T* dst = static_cast<T*>((k - j) % 2 == 0 ? out : scratch);
    step_kernel<T, T, kTwoStream, kZ><<<l.grid, l.block, 0, stream>>>(
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
      step_kernel<T, T, kPullSwap, false><<<l.grid, l.block, 0, stream>>>(
          lattice, lattice, m, part, g, win, p);
    else
      step_kernel<T, T, kLocal, false><<<l.grid, l.block, 0, stream>>>(lattice, lattice, m,
                                                                     part, g, win, p);
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

// A bfloat16 lattice on the step path, rounded once a pass (B6: out = K
// steps of f; B4: out is f). K = 1 runs in the lattice itself: B6 one
// two-stream step, B4 step A and the swap, which only moves the values it
// rounded. K > 1 steps through `scratch`, a float lattice: the first step
// two-stream from f into scratch, the middle ones A, B, ... in scratch in
// place, the last from scratch into out, two-stream where scratch is in its
// natural layout (after a B, or no middle step), else a local step B. kZ:
// z-major lattices, scratch too (B6 only).
template <bool kZ>
int launch_rounded(const void* f, const void* mask, void* out, void* scratch,
                   void* partials, void* tot, Grid g, int bx, int by, int bz, int k,
                   Window win, Coef<float> p, bool inplace, cudaStream_t stream) {
  using S = __nv_bfloat16;
  Launch l;
  if (!make_launch(g, bx, by, bz, &l) || k < 1) return (int)cudaErrorInvalidValue;
  if (k > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const S* in = static_cast<const S*>(f);
  S* res = static_cast<S*>(out);
  float* mid = static_cast<float*>(scratch);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* part = static_cast<float*>(partials);
  cudaError_t err;
  if (k == 1) {
    if (inplace) {
      if constexpr (kZ) {
        return (int)cudaErrorInvalidValue;  // B4 runs q-major only
      } else {
        step_kernel<S, S, kPullSwap, false><<<l.grid, l.block, 0, stream>>>(res, res, m, part, g,
                                                                          win, p);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        swap_kernel<S><<<l.grid, l.block, 0, stream>>>(res, g);
      }
    } else {
      step_kernel<S, S, kTwoStream, kZ><<<l.grid, l.block, 0, stream>>>(in, res, m, part, g, win,
                                                                      p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return sum_partials<float>(part, l.nblocks, k, static_cast<float*>(tot), stream);
  }
  step_kernel<S, float, kTwoStream, kZ><<<l.grid, l.block, 0, stream>>>(in, mid, m, part, g, win,
                                                                        p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int j = 2; j < k; ++j) {
    float* pj = part + (size_t)(j - 1) * l.nblocks;
    if (j % 2 == 0)
      step_kernel<float, float, kPullSwap, kZ><<<l.grid, l.block, 0, stream>>>(mid, mid, m, pj,
                                                                               g, win, p);
    else
      step_kernel<float, float, kLocal, kZ><<<l.grid, l.block, 0, stream>>>(mid, mid, m, pj, g,
                                                                            win, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  float* pk = part + (size_t)(k - 1) * l.nblocks;
  if (k % 2 == 0)  // an even number of middle steps: scratch in its natural layout
    step_kernel<float, S, kTwoStream, kZ><<<l.grid, l.block, 0, stream>>>(mid, res, m, pk, g,
                                                                        win, p);
  else
    step_kernel<float, S, kLocal, kZ><<<l.grid, l.block, 0, stream>>>(mid, res, m, pk, g, win,
                                                                    p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials<float>(part, l.nblocks, k, static_cast<float*>(tot), stream);
}

// ---------------------------------------------------------------- wave path

// The plan of a wave launch (mirrors WavePlan in ops/d3q19_kstep.py).
struct WavePlan {
  int bx, by, gx, gy;  // the step path's block (one plane deep) and blocks along x, y
  int chunk, chunks;   // step-path blocks an item, items a (stage, plane)
  int stages, k;       // stages of the pass (K, or K + 1 with B4's swap), steps
  int two_stream;      // B6 after an odd K, and a rounded pass: stage 0 is a two-stream step
  int swap;            // B4 after an odd K: the last stage is the swap
  int lag;             // planes a stage trails the one before
  int items;           // stages * nz * chunks
};

// The kind of step of stage s: a two-stream step first for B6 after an odd
// K, the swap last for B4 after an odd K, A and B in turn between. A
// rounded pass (kRounded: a bfloat16 lattice through a float scratch) takes
// a two-stream step first and, last, a two-stream step after an even K or
// a step B after an odd one, as launch_rounded does.
template <bool kRounded>
__device__ __forceinline__ int stage_kind(const WavePlan& a, int s) {
  if (kRounded && s == a.stages - 1) return a.k % 2 ? kLocal : kTwoStream;
  if (a.swap && s == a.stages - 1) return kSwap;
  if (a.two_stream && s == 0) return kTwoStream;
  return (s - a.two_stream) % 2 == 0 ? kPullSwap : kLocal;
}

// wave_kernel's minimum resident blocks an SM of 256 threads: registers for
// 19 values in and 19 out, each a double in float64
template <typename T>
struct WaveOccupancy {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;
};

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Wait until the three counters reach target: the polls of the three are in
// flight together, and the caller's fence after them is the acquire.
__device__ __forceinline__ void wait_counts(const unsigned* c0, const unsigned* c1,
                                            const unsigned* c2, unsigned target) {
  int polls = 0;
  for (;;) {
    const unsigned v0 = ld_relaxed(c0), v1 = ld_relaxed(c1), v2 = ld_relaxed(c2);
    if (v0 >= target && v1 >= target && v2 >= target) break;
    if (++polls > kMaxPolls) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ int clamp_planes(int v, int nz) { return v < 0 ? 0 : (v > nz ? nz : v); }

// Tickets of the rounds before round r: stage s has position r' - s * lag in
// round r', so it has clamp(r - s * lag, 0, nz) positions before round r.
__device__ __forceinline__ int tickets_before(const WavePlan& a, int nz, int r) {
  int n = 0;
  for (int s = 0; s < a.stages; ++s) n += clamp_planes(r - s * a.lag, nz);
  return n * a.chunks;
}

// (stage, position, chunk) of ticket t < items. A block's tickets grow, so
// the round is found by walking on from the block's last one (*round).
__device__ void decode(const WavePlan& a, int nz, int t, int* round, int* s, int* i, int* c) {
  int r = *round;
  while (tickets_before(a, nz, r + 1) <= t) ++r;
  *round = r;
  const int off = t - tickets_before(a, nz, r);
  const int first = r >= nz ? (r - nz) / a.lag + 1 : 0;  // the round's first stage
  *s = first + off / a.chunks;
  *c = off % a.chunks;
  *i = r - *s * a.lag;
}

// One step-path block of an item: stage kind `kind`; returns |u| of the cell.
template <typename T, int kMode>
__device__ __forceinline__ T wave_cell(int kind, const Planes<const T>& src, const Planes<T>& dst,
                                       const size_t yo[3], const size_t xo[3], bool obstacle,
                                       bool accel, const Coef<T>& p, const Policy& pol) {
  if (kind == kTwoStream)
    return step_cell<T, T, kTwoStream, kMode, true>(src, dst, yo, xo, obstacle, accel, p, pol);
  if (kind == kPullSwap)
    return step_cell<T, T, kPullSwap, kMode, true>(src, dst, yo, xo, obstacle, accel, p, pol);
  return step_cell<T, T, kLocal, kMode, true>(src, dst, yo, xo, obstacle, accel, p, pol);
}

// One step-path block of an item of a rounded pass, from `from` to `to`
// (speed stride vol, plane offsets zo): stage 0 (first) from the lattice
// (S) into the scratch (T), the last stage from the scratch into the
// lattice, the stages between A or B in the scratch. Two untyped buffers a
// stage, not the three of lattice in, scratch and lattice out: with three
// the instance spilled at the 80 registers of three blocks an SM and ran
// 14% slower (PERF.md section 6).
template <typename S, typename T, int kMode>
__device__ __forceinline__ T rounded_cell(int kind, bool first, bool last, const void* from,
                                          void* to, size_t vol, const size_t zo[3],
                                          const size_t yo[3], const size_t xo[3], bool obstacle,
                                          bool accel, const Coef<T>& p, const Policy& pol) {
  const Planes<const S> lat{static_cast<const S*>(from), vol, {zo[0], zo[1], zo[2]}};
  const Planes<S> res{static_cast<S*>(to), vol, {zo[0], zo[1], zo[2]}};
  const Planes<const T> src{static_cast<const T*>(from), vol, {zo[0], zo[1], zo[2]}};
  const Planes<T> dst{static_cast<T*>(to), vol, {zo[0], zo[1], zo[2]}};
  if (first)
    return step_cell<S, T, kTwoStream, kMode, true>(lat, dst, yo, xo, obstacle, accel, p, pol);
  if (last) {
    if (kind == kTwoStream)
      return step_cell<T, S, kTwoStream, kMode, true>(src, res, yo, xo, obstacle, accel, p, pol);
    return step_cell<T, S, kLocal, kMode, true>(src, res, yo, xo, obstacle, accel, p, pol);
  }
  if (kind == kPullSwap)
    return step_cell<T, T, kPullSwap, kMode, true>(src, dst, yo, xo, obstacle, accel, p, pol);
  return step_cell<T, T, kLocal, kMode, true>(src, dst, yo, xo, obstacle, accel, p, pol);
}

// S: the type of in and out; T: the compute type. A float or double S is
// the pass as the note at the top gives it (scratch unused); a bfloat16 S
// is a rounded pass of B4 (in == out) through the float lattice scratch.
template <typename S, typename T, int kMode, bool kZ>
__global__ void __launch_bounds__(kMaxThreads, WaveOccupancy<T>::kMinBlocks)
wave_kernel(const S* in, S* out, const uint8_t* __restrict__ mask, T* __restrict__ partials,
            unsigned* counters, Grid g, Window win, Coef<T> p, WavePlan a, T* scratch) {
  constexpr bool kRounded = !std::is_same<S, T>::value;
  __shared__ T red[kMaxWarps];
  __shared__ int claim[3];
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  const int nz = g.nz;
  const size_t plane = (size_t)g.ny * g.nx;  // the mask's plane stride
  // the lattice's speed and plane strides (speed_stride, plane_stride)
  const size_t vol = kZ ? plane : (size_t)nz * plane;
  const size_t zs = kZ ? (size_t)kQ * plane : plane;
  const int per_plane = a.gx * a.gy;
  // the words: a counter a (stage, plane), the ticket, the exit word
  unsigned* ticket = counters + kMaxStages * nz;
  unsigned next = 0;
  int round = 0;
  if (tid == 0) next = atomicAdd(ticket, 1u);
  for (;;) {
    if (tid == 0) {
      const unsigned t = next;
      int s = -1, i = 0, c = 0;
      if (t < (unsigned)a.items) {
        next = atomicAdd(ticket, 1u);  // in flight while this item runs
        decode(a, nz, (int)t, &round, &s, &i, &c);
        if (s > 0) {  // the previous stage at planes z - 1, z, z + 1
          const int z = (i + s) % nz;
          const unsigned* prev = counters + (s - 1) * nz;
          wait_counts(prev + (z == 0 ? nz - 1 : z - 1), prev + z, prev + (z == nz - 1 ? 0 : z + 1),
                      (unsigned)a.chunks);
          __threadfence();  // the acquire: what the awaited items wrote is seen below
        }
      }
      claim[0] = s;
      claim[1] = i;
      claim[2] = c;
    }
    __syncthreads();
    const int s = claim[0], i = claim[1], c = claim[2];
    if (s < 0) break;
    const int z = (i + s) % nz;
    const size_t zo[3] = {(z == 0 ? nz - 1 : z - 1) * zs, z * zs, (z == nz - 1 ? 0 : z + 1) * zs};
    // stage 0 reads in, every stage writes out
    const Planes<const S> src{s == 0 ? in : out, vol, {zo[0], zo[1], zo[2]}};
    const Planes<S> dst{out, vol, {zo[0], zo[1], zo[2]}};
    const int kind = stage_kind<kRounded>(a, s);
    const bool accel = wrap(z + win.plane_offset, win.global_nz) == win.accel_plane;
    const bool counted = z >= win.valid_lo && z < win.valid_hi;
    // L2 policies: what the pass reads from in and writes last may leave L2
    // first; what a later stage reads again should stay. A rounded pass
    // reads the lattice first and the scratch last, both dead after that
    const bool last_stage = s == a.stages - 1;
    const Policy pol{make_policy((kRounded ? s == 0 || last_stage : s == 0 && in != out)
                                     ? kEvictFirst : kEvictUnchanged),
                     make_policy(last_stage ? kEvictFirst : kEvictLast)};
    // a rounded pass's stage reads `from` and writes `to`: the lattice in,
    // the scratch between, the lattice out
    const void* from = kRounded && s > 0 ? static_cast<const void*>(scratch) : in;
    void* to = kRounded && !last_stage ? static_cast<void*>(scratch) : out;
    const int b1 = min((c + 1) * a.chunk, per_plane);
    for (int b = c * a.chunk; b < b1; ++b) {
      const int x = (b % a.gx) * a.bx + threadIdx.x;
      const int y = (b / a.gx) * a.by + threadIdx.y;
      T u = T(0);
      if (x < g.nx && y < g.ny) {
        size_t yo[3], xo[3];
        row_neighbours(g, y, x, yo, xo);
        if (!kRounded && kind == kSwap) {
          swap_cell<S, true>(dst, yo, xo, pol);
        } else {
          // the mask's plane offset: the lattice's in q-major
          const size_t mz = kZ ? (size_t)z * plane : zo[1];
          const bool obstacle = mask[mz + yo[1] + xo[1]] != 0;
          if constexpr (kRounded)
            u = rounded_cell<S, T, kMode>(kind, s == 0, last_stage, from, to, vol, zo, yo, xo,
                                          obstacle, accel, p, pol);
          else
            u = wave_cell<T, kMode>(kind, src, dst, yo, xo, obstacle, accel, p, pol);
          if (!counted || y < win.row_lo || y >= win.row_hi) u = T(0);
        }
      }
      if (kind != kSwap) {
        const T tot = block_sum<T>(u, red, tid, nwarps);
        if (tid == 0) partials[(size_t)s * per_plane * nz + (size_t)z * per_plane + b] = tot;
        __syncthreads();  // thread 0 has read red before the next block writes it
      }
    }
    __syncthreads();  // every store of the item issued
    if (tid == 0) {
      __threadfence();
      atomicAdd(counters + s * nz + z, 1u);
    }
  }
  // Leave: the last block out resets the words for the next launch (every
  // other block has fenced its accesses to them before its add here).
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket + 1, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (last)
    for (int w = tid; w < kMaxStages * nz + 2; w += blockDim.x * blockDim.y) counters[w] = 0u;
}

// Checks a wave launch and fills its plan; false where the wave path does
// not take it (ops/d3q19_kstep.py wave_fits and WavePlan hold the same). An
// odd K of B6 reads in after its first stage has written out, so in and out
// must differ then. A rounded pass (B4 on a bfloat16 lattice) takes K > 1
// stages, the first two-stream, and no swap.
bool make_plan(const Grid& g, int bx, int by, int bz, int k, bool inplace, bool aliased,
               bool rounded, int chunk, int lag, WavePlan* a) {
  Launch l;
  if (!make_launch(g, bx, by, bz, &l) || bz != 1 || g.nz < 3 || k < 1 || k > kMaxStages)
    return false;
  if (chunk < 1 || lag < 2 || (!inplace && aliased && k % 2) || (rounded && k < 2)) return false;
  a->bx = bx;
  a->by = by;
  a->gx = (int)l.grid.x;
  a->gy = (int)l.grid.y;
  a->chunk = chunk;
  a->chunks = (a->gx * a->gy + chunk - 1) / chunk;
  a->two_stream = rounded || (!inplace && k % 2);
  a->swap = !rounded && inplace && k % 2;
  a->stages = k + a->swap;
  a->k = k;
  a->lag = lag;
  if (a->stages > kMaxStages) return false;
  const long items = (long)a->stages * g.nz * a->chunks;
  if (items > 0x7fffffffL) return false;
  a->items = (int)items;
  return true;
}

// One pass on the wave path: B6 (out = K steps of in, in `mode`; kZ: on
// z-major lattices) or, with inplace, B4 (in == out, K steps in place). S
// the lattice's type, T the compute type; a bfloat16 S is B4's rounded pass
// (in place, mode full, q-major) through scratch, a float lattice distinct
// from in.
template <typename S, typename T, bool kZ>
int launch_wave(const void* in, const void* mask, void* out, void* scratch, void* partials,
                void* tot, void* counters, int mode, int inplace, int blocks, int chunk, int lag,
                Grid g, int bx, int by, int bz, int k, Window win, Coef<T> p,
                cudaStream_t stream) {
  constexpr bool kRounded = !std::is_same<S, T>::value;
  WavePlan a;
  if (!make_plan(g, bx, by, bz, k, inplace != 0, in == out, kRounded, chunk, lag, &a) ||
      blocks < 1 || mode < kFull || mode > kNoRoll ||
      (inplace && (in != out || mode != kFull || kZ)))
    return (int)cudaErrorInvalidValue;
  if (kRounded && (!inplace || scratch == nullptr || scratch == in))
    return (int)cudaErrorInvalidValue;
  const S* src = static_cast<const S*>(in);
  S* dst = static_cast<S*>(out);
  T* mid = static_cast<T*>(scratch);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  T* part = static_cast<T*>(partials);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const dim3 block(a.bx, a.by, 1);
  if constexpr (kRounded) {
    wave_kernel<S, T, kFull, false><<<blocks, block, 0, stream>>>(src, dst, m, part, cnt, g, win,
                                                                  p, a, mid);
  } else {
    switch (mode) {
      case kStreamOnly:
        wave_kernel<S, T, kStreamOnly, kZ><<<blocks, block, 0, stream>>>(src, dst, m, part, cnt,
                                                                         g, win, p, a, mid);
        break;
      case kCopy:
        wave_kernel<S, T, kCopy, kZ><<<blocks, block, 0, stream>>>(src, dst, m, part, cnt, g,
                                                                   win, p, a, mid);
        break;
      case kNoRoll:
        wave_kernel<S, T, kNoRoll, kZ><<<blocks, block, 0, stream>>>(src, dst, m, part, cnt, g,
                                                                     win, p, a, mid);
        break;
      default:
        wave_kernel<S, T, kFull, kZ><<<blocks, block, 0, stream>>>(src, dst, m, part, cnt, g,
                                                                   win, p, a, mid);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials<T>(part, a.gx * a.gy * g.nz, k, static_cast<T*>(tot), stream);
}

template <typename T>
int wave_blocks(int mode, int threads) {
  int n = 0;
  cudaError_t err;
  switch (mode) {
    case kStreamOnly:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wave_kernel<T, T, kStreamOnly, false>, threads, 0);
      break;
    case kCopy:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wave_kernel<T, T, kCopy, false>, threads, 0);
      break;
    case kNoRoll:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wave_kernel<T, T, kNoRoll, false>, threads, 0);
      break;
    default:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wave_kernel<T, T, kFull, false>, threads, 0);
  }
  return err == cudaSuccess ? n : -(int)err;
}

// the rounded pass's instance (mode full only)
int wave_blocks_rounded(int threads) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, wave_kernel<__nv_bfloat16, float, kFull, false>, threads, 0);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

#define LBM3_ARGS                                                              \
  int nz, int ny, int nx, int bx, int by, int bz, int k, int plane_offset,     \
      int valid_lo, int valid_hi, int global_nz, int row_lo, int row_hi,       \
      int accel_plane, double omo, double wo0, double wo1, double wo2,         \
      double fw1, double fw2, double om, void *stream
#define LBM3_GRID                                                              \
  Grid{nz, ny, nx}, bx, by, bz, k,                                             \
      Window{plane_offset, valid_lo, valid_hi, global_nz, row_lo, row_hi,      \
             accel_plane},                                                     \
      make_coef<float>(omo, wo0, wo1, wo2, fw1, fw2, om)
#define LBM3_PASS(T)                                                           \
  Grid{nz, ny, nx}, bx, by, bz, k,                                             \
      Window{plane_offset, valid_lo, valid_hi, global_nz, row_lo, row_hi,      \
             accel_plane},                                                     \
      make_coef<T>(omo, wo0, wo1, wo2, fw1, fw2, om),                          \
      static_cast<cudaStream_t>(stream)
// the wave path's plan: launch blocks, step-path blocks an item, the lag
#define WAVE_ARGS int blocks, int chunk, int lag

extern "C" {

// B6 on the step path: out = K steps of f. Step j writes out when K - j is
// even and scratch (a second lattice, null for K = 1) otherwise; out and
// scratch are distinct. Only the first step reads f, so for an even K out
// may be f's own storage, and for an odd K > 1 scratch may be. tot[K] is the
// per-step Sum|u|; partials holds K * (number of blocks) values of scratch.
// zmajor: f, out and scratch are (nz, 19, ny, nx), else (19, nz, ny, nx).
int d3q19_kstep_f32(const void* f, const void* mask, void* out, void* scratch,
                    void* partials, void* tot, int zmajor, LBM3_ARGS) {
  return zmajor ? launch_two_stream<float, true>(f, mask, out, scratch, partials, tot,
                                                 LBM3_PASS(float))
                : launch_two_stream<float, false>(f, mask, out, scratch, partials, tot,
                                                  LBM3_PASS(float));
}
int d3q19_kstep_f64(const void* f, const void* mask, void* out, void* scratch,
                    void* partials, void* tot, int zmajor, LBM3_ARGS) {
  return zmajor ? launch_two_stream<double, true>(f, mask, out, scratch, partials, tot,
                                                  LBM3_PASS(double))
                : launch_two_stream<double, false>(f, mask, out, scratch, partials, tot,
                                                   LBM3_PASS(double));
}

// B6 on a bfloat16 lattice (the step path): out = K steps of f, rounded to
// bfloat16 once; scratch is a float lattice (null for K = 1), distinct from
// f and out; partials and tot are float. For K > 1 out may be f's own
// storage (only the first step reads f, only the last writes out).
int d3q19_kstep_bf16(const void* f, const void* mask, void* out, void* scratch,
                     void* partials, void* tot, int zmajor, LBM3_ARGS) {
  return zmajor ? launch_rounded<true>(f, mask, out, scratch, partials, tot, LBM3_GRID, false,
                                       static_cast<cudaStream_t>(stream))
                : launch_rounded<false>(f, mask, out, scratch, partials, tot, LBM3_GRID, false,
                                        static_cast<cudaStream_t>(stream));
}

// B4 on the step path: f = K steps of f, in place, with no other lattice.
int d3q19_kstep_inplace_f32(void* f, const void* mask, void* partials, void* tot,
                            LBM3_ARGS) {
  return launch_inplace<float>(f, mask, partials, tot, LBM3_PASS(float));
}
int d3q19_kstep_inplace_f64(void* f, const void* mask, void* partials, void* tot,
                            LBM3_ARGS) {
  return launch_inplace<double>(f, mask, partials, tot, LBM3_PASS(double));
}
// B4 on a bfloat16 lattice: f = K steps of f, rounded once, through the
// float lattice scratch (null for K = 1, which steps in f itself).
int d3q19_kstep_inplace_bf16(void* f, const void* mask, void* scratch, void* partials,
                             void* tot, LBM3_ARGS) {
  return launch_rounded<false>(f, mask, f, scratch, partials, tot, LBM3_GRID, true,
                               static_cast<cudaStream_t>(stream));
}

// The wave path: out = K steps of f in `mode` (index in MODES), in one
// launch of `blocks` blocks: B6, or with inplace B4 (f == out, mode 0).
// For an even K of B6 out may be f's own storage. counters: 4 * nz + 2 words,
// zero before the launch and after it (a counter a (stage, plane), the
// ticket, the exit word); launches that may run at once need their own.
// zmajor (B6 only): f and out are (nz, 19, ny, nx).
int d3q19_wave_f32(const void* f, const void* mask, void* out, void* partials, void* tot,
                   void* counters, int mode, int inplace, int zmajor, WAVE_ARGS, LBM3_ARGS) {
  return zmajor ? launch_wave<float, float, true>(f, mask, out, nullptr, partials, tot, counters,
                                                  mode, inplace, blocks, chunk, lag,
                                                  LBM3_PASS(float))
                : launch_wave<float, float, false>(f, mask, out, nullptr, partials, tot, counters,
                                                   mode, inplace, blocks, chunk, lag,
                                                   LBM3_PASS(float));
}
int d3q19_wave_f64(const void* f, const void* mask, void* out, void* partials, void* tot,
                   void* counters, int mode, int inplace, int zmajor, WAVE_ARGS, LBM3_ARGS) {
  return zmajor ? launch_wave<double, double, true>(f, mask, out, nullptr, partials, tot,
                                                    counters, mode, inplace, blocks, chunk, lag,
                                                    LBM3_PASS(double))
                : launch_wave<double, double, false>(f, mask, out, nullptr, partials, tot,
                                                     counters, mode, inplace, blocks, chunk, lag,
                                                     LBM3_PASS(double));
}
// B4 on a bfloat16 lattice on the wave path: f = K steps of f (K > 1),
// rounded once, its steps in the float lattice scratch (distinct from f);
// inplace, f == out, mode 0 and q-major only (B6's bfloat16 pass takes the
// step path). partials and tot are float.
int d3q19_wave_bf16(const void* f, const void* mask, void* out, void* scratch, void* partials,
                    void* tot, void* counters, int mode, int inplace, int zmajor, WAVE_ARGS,
                    LBM3_ARGS) {
  if (zmajor) return (int)cudaErrorInvalidValue;
  return launch_wave<__nv_bfloat16, float, false>(f, mask, out, scratch, partials, tot, counters,
                                                  mode, inplace, blocks, chunk, lag,
                                                  LBM3_PASS(float));
}

// Resident blocks an SM of wave_kernel in mode `mode` (index in MODES), by
// the lattice's type: 0 float32, 1 float64, 2 bfloat16 (B4's rounded pass,
// mode 0 only). The q-major instance; the z-major ones have the same launch
// bounds. Negative on an error.
int d3q19_wave_blocks(int mode, int type, int threads) {
  if (type == 2) return mode == kFull ? wave_blocks_rounded(threads) : -(int)cudaErrorInvalidValue;
  return type ? wave_blocks<double>(mode, threads) : wave_blocks<float>(mode, threads);
}

}  // extern "C"

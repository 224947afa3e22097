// The copy floor of a 2-D pass, for NVIDIA Hopper (sm_90a): kernel B12.
//
// Replaces the Pallas TPU kernel of experiments/d2q9-blocked-floor/run.py
// (`run_copy`, kernel `_copy_kernel`): one pass of out = in over the (9, ny,
// nx) D2Q9 state in (9, by, bx) blocks. No real pass can move the lattice
// faster, so it bounds every K-step kernel's load and store from below, for
// the K-step tiles as for full-width bands.
//
// What bounds it: memory, 2 x 9 values per cell and pass (72 bytes in f32),
// no arithmetic.
//
// Design: one thread block per (9, by, bx) block of the grid, ceil(ny/by) x
// ceil(nx/bx) of them, edge blocks cut to the grid. A block walks its 9 x by
// rows; consecutive threads take consecutive 16-byte pieces of a row
// (coalesced), four pieces in flight a thread before their stores. A block
// whose rows do not start on 16 bytes (nx or bx not a multiple of the vector,
// or an edge block) copies one value at a time, as coalesced.
//
// Interface: plain C; launches on the given stream and returns
// cudaGetLastError(); allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const T* __restrict__ in, T* __restrict__ out, int ny, int nx, int by, int bx) {
  constexpr int V = 16 / sizeof(T);
  const int r0 = blockIdx.y * by, c0 = blockIdx.x * bx;
  const int h = min(by, ny - r0), w = min(bx, nx - c0);
  const size_t gplane = (size_t)ny * nx;
  const bool vec = nx % V == 0 && c0 % V == 0 && w % V == 0
                   && reinterpret_cast<uintptr_t>(in) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_row = vec ? w / V : w;
  const int n = 9 * h * per_row;
  for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    size_t at[kUnroll];
    uint4 v16[kUnroll];
    T v1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kThreads;
      if (idx < n) {
        const int row = idx / per_row;  // (q, r) of the block
        const int piece = idx - row * per_row;
        const int q = row / h, r = row - q * h;
        at[u] = q * gplane + (size_t)(r0 + r) * nx + c0 + (vec ? piece * V : piece);
        if (vec)
          v16[u] = *reinterpret_cast<const uint4*>(in + at[u]);
        else
          v1[u] = in[at[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads < n) {
        if (vec)
          *reinterpret_cast<uint4*>(out + at[u]) = v16[u];
        else
          out[at[u]] = v1[u];
      }
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int ny, int nx, int by, int bx, cudaStream_t stream) {
  const dim3 grid((nx + bx - 1) / bx, (ny + by - 1) / by);
  copy_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(in), static_cast<T*>(out),
                                                ny, nx, by, bx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B12: out = in, a (9, ny, nx) state copied in (9, by, bx) blocks. out must
// not alias in.
int copy_floor_f32(const void* in, void* out, int ny, int nx, int by, int bx, void* stream) {
  return launch<float>(in, out, ny, nx, by, bx, static_cast<cudaStream_t>(stream));
}
int copy_floor_f64(const void* in, void* out, int ny, int nx, int by, int bx, void* stream) {
  return launch<double>(in, out, ny, nx, by, bx, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

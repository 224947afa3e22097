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
// operations would bind only beyond k ~ 20. B8 moves the image once per run,
// so its bound is the operations of its passes; what it pays in practice is
// one barrier across the grid per pass.
//
// Design.
//   B10  one thread per column of a short run of rows: it keeps the three
//        values of the two previous rows in registers, so a value is loaded
//        three times instead of nine; neighbouring threads read
//        neighbouring addresses and the rest comes from L1/L2. The channel
//        is the fastest grid dimension, so the blocks that read one part of
//        the mask run together and it crosses device memory once, not C
//        times.
//   B9   one block per (channel, column tile, row tile). It loads its tile
//        plus a k-cell halo on all four sides (periodic indices), image and
//        mask, into shared memory as float32, runs the k passes there
//        between two buffers on a region that shrinks by one cell per side
//        and pass, applying the mask at every pass, and stores the tile. A
//        pass walks the region in strips: a thread takes one column of 8
//        rows and keeps the two rows above in registers (3 shared loads per
//        value, not 9). The TPU kernel blocks rows only; here columns are
//        tiled too, so the column halo is new. Neighbouring blocks recompute
//        their overlap identically, so the result does not depend on the
//        tile. On an H100 a pass in shared memory costs about a third of a
//        trip through device memory, and a block's trip and its passes add
//        up instead of overlapping (PERF.md): the kernel is bound by
//        instructions, not by bytes.
//   B8   the card has no fast memory that holds a whole image, so the image
//        is spread over the shared memory of the SMs: ONE cooperative launch
//        of at most one block per SM, each keeping its tile (plus a 1-cell
//        halo, two buffers, and its part of the mask) in shared memory as
//        float32 for the whole run, an exchange of tile edges through device
//        memory and one grid barrier a pass. It is the V0 instance of the
//        resident template of blur_resident.cuh, which has the design and
//        which B13's variants share.
//
// Interface: plain C, one entry per (kernel, storage type), each launching on
// the given stream and returning cudaGetLastError(), or a negative code of
// its own where it refuses a launch. The kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "blur_common.cuh"
#include "blur_resident.cuh"

namespace {

constexpr int kThreads = 256;          // B10
constexpr int kRowsPerThread = 8;      // B10: rows one thread walks down
constexpr int kStripRows = 8;          // B9: rows of a strip in shared memory

// The separable pass of B9 on one cell: a, m, b are the three rows in the
// order their sum is taken, (a + 2m) + b, each as (left, middle, right).
__device__ __forceinline__ float separable(float al, float am, float ar,
                                           float ml, float mm, float mr,
                                           float bl, float bm, float br,
                                           float mask) {
  const float rows_l = (al + 2.0f * ml) + bl;
  const float rows_m = (am + 2.0f * mm) + bm;
  const float rows_r = (ar + 2.0f * mr) + br;
  const float acc = (rows_r + 2.0f * rows_m) + rows_l;
  return acc * 0.0625f * mask;
}

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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
blur_k_kernel(const T* __restrict__ img, const T* __restrict__ interior,
              T* __restrict__ out, int h, int w, int th, int tw, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rh = th + 2 * k, rw = tw + 2 * k;
  const int plane = rh * rw;
  float* src = reinterpret_cast<float*>(smem_raw);
  float* dst = src + plane;
  float* m = dst + plane;

  // grid: (channel, tile column, tile row), the channel fastest as in B10
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int r0 = blockIdx.z * th, c0 = blockIdx.y * tw;
  const T* gplane = img + (size_t)blockIdx.x * h * w;

  const float inv_rw = 1.0f / rw;
  for (int idx = tid; idx < plane; idx += nthreads) {
    const int r = div_small(idx, inv_rw);
    const int c = idx - r * rw;
    const size_t g = (size_t)wrap(r0 - k + r, h) * w + wrap(c0 - k + c, w);
    src[idx] = ld(gplane + g);
    m[idx] = ld(interior + g);
  }
  __syncthreads();

  for (int j = 1; j <= k; ++j) {
    // pass j updates region rows [j, rh - j) x columns [j, rw - j)
    // in strips: a thread walks one column down kStripRows rows and keeps
    // the two rows above in registers, so a value costs 3 loads, not 9
    const int hh = rh - 2 * j, ww = rw - 2 * j;
    const int strips = (hh + kStripRows - 1) / kStripRows;
    const float inv_ww = 1.0f / ww;
    for (int s = tid; s < strips * ww; s += nthreads) {
      const int strip = div_small(s, inv_ww);
      const int first = j + strip * kStripRows;
      const int last = min(first + kStripRows, j + hh);
      int mid = first * rw + j + s - strip * ww;
      float al = src[mid - rw - 1], am = src[mid - rw], ar = src[mid - rw + 1];
      float ml = src[mid - 1], mm = src[mid], mr = src[mid + 1];
      for (int r = first; r < last; ++r, mid += rw) {
        const float bl = src[mid + rw - 1], bm = src[mid + rw], br = src[mid + rw + 1];
        dst[mid] = separable(al, am, ar, ml, mm, mr, bl, bm, br, m[mid]);
        al = ml; am = mm; ar = mr;
        ml = bl; mm = bm; mr = br;
      }
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  T* oplane = out + (size_t)blockIdx.x * h * w;
  const float inv_tw = 1.0f / tw;
  for (int idx = tid; idx < th * tw; idx += nthreads) {
    const int r = div_small(idx, inv_tw);
    const int c = idx - r * tw;
    if (r0 + r < h && c0 + c < w)
      st(oplane + (size_t)(r0 + r) * w + c0 + c, src[(r + k) * rw + c + k]);
  }
}

// Mirrored by stencil.blur_k_smem_bytes on the Python side.
size_t blur_k_smem_bytes(int th, int tw, int k) {
  return (size_t)3 * (th + 2 * k) * (tw + 2 * k) * sizeof(float);
}

template <typename T>
int launch_k(const void* img, const void* interior, void* out, int c, int h,
             int w, int th, int tw, int k, int threads, cudaStream_t stream) {
  // div_small's range; the shared memory limit is tighter on the region
  if (threads < 32 || threads > kMaxThreads || k < 1 || th < 1 || tw < 1 ||
      tw + 2 * k >= 1024 ||
      (th + 2 * k) * (tw + 2 * k) >= 65536)
    return kBadArgument;
  const size_t smem = blur_k_smem_bytes(th, tw, k);
  cudaError_t err = cudaFuncSetAttribute(
      blur_k_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(c, (w + tw - 1) / tw, (h + th - 1) / th);
  blur_k_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(interior),
      static_cast<T*>(out), h, w, th, tw, k);
  return (int)cudaGetLastError();
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

// B9: out = k passes over img, tiles of th x tw, blocks of `threads`
// threads; out must not alias img.
// Needs tw + 2k < 1024 and 12 (th + 2k)(tw + 2k) bytes of shared memory;
// returns -3 on a tile it does not take.
int stencil_k_f32(const void* img, const void* interior, void* out, int c,
                  int h, int w, int th, int tw, int k, int threads,
                  void* stream) {
  return launch_k<float>(img, interior, out, c, h, w, th, tw, k, threads,
                         static_cast<cudaStream_t>(stream));
}
int stencil_k_bf16(const void* img, const void* interior, void* out, int c,
                   int h, int w, int th, int tw, int k, int threads,
                   void* stream) {
  return launch_k<__nv_bfloat16>(img, interior, out, c, h, w, th, tw, k, threads,
                                 static_cast<cudaStream_t>(stream));
}

// B8: out = num_passes passes over img, in one cooperative launch of
// c * ceil(h/th) * ceil(w/tw) blocks of `threads` threads; out must not alias
// img. xrow holds 2 * c * ceil(h/th) * 2 * w floats and xcol
// 2 * c * ceil(w/tw) * 2 * h. Returns -1 when the blocks cannot all be
// resident at once, -2 when the device has no cooperative launch, -3 on a
// tile or thread count the kernel does not take.
int stencil_resident_f32(const void* img, const void* interior, void* out,
                         void* xrow, void* xcol, int c, int h, int w, int th,
                         int tw, int num_passes, int threads, void* stream) {
  return launch_resident<float, V0>(img, interior, out, xrow, xcol, c, h, w, th, tw,
                                    0, 0, num_passes, threads,
                                    static_cast<cudaStream_t>(stream));
}
int stencil_resident_bf16(const void* img, const void* interior, void* out,
                          void* xrow, void* xcol, int c, int h, int w, int th,
                          int tw, int num_passes, int threads, void* stream) {
  return launch_resident<__nv_bfloat16, V0>(img, interior, out, xrow, xcol, c, h, w,
                                            th, tw, 0, 0, num_passes, threads,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

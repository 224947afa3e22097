// The resident-blur variants v0-v7 of the 3x3 Gaussian blur, for NVIDIA
// Hopper (sm_90a): kernel B13.
//
// Replaces experiments/blur-resident-opt/run.py's one pl.pallas_call site,
// `_vmem_call`, and the eight kernel bodies it serves (v0_kernel ..
// v7_kernel). Each runs a whole sequence of blur passes with the image held
// in fast memory; they differ in how a pass is written (lbm_tpu_torch/ops/
// blur_resident_opt.py has the table). No SM holds an image here, so every
// variant is an instance of B8's scheme, the template `resident_kernel<T, V>`
// of csrc/blur_resident.cuh, which has the design: one cooperative launch of
// at most one block per SM, a tile each in shared memory for the whole run,
// an exchange of tile edges and one grid barrier a pass.
//
// Instances (the variants are defined in blur_resident.cuh): v0, which is
// also v1 (on the TPU the two differ only in how a shift is lowered, roll
// against slice+concat, which is the same index arithmetic here) and is B8's
// own instance, so v0 equals B8 bit for bit; v2, v3, v4, v5, v6, v7.
//
// What bounds them. The image crosses device memory once in and once out a
// run, so a pass's bound is its operations (8 or 9 a value). What a pass
// pays in practice is the grid barrier and the exchange (B8: 3.4 us a pass
// at 4x320x512, PERF.md), plus the tile's cells over the block's threads:
// the bytes a value held decide which images can stay resident at all (12 B
// for v0-v2 and v4, 6 for v3, 8 for v5, 4 for v6 and v7, halos aside).
//
// Interface: plain C, one entry per (instance, image type), launching on the
// given stream and returning cudaGetLastError(), or a negative code of its
// own where it refuses a launch. The kernels allocate nothing.

#include "blur_resident.cuh"

// Every entry: out = num_passes passes of the instance over img, in one
// cooperative launch of planes * ceil(h/th) * ceil(w/tw) blocks of `threads`
// threads; out must not alias img. interior is (h, w) in img's type (not
// read by v5, v6, v7, which zero the ring outside rows 1..h0 and columns
// 1..w0). xrow holds 2 * planes * ceil(h/th) * 2 * w values of the state's
// type and xcol 2 * planes * ceil(w/tw) * 2 * hw * h. Returns -1 when the
// blocks cannot all be resident at once, -2 when the device has no
// cooperative launch, -3 on a tile or thread count the kernel does not take.
#define BLUR_RESIDENT_OPT_ENTRY(NAME, T, V)                                            \
  extern "C" int NAME(const void* img, const void* interior, void* out, void* xrow,    \
                      void* xcol, int c, int h, int w, int th, int tw, int h0, int w0, \
                      int num_passes, int threads, void* stream) {                     \
    return launch_resident<T, V>(img, interior, out, xrow, xcol, c, h, w, th, tw, h0,  \
                                 w0, num_passes, threads,                              \
                                 static_cast<cudaStream_t>(stream));                   \
  }

BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v0_f32, float, V0)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v0_bf16, __nv_bfloat16, V0)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v2_f32, float, V2)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v2_bf16, __nv_bfloat16, V2)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v3_f32, float, V3)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v3_bf16, __nv_bfloat16, V3)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v4_f32, float, V4)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v4_bf16, __nv_bfloat16, V4)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v5_f32, float, V5)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v5_bf16, __nv_bfloat16, V5)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v6_f32, float, V6)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v6_bf16, __nv_bfloat16, V6)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v7_f32, float, V7)
BLUR_RESIDENT_OPT_ENTRY(blur_resident_opt_v7_bf16, __nv_bfloat16, V7)

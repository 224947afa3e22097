#!/usr/bin/env python3
"""B12's TMA tile copy under variants, beside `Tensor.copy_`: what holds a
(9, 16, 32) float32 tile above `copy_` at 4096^2?

VARIANT_SRC, built once with one nvcc beside the shipped B12
(csrc/copy_floor.cu, whose kernel it includes), holds:
- B12's kernel as shipped (copy_tma_kernel) launched otherwise: tensor maps
  of another L2 promotion (none, 256 B, against the shipped 128 B), no
  clusters for tiles of one box (against four tiles side by side a thread
  block cluster whose blocks meet before their loads), and clusters of four
  for tiles of a ring of boxes too (the shipped launches those alone);
- the first design candidate, kept here: one block a tile whose threads
  copy 16-byte pieces in registers, three in flight a thread, indexed with
  no division a piece, at 16x32 and 32x128;
- a one-box (9, 16, 32) tile kernel with an L2 eviction priority on its TMA
  load, its store or both (evict_first), beside the same kernel with none;
- the tiles taken column-major or in groups of 8 tile rows; a persistent
  grid of 1 or 2 blocks an SM whose blocks walk their tiles through a ring
  of 2-11 stages, the next tiles' loads in flight while one is stored (the
  third design candidate for B12); and a flat copy by the SMs that knows no
  tiles (16-byte pieces, four in flight a thread, plain, streaming `.cs` or
  read-only loads), for the ceiling of copies by the SMs.
Through the shipped library, bypassing the wrapper's choice of `stages`:
with a tile of one chunk the stages beyond the first are unused shared
memory, so `stages` 1 to 4 hold the blocks an SM at 11, 6, 4 and 3 (the
bytes in flight); 32x128 tiles in chunks of 8 and 4 rows through rings of
2 and 4 stages; and wider tiles (16x64, 32x128, 16x4096) at the wrapper's
chunks and stages.

Each case is CUDA events over `passes` passes ping-ponging two buffers,
after a warm-up and a check that the copy equals its input, in rounds with
the cases in turn, `copy_` in every round. Grids 1024^2 and 4096^2
(`--grids`); with `--parent DIR`, the B12 of the copy of the port under DIR
(its own C entry) at 16x32 and 32x128 in the same rounds. Writes
results_copy_variants.csv beside this file (or --out)
with the card's name and power limit, and prints each case's median.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/copy_variants.py [--rounds 3] [--parent build/parent]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import ctypes
import functools
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.ops import _build, copy_floor  # noqa: E402

SHIPPED = "shipped (L2 128 B, clusters of 4)"
PROMOTION = {"L2 promotion none": 0, "L2 promotion 256 B": 3}  # CUtensorMapL2promotion
SHIPPED_PROMOTION = 2  # CU_TENSOR_MAP_L2_PROMOTION_L2_128B
EVICT = {"one-box kernel, no hint": 0, "evict_first loads": 1, "evict_first stores": 2,
         "evict_first both": 3}
PASSES = {1024: 1000, 4096: 100}
WIDE_TILES = ((16, 64), (32, 128), (16, 4096))
PERSISTENT = {1: (4, 8, 11), 2: (2, 4, 5)}  # blocks an SM: stages of the ring
STREAM_BLOCKS = (132 * 8, 132 * 32)

VARIANT_SRC = r"""
#include "copy_floor.cu"  // B12 as shipped: copy_tma_kernel, Chunk, tma_smem

namespace {
constexpr int kTileBytes = 9 * 16 * 32 * 4;  // a (9, 16, 32) float32 tile

// the tensor map of a (9, ny, nx) float32 state in boxes of ch, at an L2
// promotion of `promotion`
int map_at(CUtensorMap* map, const void* base, int ny, int nx, Chunk ch, int promotion) {
  const tile_copy::EncodeTiled encode = tile_copy::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)nx, (cuuint64_t)ny, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)nx * 4, (cuuint64_t)ny * nx * 4};
  const cuuint32_t box[3] = {(cuuint32_t)ch.x, (cuuint32_t)ch.y, (cuuint32_t)ch.q};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                (CUtensorMapL2promotion)promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

cudaError_t launch_in(void (*kernel)(CUtensorMap, CUtensorMap, int, int, int, int, Chunk, int),
                      dim3 grid, size_t smem, unsigned cluster, cudaStream_t stream,
                      const CUtensorMap& a, const CUtensorMap& b, int ny, int nx, int by, int bx,
                      Chunk ch, int stages) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = grid.x % cluster == 0 ? cluster : 1;
  dims.val.clusterDim.y = 1;
  dims.val.clusterDim.z = 1;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, b, ny, nx, by, bx, ch, stages);
}

// one block a (9, 16, 32) tile, one TMA load and store as copy_tma_kernel
// moves a tile of one box, in clusters of four; kEvict 1 puts evict_first
// on the load, 2 on the store, 3 on both, 0 on neither
template <int kEvict>
__global__ void __launch_bounds__(32) evict_kernel(__grid_constant__ const CUtensorMap src,
                                                   __grid_constant__ const CUtensorMap dst) {
  __shared__ __align__(128) unsigned char tile[kTileBytes];
  __shared__ uint64_t full;
  tile_copy::cluster_meet();
  if (threadIdx.x) return;
  const int x = blockIdx.x * 32, y = blockIdx.y * 16;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  tile_copy::mbar_init(&full, 1);
  tile_copy::mbar_expect_tx(&full, kTileBytes);
  if (kEvict & 1)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
        ::"r"(tile_copy::smem_addr(tile)), "l"(reinterpret_cast<uint64_t>(&src)),
          "r"(tile_copy::smem_addr(&full)), "r"(x), "r"(y), "r"(0), "l"(policy)
        : "memory");
  else
    tile_copy::box_load(&src, tile, &full, x, y, 0);
  tile_copy::mbar_wait(&full, 0);
  if (kEvict & 2)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
        " [%0, {%2, %3, %4}], [%1], %5;\n"
        ::"l"(reinterpret_cast<uint64_t>(&dst)), "r"(tile_copy::smem_addr(tile)), "r"(x),
          "r"(y), "r"(0), "l"(policy)
        : "memory");
  else
    tile_copy::box_store(&dst, tile, x, y, 0);
  tile_copy::bulk_commit();
  tile_copy::bulk_wait_read<0>();
}

// the first design candidate, 16-byte pieces in registers: one block a
// (9, by, bx) tile, 384 threads, three pieces in flight a thread, each
// thread's (plane, row, piece) walked with no division a piece
// (nx, bx multiples of 4; the tile one sweep at 16x32)
__global__ void __launch_bounds__(384) vector_kernel(const float* __restrict__ in,
                                                     float* __restrict__ out, int ny, int nx,
                                                     int by, int bx) {
  const int r0 = blockIdx.y * by, c0 = blockIdx.x * bx;
  const int h = min(by, ny - r0), wp = min(bx, nx - c0) / 4, n = 9 * h * wp;
  const size_t plane = (size_t)ny * nx, origin = (size_t)r0 * nx + c0;
  tile_copy::Walk at(threadIdx.x, blockDim.x, h, wp);
  for (int base = threadIdx.x; base < n; base += 3 * blockDim.x) {
    uint4 v[3];
    size_t off[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      off[u] = base + u * (int)blockDim.x < n
                   ? origin + at.q * plane + (size_t)at.r * nx + (size_t)at.c * 4
                   : SIZE_MAX;
      if (off[u] != SIZE_MAX) v[u] = *reinterpret_cast<const uint4*>(in + off[u]);
      at.next();
    }
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (off[u] != SIZE_MAX) *reinterpret_cast<uint4*>(out + off[u]) = v[u];
  }
}

// one block a (9, 16, 32) tile, one TMA load and store, the tiles taken in
// another order: 1 column-major, 2 groups of 8 tile rows, column-major inside
template <int kOrder>
__global__ void __launch_bounds__(32) order_kernel(__grid_constant__ const CUtensorMap src,
                                                   __grid_constant__ const CUtensorMap dst,
                                                   int ny, int nx) {
  __shared__ __align__(128) unsigned char tile[kTileBytes];
  __shared__ uint64_t full;
  if (threadIdx.x) return;
  const int ntx = nx / 32, nty = ny / 16, b = blockIdx.x;
  const int g = kOrder == 1 ? nty : 8;
  const int first = b / (g * ntx) * g, rows = min(g, nty - first), in_group = b - first * ntx;
  const int x = in_group / rows * 32, y = (first + in_group % rows) * 16;
  tile_copy::mbar_init(&full, 1);
  tile_copy::mbar_expect_tx(&full, kTileBytes);
  tile_copy::box_load(&src, tile, &full, x, y, 0);
  tile_copy::mbar_wait(&full, 0);
  tile_copy::box_store(&dst, tile, x, y, 0);
  tile_copy::bulk_commit();
  tile_copy::bulk_wait_read<0>();
}

// a persistent grid: block b copies tiles b, b + grid, ... through a ring
__global__ void __launch_bounds__(32) persistent_kernel(__grid_constant__ const CUtensorMap src,
                                                        __grid_constant__ const CUtensorMap dst,
                                                        int ny, int nx, int stages) {
  extern __shared__ unsigned char smem_raw[];
  if (threadIdx.x) return;
  const int ntx = nx / 32, ntiles = ntx * (ny / 16);
  const int mine = (int)blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  unsigned char* ring = tile_copy::align128<unsigned char>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kTileBytes);
  const int len = min(stages, mine);
  const auto xy = [&](int i, int& x, int& y) {
    const int t = blockIdx.x + i * gridDim.x;
    x = t % ntx * 32;
    y = t / ntx * 16;
  };
  const auto fetch = [&](int i) {
    int x, y;
    xy(i, x, y);
    tile_copy::mbar_expect_tx(&full[i % len], kTileBytes);
    tile_copy::box_load(&src, ring + (i % len) * kTileBytes, &full[i % len], x, y, 0);
  };
  for (int s = 0; s < len; ++s) tile_copy::mbar_init(&full[s], 1);
  for (int i = 0; i < len; ++i) fetch(i);
  for (int i = 0; i < mine; ++i) {
    tile_copy::mbar_wait(&full[i % len], (uint32_t)(i / len) & 1u);
    int x, y;
    xy(i, x, y);
    tile_copy::box_store(&dst, ring + (i % len) * kTileBytes, x, y, 0);
    tile_copy::bulk_commit();
    if (i >= 1 && i - 1 + len < mine) {
      tile_copy::bulk_wait_read<1>();
      fetch(i - 1 + len);
    }
  }
  tile_copy::bulk_wait_read<0>();
}

// no tiles: 16-byte pieces, four in flight a thread; loads and stores plain
// (0), streaming (1: ld.global.cs, st.global.cs), read-only and streaming (2)
template <int kHint>
__global__ void __launch_bounds__(256) stream_kernel(const float4* __restrict__ in,
                                                     float4* __restrict__ out, long n) {
  const long stride = (long)gridDim.x * blockDim.x;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = kHint == 0 ? in[i + u * stride] : kHint == 1 ? __ldcs(in + i + u * stride)
                                                          : __ldg(in + i + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (kHint == 0) out[i + u * stride] = v[u];
      else __stcs(out + i + u * stride, v[u]);
    }
  }
  for (; i < n; i += stride) out[i] = in[i];
}

int maps(const void* in, void* out, int ny, int nx, CUtensorMap* a, CUtensorMap* b) {
  int rc = tile_copy::encode_map(a, {in, 4, 9, ny, nx, 9, 16, 32});
  return rc ? rc : tile_copy::encode_map(b, {out, 4, 9, ny, nx, 9, 16, 32});
}
}  // namespace

extern "C" {
// copy_tma_kernel<float> over (9, by, bx) tiles in chunks of (cq, cy, cx)
// through `stages` stages, its maps at L2 promotion `promotion`, the blocks
// of a row in clusters of `cluster` (1: none)
int variant_tma(const void* in, void* out, int ny, int nx, int by, int bx, int cq, int cy, int cx,
                int stages, int promotion, int cluster, void* stream) {
  const Chunk ch{cq, cy, cx};
  CUtensorMap a, b;
  int rc = map_at(&a, in, ny, nx, ch, promotion);
  if (rc == 0) rc = map_at(&b, out, ny, nx, ch, promotion);
  if (rc) return rc;
  const size_t smem = tma_smem(ch, stages, 4);
  cudaError_t err = tile_copy::fit_smem(copy_tma_kernel<float>, smem, tma_smem_set<float>());
  if (err == cudaSuccess)
    err = launch_in(copy_tma_kernel<float>, dim3((nx + bx - 1) / bx, (ny + by - 1) / by), smem,
                    (unsigned)cluster, static_cast<cudaStream_t>(stream), a, b, ny, nx, by, bx,
                    ch, stages);
  return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
}
int variant_vector(const void* in, void* out, int ny, int nx, int by, int bx, void* stream) {
  const dim3 grid((nx + bx - 1) / bx, (ny + by - 1) / by);
  vector_kernel<<<grid, 384, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), ny, nx, by, bx);
  return (int)cudaGetLastError();
}
int variant_evict(const void* in, void* out, int ny, int nx, int evict, void* stream) {
  CUtensorMap a, b;
  if (int rc = maps(in, out, ny, nx, &a, &b)) return rc;
  const dim3 grid(nx / 32, ny / 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = evict == 1   ? tile_copy::launch_tiles(evict_kernel<1>, grid, 32, 0, s, true, a, b)
                    : evict == 2 ? tile_copy::launch_tiles(evict_kernel<2>, grid, 32, 0, s, true, a, b)
                    : evict == 3 ? tile_copy::launch_tiles(evict_kernel<3>, grid, 32, 0, s, true, a, b)
                                 : tile_copy::launch_tiles(evict_kernel<0>, grid, 32, 0, s, true, a, b);
  return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
}
int variant_order(const void* in, void* out, int ny, int nx, int order, void* stream) {
  CUtensorMap a, b;
  if (int rc = maps(in, out, ny, nx, &a, &b)) return rc;
  const int blocks = (nx / 32) * (ny / 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 1) order_kernel<1><<<blocks, 32, 0, s>>>(a, b, ny, nx);
  else order_kernel<2><<<blocks, 32, 0, s>>>(a, b, ny, nx);
  return (int)cudaGetLastError();
}
int variant_persistent(const void* in, void* out, int ny, int nx, int per_sm, int stages,
                       void* stream) {
  CUtensorMap a, b;
  if (int rc = maps(in, out, ny, nx, &a, &b)) return rc;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = 128 + stages * (kTileBytes + 8);
  cudaFuncSetAttribute(persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = min((nx / 32) * (ny / 16), sms * per_sm);
  persistent_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(a, b, ny, nx,
                                                                            stages);
  return (int)cudaGetLastError();
}
int variant_stream(const void* in, void* out, long values, int hint, int blocks, void* stream) {
  const long n = values / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(in);
  float4* b = static_cast<float4*>(out);
  if (hint == 0) stream_kernel<0><<<blocks, 256, 0, s>>>(a, b, n);
  else if (hint == 1) stream_kernel<1><<<blocks, 256, 0, s>>>(a, b, n);
  else stream_kernel<2><<<blocks, 256, 0, s>>>(a, b, n);
  return (int)cudaGetLastError();
}
}  // extern "C"
"""

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def build(tmp: Path, parent: str | None) -> tuple[ctypes.CDLL, ctypes.CDLL, ctypes.CDLL | None]:
    """The shipped copy_floor library, that of VARIANT_SRC and (with `parent`)
    that of the copy of the port under `parent`, each by one nvcc, started
    together."""
    src = tmp / "copy_variants.cu"
    src.write_text(VARIANT_SRC)
    jobs = {"variants": ([f"-I{_build.CSRC_DIR}", str(src)], tmp / "libvariants.so")}
    if parent:
        jobs["parent"] = ([str(Path(parent) / "lbm_tpu_torch" / "csrc" / "copy_floor.cu")],
                          tmp / "libparent.so")
    procs = {name: subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                                     *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, (args, out) in jobs.items()}
    shipped = _build.load("copy_floor")
    libs = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}: {stdout}{stderr}")
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    var = libs["variants"]
    var.variant_tma.argtypes = [_P, _P, *[_I] * 10, _P]
    var.variant_evict.argtypes = [_P, _P, _I, _I, _I, _P]
    var.variant_vector.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    var.variant_order.argtypes = [_P, _P, _I, _I, _I, _P]
    var.variant_persistent.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    var.variant_stream.argtypes = [_P, _P, _L, _I, _I, _P]
    if parent:  # (in, out, ny, nx, by, bx, stream)
        libs["parent"].copy_floor_f32.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    return shipped, var, libs.get("parent")


def chained(launch, f, bufs):
    """run(k): k passes of launch(src, dst), ping-ponging bufs."""
    def run(k):
        src = f
        for i in range(k):
            rc = launch(src.data_ptr(), bufs[i % 2].data_ptr())
            if rc:
                raise RuntimeError(f"CUDA error {rc} at launch")
            src = bufs[i % 2]
    return run


def ms_per_pass(run, passes):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(passes)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def cases_for(n, f, bufs, shipped, var, parent):
    stream = torch.cuda.current_stream().cuda_stream

    def b12(stages, tile=(16, 32), chunk=(9, 16, 32)):
        plan = (ctypes.c_int * 10)(4, n, n, *tile, 0, *chunk, stages)
        return chained(lambda a, b: shipped.copy_floor_run(ctypes.addressof(plan), a, b, stream),
                       f, bufs)

    def tma(stages, tile, chunk, promotion, cluster):
        return chained(lambda a, b: var.variant_tma(a, b, n, n, *tile, *chunk, stages, promotion,
                                                    cluster, stream), f, bufs)

    def library(k):
        src = f
        for i in range(k):
            bufs[i % 2].copy_(src)
            src = bufs[i % 2]

    cases = {"copy_": library, f"16x32 {SHIPPED}": b12(1),
             "16x32 no clusters": tma(1, (16, 32), (9, 16, 32), SHIPPED_PROMOTION, 1)}
    if parent is not None:
        for by, bx in ((16, 32), (32, 128)):
            cases[f"{by}x{bx} parent"] = chained(
                lambda a, b, t=(by, bx): parent.copy_floor_f32(a, b, n, n, *t, stream), f, bufs)
    for by, bx in ((16, 32), (32, 128)):
        cases[f"{by}x{bx} 16-byte registers (candidate 1)"] = chained(
            lambda a, b, t=(by, bx): var.variant_vector(a, b, n, n, *t, stream), f, bufs)
    for chunk in ((9, 8, 128), (9, 4, 128)):
        for stages in (2, 4):
            cases[f"32x128 {SHIPPED}, chunk {chunk}, {stages} stages"] = b12(stages, (32, 128),
                                                                             chunk)
            cases[f"32x128 rings in clusters, chunk {chunk}, {stages} stages"] = tma(
                stages, (32, 128), chunk, SHIPPED_PROMOTION, 4)
    for stages in (2, 3, 4):
        cases[f"16x32 {SHIPPED}, stages {stages}"] = b12(stages)
    if n != 4096:
        return cases
    for name, promotion in PROMOTION.items():
        cases[f"16x32 {name}"] = tma(1, (16, 32), (9, 16, 32), promotion, 4)
    for name, evict in EVICT.items():
        cases[f"16x32 {name}"] = chained(
            lambda a, b, e=evict: var.variant_evict(a, b, n, n, e, stream), f, bufs)
    for order, name in ((1, "column-major"), (2, "groups of 8 tile rows")):
        cases[f"16x32 {name}"] = chained(
            lambda a, b, o=order: var.variant_order(a, b, n, n, o, stream), f, bufs)
    for per_sm, stage_list in PERSISTENT.items():
        for stages in stage_list:
            cases[f"16x32 persistent, {per_sm} an SM, {stages} stages"] = chained(
                lambda a, b, p=per_sm, s=stages: var.variant_persistent(a, b, n, n, p, s, stream),
                f, bufs)
    for hint in (0, 1, 2):
        for blocks in STREAM_BLOCKS:
            cases[f"flat, no tiles, hint {hint}, {blocks} blocks"] = chained(
                lambda a, b, h=hint, k=blocks: var.variant_stream(a, b, f.numel(), h, k, stream),
                f, bufs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for by, bx in WIDE_TILES:
        chunk, stages = copy_floor.ring_of(by, bx, 4, (n // by) * (n // bx), sms,
                                           functools.partial(copy_floor.blocks_per_sm, 4))
        cases[f"{by}x{bx} {SHIPPED}, chunk {chunk}, stages {stages}"] = b12(stages, (by, bx),
                                                                            chunk)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--grids", type=int, nargs="*", default=list(PASSES))
    ap.add_argument("--parent", help="a copy of the port whose B12 to time beside (e.g. "
                                     "build/parent from git archive)")
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_copy_variants.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("copy_variants: CUDA is not available", file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        shipped, var, parent = build(Path(tmp), args.parent)
        for n in args.grids:
            passes = PASSES.get(n, 100)
            f = torch.rand((9, n, n), device="cuda", generator=torch.Generator("cuda").manual_seed(n))
            bufs = (torch.empty_like(f), torch.empty_like(f))
            cases = cases_for(n, f, bufs, shipped, var, parent)
            for name, run in cases.items():
                bufs[1].zero_()
                run(2)
                torch.cuda.synchronize()
                if not torch.equal(bufs[1], f):
                    raise SystemExit(f"{name} {n}^2: differs from its input")
            for r in range(args.rounds):
                for name, run in cases.items():
                    rows.append(dict(case=name, grid=f"{n}x{n}", round=r, passes=passes,
                                     us=round(ms_per_pass(run, passes) * 1e3, 3)))
            for name in cases:
                us = [row["us"] for row in rows if row["case"] == name and row["grid"] == f"{n}x{n}"]
                print(f"{n}^2 {name:58s} median {statistics.median(us):9.3f} us "
                      f"({min(us):.3f}-{max(us):.3f})", flush=True)
            del f, bufs
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32; experiments/cuda-kstep-tiles/copy_variants.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())

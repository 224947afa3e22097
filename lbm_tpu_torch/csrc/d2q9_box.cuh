// What the box paths of the D2Q9 K-step kernels share: B1 and B2
// (kstep_box_kernel, csrc/d2q9_kstep.cu) and B3 (manual_box_kernel,
// csrc/d2q9_manual.cu). A tile's region arrives by TMA boxes; the threads
// then patch the strips that no box can place (for B2 and B3 the rows and
// columns that wrap around the grid, which TMA fills with zeros), reading
// each value where the thread path reads it (cell_source). Also the path
// numbers of the C entry points and the shape rule every box path keeps.

#pragma once

#include "d2q9_step.cuh"

namespace d2q9 {

enum Path { kThreadPath = 0, kBoxPath = 1 };  // d2q9_kstep.PATHS

__host__ __device__ inline int round_up(int x, int a) { return (x + a - 1) / a * a; }


// Shared memory a block may use on Hopper (d2q9_kstep.SMEM_PER_BLOCK).
constexpr size_t kSmemPerBlock = 232448;

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }


// The rules of B2's and B3's box paths that do not depend on shared memory
// (mirrored by d2q9_kstep.choose_path): no edge tiles; tile sides of at
// least K; rows of f, box rows and tile rows of a multiple of 16 bytes; a
// region's first column (c0 - K) on 16 bytes, so K values a multiple of 16
// bytes (an H100 traps on a box load that starts 8 bytes off); boxes of at
// most 256 a side; 16-byte aligned buffers.
inline bool box_layout_fits(const Tiles& t, int elem, const void* f, const void* out) {
  const int rh = t.th + 2 * t.k, rw = t.tw + 2 * t.k;
  return !has_edges(t) && t.th >= t.k && t.tw >= t.k && rh <= 256 && rw <= 256 &&
         (t.k * elem) % 16 == 0 && (t.tw * elem) % 16 == 0 && ((size_t)t.nx * elem) % 16 == 0 &&
         aligned16(f) && aligned16(out);
}

// Where the nine values of region cell (r, c) come from: speed q is at
// base[q * stride]. f for the tile interior (and the whole region in B2);
// in place, the boundary snapshot for the halo. Only the address is chosen
// per cell, so a warp that mixes interior and halo cells issues its nine
// loads together instead of once per branch.
template <typename T, bool kInPlace>
__device__ __forceinline__ const T* cell_source(const T* f, const T* hband,
                                                const T* vband, const Tiles& t,
                                                const Region& g, int r, int c,
                                                int gr, int gc, size_t& stride) {
  stride = (size_t)t.ny * t.nx;
  const T* base = f + (size_t)gr * t.nx + gc;
  if (kInPlace) {
    const int k = t.k, two_k = 2 * k;
    if (r < k || r >= k + g.th) {
      // rows around a horizontal tile boundary: hband[b][q][i][x] holds row
      // (b*th - k + i) mod ny; below the last tile lies boundary 0
      const int b = r < k ? g.ty : (g.ty + 1) % t.nty();
      const int i = r < k ? r : r - g.th;
      base = hband + ((size_t)b * 9 * two_k + i) * t.nx + gc;
      stride = (size_t)two_k * t.nx;
    } else if (c < k || c >= k + g.tw) {
      // columns around a vertical tile boundary: vband[b][q][y][i] holds
      // column (b*tw - k + i) mod nx
      const int b = c < k ? g.tx : (g.tx + 1) % t.ntx();
      const int i = c < k ? c : c - g.tw;
      base = vband + ((size_t)b * 9 * t.ny + gr) * two_k + i;
      stride = (size_t)t.ny * two_k;
    }
  }
  return base;
}

// The cells of a region that no box places, as two pieces (region rows and
// columns): A, rows [0, a_top) and [rh - a_bot, rh) x columns [0, a_l) and
// [rw - a_r, rw); B, rows [b_lo, b_hi) x columns [0, b_l) and [rw - b_r, rw).
// B2: A the rows that wrap (all columns), B the columns that wrap (the rows
// between). B1: A the corners of the hband rows that wrap, B the 2K columns
// beside the tile, from vband. (Mirrored by region_plan in
// tests/test_torch_d2q9_region_plan.py.)
struct Strips {
  int a_top, a_bot, a_l, a_r, b_lo, b_hi, b_l, b_r;
};

template <bool kInPlace>
__device__ __forceinline__ Strips strips_of(const Tiles& t, const Region& g) {
  const int k = t.k;
  const int lft = max(0, k - g.c0), rgt = max(0, g.c0 + g.tw + k - t.nx);
  if (kInPlace) return Strips{k, k, lft, rgt, k, k + g.th, k, k};
  const int top = max(0, k - g.r0), bot = max(0, g.r0 + g.th + k - t.ny);
  return Strips{top, bot, g.rw, 0, top, g.rh - bot, lft, rgt};
}

__device__ __forceinline__ int strip_cells(const Strips& s) {
  return (s.a_top + s.a_bot) * (s.a_l + s.a_r) + (s.b_hi - s.b_lo) * (s.b_l + s.b_r);
}

// Loads the nine values of strip cell i into v from where cell_source reads
// them; returns the cell's index in a plane of the region.
template <typename T, bool kInPlace>
__device__ __forceinline__ int load_strip_cell(const T* f, const T* hband, const T* vband,
                                               const Tiles& t, const Region& g,
                                               const Strips& s, int i, T (&v)[9]) {
  const int wa = s.a_l + s.a_r, na = (s.a_top + s.a_bot) * wa;
  int r, c;
  if (i < na) {
    const int rr = i / wa, cc = i - rr * wa;
    r = rr < s.a_top ? rr : g.rh - s.a_bot + (rr - s.a_top);
    c = cc < s.a_l ? cc : g.rw - s.a_r + (cc - s.a_l);
  } else {
    const int wb = s.b_l + s.b_r, rr = (i - na) / wb, cc = i - na - rr * wb;
    r = s.b_lo + rr;
    c = cc < s.b_l ? cc : g.rw - s.b_r + (cc - s.b_l);
  }
  const int gr = wrap(g.r0 - t.k + r, t.ny), gc = wrap(g.c0 - t.k + c, t.nx);
  size_t stride;
  const T* src = cell_source<T, kInPlace>(f, hband, vband, t, g, r, c, gr, gc, stride);
#pragma unroll
  for (int q = 0; q < 9; ++q) v[q] = src[q * stride];
  return r * g.rw + c;
}

}  // namespace d2q9

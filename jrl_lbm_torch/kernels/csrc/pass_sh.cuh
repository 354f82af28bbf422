// A k-step pass (k = 1..4) of one shard of a row or a column mesh in one
// cooperative launch: the launch form of
// fluid_pass_sh.cu, shared with the C phases' passes (c_balance_pass_sh.cu,
// c_approach_pass_sh.cu). One persistent grid
// of SH_THREADS-thread blocks, one an SM, no larger than the co-resident
// limit; sub-step j runs over the shard's rows extended by 2 (k - 1 - j) a
// side (on a mesh of one row the whole grid, its rows wrapping) in tiles
// (the host's plan, kernels/jrl_sharded.py::pass_sh_plan: nty[j] row bands
// x ntx column strips), block b taking tiles b, b + grid, ...; a grid
// barrier between sub-steps; the planes between sub-steps in two scratch
// buffers, shard row r at buffer row r + 2k (a mesh of one row: row r).
// A tile copies its window of rows by cp.async.bulk, one copy a plane row
// and thread, counted on one mbarrier; a copy of scratch rows that other
// blocks wrote before grid.sync needs fence.proxy.async.global first.
//
// Here: that launch form (the tile of a sub-step, the co-resident query
// cached per device and tile size, the proxy fence), and for the C passes
// their sources, the window copy (a row shard's with the wrap column, a
// column shard's from its blocks) and the window's accessors.
#pragma once

#include <atomic>

#include "fused_launch.cuh"
#include "jrl_c.cuh"
#include "jrl_shard.cuh"
#include "pass_state.cuh"

// Mirrors kernels/jrl_sharded.py::ShTilePlan (a TilePlan): row bands of
// sub-step j, column strips, the largest tile's rows and columns (smax a
// multiple of 4), blocks.
struct ShTilePlan {
  int nty[jrl::TILE_KMAX];
  int ntx;
  int rmax, smax;
  int grid;
};

// Mirrors kernels/jrl_sharded.py::CPassShSrc: a shard's state, flags and
// pieces for a C pass. Row pieces are null on a mesh of one row.
struct CPassShSrc {
  const float* h;       // [9][h][w]
  const float* C;       // [h][w]: the balance's old C (null for the approach)
  const float* top;     // [P][2k][w] rows row0 - 2k .. row0 - 1 of the state group
  const float* bot;     // [P][2k][w] rows row0 + h .. row0 + h + 2k - 1
                        // (P = 10, h 0-8 and C 9, for the balance; 9 for the approach)
  const int* fl;        // [h][w]: the balance's flags, the approach's base flags
  const int* fl_top;    // [fl_rows][w] rows row0 - fl_rows .. row0 - 1
  const int* fl_bot;    // [fl_rows][w] rows row0 + h .. row0 + h + fl_rows - 1
  const float* frames;  // the approach's frame window [N][2][vrows][w] (a column
                        // shard: [N][2][vrows][vcols], CPassShCols)
};

// Mirrors kernels/jrl_sharded.py::CPassShCols: what a C pass of a column
// shard reads past its columns. The state group's blocks (halo.exchange's
// left and right with rows = 2k): [P][h + 4k][xh], the columns col0 - xh ..
// col0 - 1 and col0 + w .. col0 + w + xh - 1 (xh = sh_pass_xh(k)) of the rows
// row0 - 2k .. row0 + h + 2k - 1; the flags' blocks, exchanged once a run at
// its deepest pass: [h + 2 fl_rows][fl_xh], fl_xh >= xh; on a mesh of one
// row the blocks' rows d .. d + h - 1 hold the shard's rows (d = 2k, fl_rows).
// The approach's frame window holds lanes [col0 - vcol0, col0 - vcol0 +
// vcols) of the grid: the shard's and 2k reach lanes a side, cut to the grid.
struct CPassShCols {
  const float* left;
  const float* right;
  const int* fl_left;
  const int* fl_right;
  int fl_xh;
  int vcol0, vcols;
};

namespace jrl {

constexpr int SH_THREADS = 512;  // threads a block, one block an SM
// dynamic shared memory a block may take: the SM's 228 KB less the
// runtime's 1 KB a block and 1 KB for the static (the mbarrier)
constexpr int SH_SMEM_CAP = 233472 - 2048;

// Row bands of sub-step j, each read at a constant index: an index that
// varies at run time makes the compiler copy the launch's parameters to the
// stack.
__device__ __forceinline__ int sh_nty(const ShTilePlan& t, int j) {
  return j == 0 ? t.nty[0] : j == 1 ? t.nty[1] : j == 2 ? t.nty[2] : t.nty[3];
}

// Tile t of a sub-step of E extended rows: its cells on the extended rows
// [e0, e1) and the columns [sx0, sx1) (ends on multiples of 4); its window
// columns [cx0, cx1) (two a side cut to the grid, 16-byte ends).
struct ShTile {
  int e0, e1, sx0, sx1, cx0, cx1;
  __device__ ShTile(int t, int nty, int ntx, int E, int W) {
    const int ty = t / ntx, tx = t - ty * ntx;
    e0 = ty * E / nty;
    e1 = (ty + 1) * E / nty;
    sx0 = (tx * W / ntx) & ~3;
    sx1 = tx + 1 == ntx ? W : ((tx + 1) * W / ntx) & ~3;
    cx0 = max(sx0 - 2, 0) & ~3;
    cx1 = min((sx1 + 2 + 3) & ~3, W);
  }
  // the same over a column shard's lanes [X0, X1) of the sub-step: the
  // strips' inner ends on multiples of 4, the outer ones X0 and X1
  // (kernels/jrl_sharded.py::tile_strip)
  __device__ ShTile(int t, int nty, int ntx, int E, int X0, int X1, int W) {
    const int ty = t / ntx, tx = t - ty * ntx, L = X1 - X0;
    e0 = ty * E / nty;
    e1 = (ty + 1) * E / nty;
    sx0 = tx == 0 ? X0 : (X0 + tx * L / ntx) & ~3;
    sx1 = tx + 1 == ntx ? X1 : (X0 + (tx + 1) * L / ntx) & ~3;
    cx0 = max(sx0 - 2, 0) & ~3;
    cx1 = min((sx1 + 2 + 3) & ~3, W);
  }
};

// The B lanes [X0, X1) of sub-step j of a k-step pass of a column shard:
// its columns extended by 2 (k - 1 - j) a side, cut to the grid (the x
// edges reflect: nothing reads past them).
__host__ __device__ __forceinline__ void sh_lanes(const ShardGeom& s, int k, int j, int& X0,
                                                  int& X1) {
  const int e = 2 * (k - 1 - j);
  X0 = s.col0 - e > 0 ? s.col0 - e : 0;
  X1 = s.col0 + s.w + e < s.W ? s.col0 + s.w + e : s.W;
}

// The column blocks' lanes of a k-step pass of a column shard: 2k rounded
// up to a multiple of 4, so that every block row is whole 16-byte words
// (and holds the first sub-step's window, 2k lanes rounded out to 16 bytes).
__host__ __device__ __forceinline__ int sh_pass_xh(int k) { return 4 * ((2 * k + 3) / 4); }

// orders generic-proxy writes to global memory that this thread has seen
// (the other blocks' scratch rows, after grid.sync) before its async-proxy
// reads of them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Blocks of `Kernel` (SH_THREADS threads) that fit on the current device at
// once with `bytes` of dynamic shared memory: one occupancy query per device
// and tile size (a runner keeps its plan, so one a run), not one a launch.
template <auto Kernel>
int sh_coresident(int bytes, int* out) {
  // per device: the bytes asked last (high word) and the blocks (low word)
  static std::atomic<long long> seen[JRL_MAX_DEVICES] = {};
  *out = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool cached = dev >= 0 && dev < JRL_MAX_DEVICES;
  if (cached) {
    const long long v = seen[dev].load(std::memory_order_relaxed);
    if ((int)(v >> 32) == bytes) {
      *out = (int)(v & 0xffffffff);
      return (int)cudaSuccess;
    }
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = (cudaError_t)smem_attr_once<Kernel>(SH_SMEM_CAP);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, SH_THREADS, bytes);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  if (cached) seen[dev].store(((long long)bytes << 32) | *out, std::memory_order_relaxed);
  return (int)cudaSuccess;
}

// The checks of a pass's arguments on the host, cudaErrorInvalidValue or
// 0: a shard of a row mesh, 2k rows within it where the mesh has more than
// one row (the pieces' depth), the plan's tiles within the sub-steps' rows,
// the scratch buffers the depth needs. With `cols`, a shard of a column
// mesh too: 2k lanes within it, w % 4 == 0, 4k < W, blocks of
// sh_pass_xh(k) lanes, the strips of every sub-step's lanes (sh_lanes)
// within smax columns.
inline int sh_plan_check(const ShardGeom& s, int k, const ShTilePlan& t, const float* scr0,
                         const float* scr1, bool cols = false) {
  const int bad = (int)cudaErrorInvalidValue;
  const bool col_shard = s.w != s.W;
  if (k < 1 || k > TILE_KMAX || s.W % 4 || 4 * k >= s.H || (s.h < s.H && 2 * k > s.h))
    return bad;
  if (!col_shard && (s.col0 != 0 || s.xh != 0)) return bad;
  if (col_shard && (!cols || s.w % 4 || s.col0 % 4 || s.col0 < 0 || s.col0 + s.w > s.W ||
                    2 * k > s.w || 4 * k >= s.W || s.xh != sh_pass_xh(k)))
    return bad;
  int X0, X1;
  sh_lanes(s, k, k - 1, X0, X1);
  if (t.ntx < 1 || t.ntx > (X1 - X0) / 4 || t.rmax < 1 || t.rmax + 5 > s.H || t.smax < 4 ||
      t.smax % 4 || (k >= 2 && !scr0) || (k >= 3 && !scr1))
    return bad;
  for (int j = 0; j < k; ++j) {
    const int E = s.h == s.H ? s.H : s.h + 4 * (k - 1 - j);
    if (t.nty[j] < 1 || t.nty[j] > E || (E + t.nty[j] - 1) / t.nty[j] > t.rmax) return bad;
    sh_lanes(s, k, j, X0, X1);
    for (int tx = 0, L = X1 - X0; col_shard && tx < t.ntx; ++tx) {
      const int a = tx == 0 ? X0 : (X0 + tx * L / t.ntx) & ~3;
      const int b = tx + 1 == t.ntx ? X1 : (X0 + (tx + 1) * L / t.ntx) & ~3;
      if (b - a > t.smax) return bad;
    }
  }
  return 0;
}

// sh_plan_check on its column path, and a C pass's pieces where the mesh
// has more than one row: 2k rows of the state, at least 2k of the flags; a
// column shard's blocks (`cols`): the state's of sh_pass_xh(k) lanes
// (s.xh), the flags' of at least as many (a multiple of 4) and at least 2k
// rows, the frame window's lanes for the approach (`frames`).
inline int c_pass_check(const ShardGeom& s, int k, const ShTilePlan& t, const CPassShSrc& src,
                        int fl_rows, const float* scr0, const float* scr1,
                        const CPassShCols* cols = nullptr, bool frames = false) {
  const int bad = (int)cudaErrorInvalidValue;
  const int err = sh_plan_check(s, k, t, scr0, scr1, true);
  if (err) return err;
  if (s.h < s.H && (!src.top || !src.bot || !src.fl_top || !src.fl_bot || fl_rows < 2 * k))
    return bad;
  if (s.w == s.W) return 0;
  if (!cols || !cols->left || !cols->right || !cols->fl_left || !cols->fl_right ||
      cols->fl_xh < s.xh || cols->fl_xh % 4 || fl_rows < 2 * k)
    return bad;
  if (frames) {  // the shard's lanes and 2k a side, cut to the grid
    const int x0 = s.col0 > 2 * k ? s.col0 - 2 * k : 0;
    const int x1 = s.col0 + s.w + 2 * k < s.W ? s.col0 + s.w + 2 * k : s.W;
    if (s.col0 - cols->vcol0 < 0 || s.col0 - cols->vcol0 > x0 ||
        s.col0 - cols->vcol0 + cols->vcols < x1 || s.col0 - cols->vcol0 + cols->vcols > s.W)
      return bad;
  }
  return 0;
}

// Shard row r of plane q of a [P][h][w] body with d-row pieces top, bot
// ([P][d][w]): a body row, or a row of a piece; on a mesh of one row the
// body row r mod h.
template <class T>
__device__ __forceinline__ const T* sh_row(const T* body, const T* top, const T* bot,
                                           const ShardGeom& s, int d, int q, int r) {
  if (s.h == s.H || (r >= 0 && r < s.h)) return body + ((size_t)q * s.h + wrap1(r, s.h)) * s.w;
  if (r < 0) return top + ((size_t)q * d + r + d) * s.w;
  return bot + ((size_t)q * d + r - s.h) * s.w;
}

// Bytes a C tile's window copy brings: np planes of wr rows of ncols words,
// and the wrap column's four words a row when the strip ends at column W.
__device__ __forceinline__ uint32_t c_window_bytes(int np, int wr, int ncols, bool wrap) {
  return 4u * (uint32_t)(np * wr * (ncols + (wrap ? 4 : 0)));
}

// Copies a tile's window, rows i = 0 .. wr - 1 (shard row r0 + i, row_of(q,
// r) the row of plane q) and columns [cx0, cx0 + ncols), of np planes into
// the words at shared address `in` ([np][wp][rs]), one cp.async.bulk a plane
// row and thread, counted on mbarrier `bar`; with `wrap` (the strip ends at
// the grid's last column) columns 0 .. 3 land at window column ncols too: a
// FLUID cell of column W - 1 pulls from column 0, as the whole-grid step
// does.
template <class RowOf>
__device__ __forceinline__ void c_copy_window(uint32_t in, int np, int wp, int rs, int wr, int r0,
                                              int cx0, int ncols, bool wrap, const RowOf& row_of,
                                              uint32_t bar) {
  for (int n = threadIdx.x; n < np * wr; n += blockDim.x) {
    const int q = n / wr, i = n - q * wr;
    const char* const row = static_cast<const char*>(row_of(q, r0 + i));
    const uint32_t dst = in + 4u * (uint32_t)((q * wp + i) * rs);
    fence_proxy_async();         // the block's reads of the tables before the copy
    fence_proxy_async_global();  // the scratch rows written before grid.sync
    bulk_g2s(dst, row + 4 * cx0, 4u * (uint32_t)ncols, bar);
    if (wrap) bulk_g2s(dst + 4u * (uint32_t)ncols, row, 16u, bar);
  }
}

// A column shard's row r of a block of `lanes` lanes whose row 0 is shard
// row -d (a mesh of one row: rows d .. d + h - 1 hold the shard's rows, row
// r at d + r mod h).
__device__ __forceinline__ int c_block_row(const ShardGeom& s, int d, int r) {
  return (s.h == s.H ? wrap1(r, s.h) : r) + d;
}

// Columns [cx0, cx1) of one window row of a column shard (16-byte ends) into
// the shared words at `dst`: the left block's lanes, the body or piece row
// `row` (shard column 0 at row[0]), the right block's lanes; `boff` the row's
// offset in blocks of `lanes` lanes. Each copy a multiple of 16 bytes,
// counted on `bar` (the row's 4 (cx1 - cx0) bytes in all).
template <class T>
__device__ __forceinline__ void c_copy_cols(uint32_t dst, const T* row, const T* left,
                                            const T* right, size_t boff, int lanes,
                                            const ShardGeom& s, int cx0, int cx1,
                                            uint32_t bar) {
  const int c0 = s.col0, c1 = s.col0 + s.w;
  if (cx0 < c0)
    bulk_g2s(dst, left + boff + (cx0 - (c0 - lanes)), 4u * (uint32_t)(min(cx1, c0) - cx0), bar);
  const int m0 = max(cx0, c0), m1 = min(cx1, c1);
  if (m0 < m1)
    bulk_g2s(dst + 4u * (uint32_t)(m0 - cx0), row + (m0 - c0), 4u * (uint32_t)(m1 - m0), bar);
  if (cx1 > c1) {
    const int x0 = max(cx0, c1);
    bulk_g2s(dst + 4u * (uint32_t)(x0 - cx0), right + boff + (x0 - c1),
             4u * (uint32_t)(cx1 - x0), bar);
  }
}

// A column shard's base flag at shard row r (-fl_rows <= r < h + fl_rows)
// and global column x (within the flag blocks' lanes).
__device__ __forceinline__ int c_col_flag(const CPassShSrc& src, const CPassShCols& cols,
                                          const ShardGeom& s, int fl_rows, int r, int x) {
  const int lx = x - s.col0;
  if (lx >= 0 && lx < s.w) return sh_row<int>(src.fl, src.fl_top, src.fl_bot, s, fl_rows, 0, r)[lx];
  const size_t b = (size_t)c_block_row(s, fl_rows, r) * cols.fl_xh;
  return lx < 0 ? cols.fl_left[b + lx + cols.fl_xh] : cols.fl_right[b + lx - s.w];
}

// The shard row of global row y for a read at most `reach` rows past the
// shard (its window's copy of the row; on a mesh of one row y itself).
__device__ __forceinline__ int c_shard_row(const ShardGeom& s, int reach, int y) {
  int r = y - s.row0;
  if (s.h != s.H) {
    if (r >= s.h + reach) r -= s.H;
    if (r < -reach) r += s.H;
  }
  return r;
}

// The state around a cell of a tile's window (h planes of wp rows of rs
// words): window row i, column c (global column cx0 + c; the wrap column
// follows the last one).
struct CTileIn {
  const float* in;
  int rs, wp, i, c;
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return in[(q * wp + i + dy) * rs + c + dx];
  }
  __device__ __forceinline__ CTileIn at(int dy, int dx) const {
    return CTileIn{in, rs, wp, i + dy, c + dx};
  }
};

// A window table's word of global cell (y, x): rows in order from global row
// ybase (mod H), columns from cx0, column x < cx0 at the wrap column W - cx0
// + x (only columns 0 .. 3 of the last strip are read so).
struct CWin {
  int H, W, ybase, rs, cx0;
  __device__ __forceinline__ int at(int y, int x) const {
    int j = y - ybase;
    j += j < 0 ? H : 0;
    int c = x - cx0;
    c += c < 0 ? W : 0;
    return j * rs + c;
  }
};

// Flags read from a window table: the flag source of BalanceGeoT.
struct CWinFlags {
  const int* codes;
  CWin win;
  __device__ __forceinline__ int at(int y, int x) const { return codes[win.at(y, x)]; }
};

// One base flag, set before each use: the flag source of the approach's
// geometry while its window table is filled (ApproachGeo::flag_at).
struct OneFlag {
  int v;
  __device__ __forceinline__ int at(int, int) const { return v; }
};

// The stored velocity of a step from a shard's frame window (FrameVel's
// planes of vrows x W; shard row r at row r + vrow0, on a mesh of one row
// row r mod H), read at a global linear index y * W + x (ApproachGeo's
// velocity interface) or at a shard row.
struct PassVel {
  FrameVel fv;
  int H, W, row0, h, vrow0;
  bool whole;
  __device__ __forceinline__ int idx_r(int r, int x) const {
    return (whole ? wrap1(r, H) : r + vrow0) * W + x;
  }
  __device__ __forceinline__ int idx(int i) const {
    const int gy = i / W, x = i - gy * W;
    int r = gy - row0;
    if (!whole) {  // the window's copy of the row
      if (r >= h + vrow0) r -= H;
      if (r < -vrow0) r += H;
    }
    return idx_r(r, x);
  }
  __device__ float u(int i) const { return fv.u(idx(i)); }
  __device__ float v(int i) const { return fv.v(idx(i)); }
};

// PassVel of a column shard: the frame window's planes of vrows x vcols,
// global column x at lane x + vx.
struct PassVelCols {
  FrameVel fv;
  ShardGeom s;
  int vrow0, vcols, vx;
  __device__ __forceinline__ int idx_r(int r, int x) const {
    return (s.h == s.H ? wrap1(r, s.H) : r + vrow0) * vcols + x + vx;
  }
  __device__ __forceinline__ int idx(int i) const {
    const int gy = i / s.W, x = i - gy * s.W;
    return idx_r(c_shard_row(s, vrow0, gy), x);
  }
  __device__ float u(int i) const { return fv.u(idx(i)); }
  __device__ float v(int i) const { return fv.v(idx(i)); }
};

// The base flags of a column shard at global (y, x) (c_col_flag): the flag
// source of ApproachGeo for the disk's recompute of a new C past the shard.
// Copies, not pointers, of the launch's structures: the address of a kernel
// parameter would make the compiler copy it to the stack.
struct CColFlags {
  CPassShSrc src;
  CPassShCols cols;
  ShardGeom s;
  int fl_rows;
  __device__ __forceinline__ int at(int y, int x) const {
    return c_col_flag(src, cols, s, fl_rows, c_shard_row(s, fl_rows, y), x);
  }
};

// The approach's moving tip at one step read from a tile's window tables
// (the flag and phi of each window cell, computed once a cell and sub-step
// by ApproachGeo's own flag_at and phi): every other answer is
// ApproachGeo's, as in jrl_c.cuh::WindowGeo.
template <class V>
struct CTileGeo : ApproachGeo<V, OneFlag> {
  const int* codes;
  const float* phis;
  CWin win;
  __device__ int flag(int y, int x) const { return codes[win.at(y, x)]; }
  __device__ float phi(int y, int x) const { return phis[win.at(y, x)]; }
};

}  // namespace jrl

// A k-step pass (k = 1..4) of one shard of a row mesh in one cooperative
// launch: the launch form of fluid_pass_sh.cu, shared with the C phases'
// passes (c_balance_pass_sh.cu, c_approach_pass_sh.cu). One persistent grid
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
// their sources, the window copy (with the wrap column) and the window's
// accessors.
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
  const float* frames;  // the approach's frame window [N][2][vrows][w]
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
};

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
// the scratch buffers the depth needs.
inline int sh_plan_check(const ShardGeom& s, int k, const ShTilePlan& t, const float* scr0,
                         const float* scr1) {
  const int bad = (int)cudaErrorInvalidValue;
  if (k < 1 || k > TILE_KMAX || s.W % 4 || s.w != s.W || s.col0 != 0 || s.xh != 0 ||
      4 * k >= s.H || (s.h < s.H && 2 * k > s.h))
    return bad;
  if (t.ntx < 1 || t.ntx > s.W / 4 || t.rmax < 1 || t.rmax + 5 > s.H || t.smax < 4 ||
      t.smax % 4 || (k >= 2 && !scr0) || (k >= 3 && !scr1))
    return bad;
  for (int j = 0; j < k; ++j) {
    const int E = s.h == s.H ? s.H : s.h + 4 * (k - 1 - j);
    if (t.nty[j] < 1 || t.nty[j] > E || (E + t.nty[j] - 1) / t.nty[j] > t.rmax) return bad;
  }
  return 0;
}

// sh_plan_check, and a C pass's pieces where the mesh has more than one
// row: 2k rows of the state, at least 2k of the flags.
inline int c_pass_check(const ShardGeom& s, int k, const ShTilePlan& t, const CPassShSrc& src,
                        int fl_rows, const float* scr0, const float* scr1) {
  const int err = sh_plan_check(s, k, t, scr0, scr1);
  if (err) return err;
  if (s.h < s.H && (!src.top || !src.bot || !src.fl_top || !src.fl_bot || fl_rows < 2 * k))
    return (int)cudaErrorInvalidValue;
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

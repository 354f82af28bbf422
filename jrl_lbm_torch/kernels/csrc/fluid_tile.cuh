// One JRL fluid step (A then B) on one tile of shared memory: the tile
// form of fluid_pass_sh.cu (a sub-step of a shard's k-step pass) and of
// fused_fluid_tl.cu (a step of n steps of the whole grid). A tile of R x S
// B cells:
// - copies its window, rows -2 .. R + 1 and columns [cx0, cx1) (two a side
//   cut to the grid and rounded out to 16 bytes, pass_sh.cuh::ShTile), of
//   12 planes (f 0-8, rho 9, u 10, v 11; the lean class: f alone) by
//   cp.async.bulk counted on one mbarrier, one plane row a thread, from the
//   rows the caller names (row_of(q, i): plane q of window row i), or by
//   the caller's copy of a window row (copy_row: the window of a column
//   shard's first sub-step lies in three sources);
// - the full class's geometry (flag with the tip bit, phi) of every window
//   cell at the step, once, into a table (TileGeo);
// - A on (R + 2) x (S + 2) cells (rows -1 .. R, columns one past the
//   strip inside the grid): rho, u, v into a window-shaped table, f into a
//   table of the R x S B cells (B reads f at its own cell only); then one
//   __syncthreads and B on R x S, threads on consecutive columns, each B
//   cell handed to the caller (store(bi, x, f, rho, u, v): B row bi,
//   column x).
// The cell code is jrl_fluid.cuh's, unchanged (with --fmad=false), read
// through the tile accessors, so every cell rounds as the whole-grid
// kernels' do. Reach: A reads one cell away, except an OUTFLOW cell of row
// 0, which recomputes row 1's streaming and reads two rows up; on the
// window's last A row that lands one row past the copied window (a padding
// row of the tables), where the window wraps past H: only the top wall
// row's B reads that A, and an OBSTACLE cell's B reads nothing around it.
// Every other read of a real cell stays in the window. The x edges reflect
// (jrl_common.cuh::at_dx): nothing reads past them.
//
// Timing probes (wrong results or none of the table's saving, never a
// route): -DJRL_FPT_NO_CELLS (A and B copy their cell), -DJRL_FPT_NO_GEO (no
// geometry table), -DJRL_FPT_SDF (the full class's geometry from FluidGeo
// at every query, the tip SDF evaluated each time, instead of the table:
// the same values).
#pragma once

#include <cstddef>
#include <type_traits>

#include "pass_sh.cuh"

namespace jrl {

// A tile's tables, in floats from the start of the dynamic shared memory
// (every row of RS = smax + 8 floats, WP = rmax + 5 rows: the window's
// rmax + 4 and the padding row): the input [12][WP][RS], A's rho, u, v
// [3][WP][RS], phi [WP][RS], A's f of the B cells [9][rmax][smax], then
// the geometry codes [WP][RS] bytes.
struct FptLayout {
  int rs, wp, rmax, smax;
  __host__ __device__ FptLayout(int rmax_, int smax_)
      : rs(smax_ + 8), wp(rmax_ + 5), rmax(rmax_), smax(smax_) {}
  __host__ __device__ int rv() const { return PASS_NP * wp * rs; }
  __host__ __device__ int phi() const { return rv() + 3 * wp * rs; }
  __host__ __device__ int fa() const { return phi() + wp * rs; }
  __host__ __device__ int codes_bytes() const { return 4 * (fa() + 9 * rmax * smax); }
  __host__ __device__ int bytes() const { return codes_bytes() + wp * rs; }
};

// Step A's view of a tile's input around a cell: window row i, column c
// (planes f 0-8, rho 9, u 10, v 11 of WP rows each).
struct TileIn {
  const float* in;
  int rs, wp, i, c;
  __device__ __forceinline__ int idx(int q, int dy, int dx) const {
    return (q * wp + i + dy) * rs + c + dx;
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const { return in[idx(q, dy, dx)]; }
  __device__ __forceinline__ float R(int dy, int dx) const { return in[idx(9, dy, dx)]; }
  __device__ __forceinline__ float U(int dy, int dx) const { return in[idx(10, dy, dx)]; }
  __device__ __forceinline__ float V(int dy, int dx) const { return in[idx(11, dy, dx)]; }
  __device__ __forceinline__ TileIn at(int dy, int dx) const {
    return TileIn{in, rs, wp, i + dy, c + dx};
  }
};

// Step B's view: A's f of the cell (`fa` positioned at it, planes `fstride`
// apart), A's rho, u, v around it from their window-shaped table.
struct TileB {
  const float* rv;
  const float* fa;
  int rs, wp, fstride, i, c;
  __device__ __forceinline__ int idx(int p, int dy, int dx) const {
    return (p * wp + i + dy) * rs + c + dx;
  }
  __device__ __forceinline__ float F(int q, int, int) const { return fa[q * fstride]; }
  __device__ __forceinline__ float R(int dy, int dx) const { return rv[idx(0, dy, dx)]; }
  __device__ __forceinline__ float U(int dy, int dx) const { return rv[idx(1, dy, dx)]; }
  __device__ __forceinline__ float V(int dy, int dx) const { return rv[idx(2, dy, dx)]; }
};

// The moving tip at one step, read from a tile's geometry table (RingGeo's
// values, the window rows in order from global row ybase, mod H).
struct TileGeo {
  int H, W, ybase, rs, cx0;
  bool flat;
  float vel_obs;
  const float* phis;
  const unsigned char* codes;
  __device__ __forceinline__ int at(int y, int x) const {
    int j = y - ybase;
    j += j < 0 ? H : 0;
    return j * rs + x - cx0;
  }
  __device__ __forceinline__ int flag(int y, int x) const { return codes[at(y, x)] & 0x7f; }
  __device__ __forceinline__ bool tip(int y, int x) const { return codes[at(y, x)] >> 7; }
  __device__ __forceinline__ float phi(int y, int x) const { return phis[at(y, x)]; }
  __device__ __forceinline__ float obs_v(int y, int x) const {
    return (tip(y, x) && (flat || y != H - 1)) ? vel_obs : 0.0f;
  }
  __device__ __forceinline__ float u(int y, int x, float raw) const {
    return tip(y, x) ? 0.0f : raw;
  }
  __device__ __forceinline__ float v(int y, int x, float raw) const {
    return tip(y, x) ? obs_v(y, x) : raw;
  }
  __device__ void inflow(int, int, int, float*) const {}
};

// The step on tile `tl` of a block of SH_THREADS threads: its B rows begin
// at window row 2, window row 0 being global row ybase (mod H); `fg` the
// step's geometry (unread by the lean class); tables of tiles of at most
// rmax x smax B cells in `smem`; `bar_a` the block's mbarrier, whose phase
// `parity` the tile flips. With a `copy_row`, copy_row(q, i, dst) copies
// the window's columns [cx0, cx1) of plane q's window row i to the shared
// words at `dst` in place of row_of's one copy (its bytes counted on
// `bar_a`, after fence_proxy_async and, where it reads what other blocks
// wrote, fence_proxy_async_global).
template <bool LEAN, class RowOf, class Store, class CopyRow = std::nullptr_t>
__device__ __forceinline__ void fluid_tile(const ShTile& tl, int ybase, const FluidGeo& fg,
                                           const FluidParams& pa, const FluidBParams& pb,
                                           int rmax, int smax, float* smem, uint32_t bar_a,
                                           uint32_t& parity, const RowOf& row_of,
                                           const Store& store, const CopyRow& copy_row = {}) {
  constexpr int NPL = LEAN ? 9 : PASS_NP;  // planes of a window row
  const int H = pa.H, W = pa.W, tid = threadIdx.x;
  const FptLayout lay(rmax, smax);
  const int RS = lay.rs, WP = lay.wp;
  float* const in = smem;
  float* const rv = smem + lay.rv();
  float* const phis = smem + lay.phi();
  float* const fa = smem + lay.fa();
  unsigned char* const codes = reinterpret_cast<unsigned char*>(smem) + lay.codes_bytes();
  const int R = tl.e1 - tl.e0, S = tl.sx1 - tl.sx0, ncols = tl.cx1 - tl.cx0;
  const int wr = R + 4;
  if (R < 1 || R > rmax || S < 1 || S > smax || ncols > RS) __trap();
  // the window's rows, a copy a plane row, one a thread; the barrier
  // orders the expected bytes before every copy and the tile before's
  // reads of the tables before this tile's writes
  if (tid == 0) mbar_expect(bar_a, 4u * (uint32_t)(ncols * NPL * wr));
  __syncthreads();
  for (int n = tid; n < NPL * wr; n += SH_THREADS) {
    const int q = n / wr, i = n - q * wr;
    if constexpr (std::is_same_v<CopyRow, std::nullptr_t>) {
      const float* const row = row_of(q, i);
      fence_proxy_async();         // the block's reads of the tables before the copy
      fence_proxy_async_global();  // the rows other blocks wrote before grid.sync
      bulk_g2s(smem_addr(in + (q * WP + i) * RS), row + tl.cx0, 4u * (uint32_t)ncols, bar_a);
    } else {
      copy_row(q, i, in + (q * WP + i) * RS);
    }
  }
  // the tip's values once per window cell and its padding row
#if !defined(JRL_FPT_NO_GEO) && !defined(JRL_FPT_SDF)
  if (!LEAN)
    for (int n = tid; n < (wr + 1) * ncols; n += SH_THREADS) {
      const int i = n / ncols, c = n - i * ncols;
      codes[i * RS + c] = geo_code(fg, wrap1(ybase + i, H), tl.cx0 + c, phis[i * RS + c]);
    }
#endif
  __syncthreads();
  mbar_wait(bar_a, parity);
  parity ^= 1;
  const auto geo = [&] {
    if constexpr (LEAN) {
      return LeanGeo{H, W};
    } else {
#ifdef JRL_FPT_SDF
      return fg;
#else
      return TileGeo{H, W, ybase, RS, tl.cx0, fg.flat, fg.vel_obs, phis, codes};
#endif
    }
  }();
  // A on rows -1 .. R and one column past the strip
  const int ax0 = max(tl.sx0 - 1, 0), acols = min(tl.sx1 + 1, W) - ax0;
#pragma unroll 1
  for (int n = tid; n < (R + 2) * acols; n += SH_THREADS) {
    const int ia = n / acols, x = ax0 + n - ia * acols, i = ia + 1, c = x - tl.cx0;
    float fo[9], r, u, v;
#ifdef JRL_FPT_NO_CELLS
    const TileIn a{in, RS, WP, i, c};
    for (int q = 0; q < 9; ++q) fo[q] = a.F(q, 0, 0);
    r = a.R(0, 0), u = a.U(0, 0), v = a.V(0, 0);
#else
    fluid_a_cell(TileIn{in, RS, WP, i, c}, geo, pa.cs2tau, wrap1(ybase + i, H), x, fo, r, u, v);
#endif
    rv[i * RS + c] = r;
    rv[(WP + i) * RS + c] = u;
    rv[(2 * WP + i) * RS + c] = v;
    const int bi = i - 2, bc = x - tl.sx0;
    if (bi >= 0 && bi < R && bc >= 0 && bc < S) {
#pragma unroll
      for (int q = 0; q < 9; ++q) fa[(q * rmax + bi) * smax + bc] = fo[q];
    }
  }
  __syncthreads();
  // B on the tile's cells
#pragma unroll 1
  for (int n = tid; n < R * S; n += SH_THREADS) {
    const int bi = n / S, bc = n - bi * S, x = tl.sx0 + bc, i = bi + 2, c = x - tl.cx0;
    float fo[9];
#ifdef JRL_FPT_NO_CELLS
    for (int q = 0; q < 9; ++q) fo[q] = fa[(q * rmax + bi) * smax + bc];
#else
    fluid_b_cell(TileB{rv, fa + bi * smax + bc, RS, WP, rmax * smax, i, c}, geo, pb,
                 wrap1(ybase + i, H), x, fo);
#endif
    store(bi, x, fo, rv[i * RS + c], rv[(WP + i) * RS + c], rv[(2 * WP + i) * RS + c]);
  }
}

// The block's mbarrier, initialised and made visible to the async proxy
// before the first tile's copies.
__device__ __forceinline__ uint32_t fluid_tile_bar(uint64_t* bar) {
  const uint32_t bar_a = smem_addr(bar);
  if (threadIdx.x == 0) {
    mbar_init(bar_a);
    mbar_init_fence();
    fence_proxy_async();  // the initialised mbarrier visible to the async proxy
  }
  __syncthreads();
  return bar_a;
}

// Kernels of the tile form stop (an error, not wrong cells) where the
// host's plan outgrows the dynamic shared memory of the launch.
__device__ __forceinline__ void fluid_tile_smem_check(int rmax, int smax) {
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)FptLayout(rmax, smax).bytes() > dyn) __trap();
}

}  // namespace jrl

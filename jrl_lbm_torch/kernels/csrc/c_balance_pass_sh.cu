// JRL concentration balance on one shard of a mesh: a k-step pass (k =
// 1..4) in one cooperative launch (pass_sh.cuh): sub-step j over the
// shard's rows (and on a column mesh its lanes) extended by 2 (k - 1 - j) a
// side in one wave of tiles, a grid barrier between sub-steps, h and C
// between them in two scratch buffers.
//
// Replaces k launches of c_balance_sh.cu (the TPU kernel jrl_lbm_tpu/ops/
// pallas/fused_jrl_sharded.py::_step_balance, one step a launch) and the k
// exchanges of its h pieces: one exchange of the 2k-row pieces of [h, C] a
// pass (an OBSTACLE cell keeps its old C, so the extended rows need C too),
// the fixed flags' pieces once a run. c_balance_sh stays, as the yardstick
// (route="launches"). Plain twin: kernels/
// jrl_sharded.py::c_balance_pass_sh_ref. The cell code is jrl_c.cuh's
// balance_cell_flags and balance_cell_at, unchanged (with --fmad=false), on
// the values the whole-grid step reads, so a pass equals k launches of
// c_balance_sh (and of c_balance) bit for bit.
//
// Reach. A cell reads one row and column away, an OUTFLOW cell of global
// row 0 or H - 1 two rows inward (it copies the streaming of the cell next
// to it), an OUTFLOW cell of column W - 1 two columns inward, and the ring
// of shards carries the extended rows across the row edge: 2 rows a step,
// so 2k-row pieces, as the fluid pass.
//
// Bound on the card: the bytes (the shard's h, C and flags read once, h
// and C written once, the pieces; 3.4 us a pass of a 256x512 shard at 3.35
// TB/s whatever k), the cell code ~230 float32 operations a cell and step
// (1.8 us a k = 4 pass at 67 TFLOP/s). What held c_balance_sh (8.4 us a step of that shard
// against its 3.3 us bound) back, and what the pass does about it:
// - a launch and an exchange of h a step, each a host call per shard: one
//   of each a shard and k-step pass;
// - every read decoded by the shard accessor (body, row piece or column
//   block per value): each window row's source chosen once and copied by
//   cp.async.bulk into the tile's tables, the flags as a tenth plane;
// - the per-direction rates (three IEEE divisions) a cell: once a column
//   of the tile; the flags' decode (the cell's source, its flag, the
//   obstacle mask of nine flags) from the tile's flag table.
//
// A tile of R x S cells copies its window, rows -2 .. R + 1 and columns
// [sx0 - 2, sx1 + 2) cut to the grid and rounded out to 16 bytes (and
// columns 0 .. 3 after the last one where the strip ends at W), of h and
// the flags; sub-step 0 from the body and the pieces, sub-step j > 0 h from
// the scratch j - 1 wrote. Each cell then runs balance_cell_flags on the
// flag table and balance_cell_at on the h table, its old C read where it
// lies (body, piece or scratch) when it is OBSTACLE, and writes h and C to
// the scratch (the last sub-step: h_out, C_out).
//
// A shard of a column mesh (c_balance_pass_sh_cols) has the x window of
// fluid_pass_sh_cols: sub-step j's lanes are the shard's columns extended
// by 2 (k - 1 - j) a side and cut to the grid (pass_sh.cuh::sh_lanes); the
// lanes past the shard come from halo.exchange's column blocks of [h, C]
// (sh_pass_xh(k) lanes of the rows row0 - 2k .. row0 + h + 2k - 1, corners
// included) and from the flags' blocks (exchanged once a run); a window
// row of h at sub-step 0, and of the flags at every sub-step, is up to three
// bulk copies (left block, body or piece row, right block), a row of h
// later one copy of a scratch row of w + 2 xh lanes; an OBSTACLE cell past
// the shard reads its old C in the block at sub-step 0. The strips stop at
// the grid's last column, so no wrap column: a FLUID cell of column W - 1
// would pull from column 0, which a column shard's later sub-steps do not
// hold, and the host refuses such flags (the model puts INFLOW_2 or OUTFLOW
// there; kernels/jrl_sharded.py::check_edge_flags).
#include "pass_sh.cuh"

// Mirrors kernels/jrl_sharded.py::CBalancePassShParams.
struct CBalancePassShParams {
  CBalanceParams p;
  ShardGeom s;     // the shard's place (a column shard: xh = sh_pass_xh(k))
  ShTilePlan t;
  int fl_rows;     // rows of each flag piece or a block's past the shard (at least 2k; 0 on
                   // a mesh of one row and one column)
};

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

// A tile's tables, in words from the start of the dynamic shared memory
// (rows of RS = smax + 8 words, WP = rmax + 4 window rows): the window's h
// and flags [10][WP][RS], then the column rates [smax] (BalanceRates, 9
// floats each). Mirrored by kernels/jrl_sharded.py::c_tile_smem_bytes.
struct CbLayout {
  int rs, wp, smax;
  __host__ __device__ CbLayout(int rmax, int smax_) : rs(smax_ + 8), wp(rmax + 4), smax(smax_) {}
  __host__ __device__ int rates() const { return 10 * wp * rs; }
  __host__ __device__ int bytes() const { return 4 * (rates() + 9 * smax); }
};

// The old C of a cell where it lies, read only where the cell is OBSTACLE
// (balance_cell_at's C[i]).
struct OldC {
  const float* p;
  __device__ __forceinline__ float operator[](int) const { return *p; }
};

template <int K>
__global__ void __launch_bounds__(SH_THREADS, 1) c_balance_pass_sh_tiles(
    CPassShSrc src, float* h_out, float* C_out, float* scr0, float* scr1,
    CBalancePassShParams pp) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const CbLayout lay(pp.t.rmax, pp.t.smax);
  // a launch whose plan the host got wrong stops (an error, not wrong
  // cells): its tables must fit the shared memory
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)lay.bytes() > dyn) __trap();
  const CBalanceParams& p = pp.p;
  const ShardGeom& s = pp.s;
  const int H = s.H, W = s.W, hw = s.h * s.w, tid = threadIdx.x;
  const bool whole = s.h == s.H;       // a mesh of one row
  const int soff = whole ? 0 : 2 * K;  // scratch row of shard row 0
  const int splane = (whole ? H : s.h + 4 * K) * W;  // words a scratch plane
  const int RS = lay.rs, WP = lay.wp;
  float* const in = smem;
  const int* const codes = reinterpret_cast<const int*>(smem + 9 * WP * RS);
  BalanceRates* const rates = reinterpret_cast<BalanceRates*>(smem + lay.rates());
  const uint32_t bar_a = smem_addr(&bar);
  if (tid == 0) {
    mbar_init(bar_a);
    mbar_init_fence();
    fence_proxy_async();  // the initialised mbarrier visible to the async proxy
  }
  __syncthreads();
  uint32_t parity = 0;
  cg::grid_group grid = cg::this_grid();
  // shard row r of the flags
  const auto fl_row = [&](int r) {
    return sh_row<int>(src.fl, src.fl_top, src.fl_bot, s, pp.fl_rows, 0, r);
  };

#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const int lvl = K - 1 - j;
    const int E = whole ? H : s.h + 4 * lvl;  // cell rows of the sub-step
    const int r_lo = whole ? 0 : -2 * lvl;    // shard row of extended row 0
    const float* const s_in = (j & 1) ? scr0 : scr1;  // what sub-step j - 1 wrote
    float* const s_out = (j & 1) ? scr1 : scr0;
    // shard row r of plane q (h 0-8, C 9) before sub-step j
    const auto state_row = [&](int q, int r) -> const float* {
      if (j > 0) return s_in + q * splane + (whole ? wrap1(r, H) : r + soff) * W;
      return q < 9 ? sh_row<float>(src.h, src.top, src.bot, s, 2 * K, q, r)
                   : (whole || (r >= 0 && r < s.h))
                         ? src.C + wrap1(r, s.h) * s.w
                         : sh_row<float>(nullptr, src.top, src.bot, s, 2 * K, 9, r);
    };
    const int nty = sh_nty(pp.t, j), ntiles = nty * pp.t.ntx;
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const ShTile tl(t, nty, pp.t.ntx, E, W);
      const int R = tl.e1 - tl.e0, S = tl.sx1 - tl.sx0, ncols = tl.cx1 - tl.cx0;
      const int rb0 = r_lo + tl.e0;                  // shard row of the first cell row
      const int ybase = wrap1(s.row0 + rb0 - 2, H);  // global row of window row 0
      const int wr = R + 4;
      const bool wrap = tl.cx1 == W;
      if (R < 1 || R > pp.t.rmax || S < 1 || S > pp.t.smax || ncols + (wrap ? 4 : 0) > RS)
        __trap();
      // the barrier orders the expected bytes before every copy and the tile
      // before's reads of the tables before this tile's writes
      if (tid == 0) mbar_expect(bar_a, c_window_bytes(10, wr, ncols, wrap));
      __syncthreads();
      c_copy_window(
          smem_addr(in), 10, WP, RS, wr, rb0 - 2, tl.cx0, ncols, wrap,
          [&](int q, int r) -> const void* {
            return q < 9 ? (const void*)state_row(q, r) : (const void*)fl_row(r);
          },
          bar_a);
      // the collision terms of the strip's columns, while the rows land
      for (int c = tid; c < S; c += SH_THREADS) rates[c] = balance_rates(tl.sx0 + c, p);
      __syncthreads();
      mbar_wait(bar_a, parity);
      parity ^= 1;
      const BalanceGeoT<CWinFlags> g{CWinFlags{codes, CWin{H, W, ybase, RS, tl.cx0}}};
#pragma unroll 1
      for (int n = tid; n < R * S; n += SH_THREADS) {
        const int bi = n / S, bc = n - bi * S, x = tl.sx0 + bc, i = bi + 2, c = x - tl.cx0;
        const int y = wrap1(ybase + i, H), rr = rb0 + bi;  // global row, shard row
        const BalanceCell cl = balance_cell_flags(g, H, W, y, x);
        const int sy = cl.src / W, sx = cl.src - sy * W;  // one cell from (y, x) at most
        const CTileIn a{in, RS, WP, i + (sy - y), c + (sx - x)};
        const OldC old{state_row(9, rr) + x};
        if (j < K - 1)
          balance_cell_at(a, old, g, cl, p, rates[bc], sy, sx, s_out, s_out + 9 * splane,
                          (whole ? rr : rr + soff) * W + x, splane);
        else
          balance_cell_at(a, old, g, cl, p, rates[bc], sy, sx, h_out, C_out, rr * s.w + x, hw);
      }
    }
    // sub-step j + 1 reads what every block wrote (a proxy fence before its
    // bulk copies, which read through the async proxy)
    if (j < K - 1) grid.sync();
  }
}

// The pass of a column shard at depth K: the row kernel above with sub-step
// j over the shard's lanes extended by 2 (k - 1 - j) a side too (sh_lanes),
// the lanes past the shard from `cols`: a window row of h at sub-step 0,
// and of the flags at every sub-step, from the left block, the body or
// piece row and the right block (c_copy_cols), a row of h later one copy of
// a scratch row of w + 2 xh lanes; no wrap column.
template <int K>
__global__ void __launch_bounds__(SH_THREADS, 1) c_balance_pass_sh_cols(
    CPassShSrc src, float* h_out, float* C_out, float* scr0, float* scr1,
    CBalancePassShParams pp, CPassShCols cols) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const CbLayout lay(pp.t.rmax, pp.t.smax);
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)lay.bytes() > dyn) __trap();
  const CBalanceParams& p = pp.p;
  const ShardGeom& s = pp.s;
  const int H = s.H, W = s.W, hw = s.h * s.w, tid = threadIdx.x;
  const bool whole = s.h == s.H;       // a mesh of one row
  const int soff = whole ? 0 : 2 * K;  // scratch row of shard row 0
  // a scratch row's words, and the scratch column of global column 0
  const int SW = s.w + 2 * s.xh, sx = s.xh - s.col0;
  const int splane = (whole ? H : s.h + 4 * K) * SW;  // words a scratch plane
  const int brows = s.h + 4 * K;                      // rows of a state block's plane
  const int RS = lay.rs, WP = lay.wp;
  float* const in = smem;
  const int* const codes = reinterpret_cast<const int*>(smem + 9 * WP * RS);
  BalanceRates* const rates = reinterpret_cast<BalanceRates*>(smem + lay.rates());
  const uint32_t bar_a = smem_addr(&bar);
  if (tid == 0) {
    mbar_init(bar_a);
    mbar_init_fence();
    fence_proxy_async();  // the initialised mbarrier visible to the async proxy
  }
  __syncthreads();
  uint32_t parity = 0;
  cg::grid_group grid = cg::this_grid();
  // shard row r of the flags
  const auto fl_row = [&](int r) {
    return sh_row<int>(src.fl, src.fl_top, src.fl_bot, s, pp.fl_rows, 0, r);
  };

#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const int lvl = K - 1 - j;
    const int E = whole ? H : s.h + 4 * lvl;  // cell rows of the sub-step
    const int r_lo = whole ? 0 : -2 * lvl;    // shard row of extended row 0
    const float* const s_in = (j & 1) ? scr0 : scr1;  // what sub-step j - 1 wrote
    float* const s_out = (j & 1) ? scr1 : scr0;
    // shard row r of plane q (h 0-8, C 9) before sub-step j: at j = 0 the
    // body or a piece (shard column 0 at [0]), at j > 0 the scratch (global
    // column 0 at [0])
    const auto state_row = [&](int q, int r) -> const float* {
      if (j > 0) return s_in + q * splane + (whole ? wrap1(r, H) : r + soff) * SW + sx;
      return q < 9 ? sh_row<float>(src.h, src.top, src.bot, s, 2 * K, q, r)
                   : (whole || (r >= 0 && r < s.h))
                         ? src.C + wrap1(r, s.h) * s.w
                         : sh_row<float>(nullptr, src.top, src.bot, s, 2 * K, 9, r);
    };
    int X0, X1;  // the sub-step's lanes
    sh_lanes(s, K, j, X0, X1);
    const int nty = sh_nty(pp.t, j), ntiles = nty * pp.t.ntx;
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const ShTile tl(t, nty, pp.t.ntx, E, X0, X1, W);
      const int R = tl.e1 - tl.e0, S = tl.sx1 - tl.sx0, ncols = tl.cx1 - tl.cx0;
      const int rb0 = r_lo + tl.e0;                  // shard row of the first cell row
      const int ybase = wrap1(s.row0 + rb0 - 2, H);  // global row of window row 0
      const int wr = R + 4;
      if (R < 1 || R > pp.t.rmax || S < 1 || S > pp.t.smax || ncols > RS) __trap();
      // the barrier orders the expected bytes before every copy and the tile
      // before's reads of the tables before this tile's writes
      if (tid == 0) mbar_expect(bar_a, c_window_bytes(10, wr, ncols, false));
      __syncthreads();
      for (int n = tid; n < 10 * wr; n += SH_THREADS) {
        const int q = n / wr, i = n - q * wr, r = rb0 - 2 + i;
        const uint32_t dst = smem_addr(in) + 4u * (uint32_t)((q * WP + i) * RS);
        fence_proxy_async();         // the block's reads of the tables before the copy
        fence_proxy_async_global();  // the scratch rows written before grid.sync
        if (q == 9)
          c_copy_cols<int>(dst, fl_row(r), cols.fl_left, cols.fl_right,
                           (size_t)c_block_row(s, pp.fl_rows, r) * cols.fl_xh, cols.fl_xh, s,
                           tl.cx0, tl.cx1, bar_a);
        else if (j > 0)
          bulk_g2s(dst, state_row(q, r) + tl.cx0, 4u * (uint32_t)ncols, bar_a);
        else
          c_copy_cols<float>(dst, state_row(q, r), cols.left, cols.right,
                             ((size_t)q * brows + c_block_row(s, 2 * K, r)) * s.xh, s.xh, s,
                             tl.cx0, tl.cx1, bar_a);
      }
      // the collision terms of the strip's columns, while the rows land
      for (int c = tid; c < S; c += SH_THREADS) rates[c] = balance_rates(tl.sx0 + c, p);
      __syncthreads();
      mbar_wait(bar_a, parity);
      parity ^= 1;
      const BalanceGeoT<CWinFlags> g{CWinFlags{codes, CWin{H, W, ybase, RS, tl.cx0}}};
#pragma unroll 1
      for (int n = tid; n < R * S; n += SH_THREADS) {
        const int bi = n / S, bc = n - bi * S, x = tl.sx0 + bc, i = bi + 2, c = x - tl.cx0;
        const int y = wrap1(ybase + i, H), rr = rb0 + bi;  // global row, shard row
        const BalanceCell cl = balance_cell_flags(g, H, W, y, x);
        const int sy = cl.src / W, sxs = cl.src - sy * W;  // one cell from (y, x) at most
        const CTileIn a{in, RS, WP, i + (sy - y), c + (sxs - x)};
        // the old C where it lies: the body, a piece or a block at j = 0
        const int lx = x - s.col0;
        const OldC old{j > 0 || (lx >= 0 && lx < s.w)
                           ? state_row(9, rr) + (j > 0 ? x : lx)
                           : (lx < 0 ? cols.left : cols.right) +
                                 ((size_t)9 * brows + c_block_row(s, 2 * K, rr)) * s.xh +
                                 (lx < 0 ? lx + s.xh : lx - s.w)};
        if (j < K - 1)
          balance_cell_at(a, old, g, cl, p, rates[bc], sy, sxs, s_out, s_out + 9 * splane,
                          (whole ? rr : rr + soff) * SW + x + sx, splane);
        else
          balance_cell_at(a, old, g, cl, p, rates[bc], sy, sxs, h_out, C_out, rr * s.w + lx, hw);
      }
    }
    // sub-step j + 1 reads what every block wrote (a proxy fence before its
    // bulk copies, which read through the async proxy)
    if (j < K - 1) grid.sync();
  }
}

}  // namespace

// Registers per thread and local (spill) bytes of the instance at depth k.
extern "C" int jrl_c_balance_pass_sh_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(c_balance_pass_sh_tiles<decltype(kc)::value>, regs, local_bytes);
  });
}

// The same of the column instance.
extern "C" int jrl_c_balance_pass_sh_cols_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(c_balance_pass_sh_cols<decltype(kc)::value>, regs, local_bytes);
  });
}

// The launch shape, which the host plan mirrors (kernels/jrl_sharded.py::
// pass_sh_plan, kind "balance"): threads a block, the shared memory a block
// may take, the bytes a tile of rmax x smax cells takes, and the blocks of
// that size the card holds at once at depth k.
extern "C" int jrl_c_balance_pass_sh_tile_shape(int k, int rmax, int smax, int* threads,
                                                int* smem_cap, int* bytes, int* coresident) {
  if (rmax < 1 || smax < 4 || smax % 4) return (int)cudaErrorInvalidValue;
  *threads = SH_THREADS;
  *smem_cap = SH_SMEM_CAP;
  *bytes = CbLayout(rmax, smax).bytes();
  return with_tile_k(k, [&](auto kc) {
    return sh_coresident<c_balance_pass_sh_tiles<decltype(kc)::value>>(*bytes, coresident);
  });
}

// The same of the column instance.
extern "C" int jrl_c_balance_pass_sh_cols_tile_shape(int k, int rmax, int smax, int* threads,
                                                     int* smem_cap, int* bytes, int* coresident) {
  if (rmax < 1 || smax < 4 || smax % 4) return (int)cudaErrorInvalidValue;
  *threads = SH_THREADS;
  *smem_cap = SH_SMEM_CAP;
  *bytes = CbLayout(rmax, smax).bytes();
  return with_tile_k(k, [&](auto kc) {
    return sh_coresident<c_balance_pass_sh_cols<decltype(kc)::value>>(*bytes, coresident);
  });
}

// One k-step balance pass of a shard. src: h, C and the flags and their
// pieces, rows 16-byte aligned (W % 4 == 0); cols: a column shard's blocks
// (p->s.xh = sh_pass_xh(k)), 16-byte aligned (null on a row mesh); the
// outputs apart from them. A cooperative grid of p->t.grid blocks (refused,
// nothing launched, over the co-resident limit); scratch buffers scr0 (k >=
// 2) and scr1 (k >= 3), each of at least 10 planes of h + 4k rows (a mesh
// of one row: H) x W (a column shard: w + 2 xh).
extern "C" int jrl_c_balance_pass_sh(const CPassShSrc* src, const CPassShCols* cols,
                                     float* h_out, float* C_out, float* scr0, float* scr1, int k,
                                     const CBalancePassShParams* p, void* stream) {
  int err = c_pass_check(p->s, k, p->t, *src, p->fl_rows, scr0, scr1, cols);
  if (err) return err;
  if (!src->C) return (int)cudaErrorInvalidValue;
  const int bytes = CbLayout(p->t.rmax, p->t.smax).bytes();
  if (bytes > SH_SMEM_CAP) return (int)cudaErrorInvalidValue;
  const bool col_shard = p->s.w != p->s.W;
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    int most = 0;
    const int e = col_shard ? sh_coresident<c_balance_pass_sh_cols<K>>(bytes, &most)
                            : sh_coresident<c_balance_pass_sh_tiles<K>>(bytes, &most);
    if (e != (int)cudaSuccess) return e;
    if (p->t.grid < 1 || p->t.grid > most) return (int)cudaErrorCooperativeLaunchTooLarge;
    CPassShSrc a0 = *src;
    CBalancePassShParams a5 = *p;
    CPassShCols a6 = col_shard ? *cols : CPassShCols{};
    void* args[] = {&a0, &h_out, &C_out, &scr0, &scr1, &a5, &a6};
    const void* const kernel = col_shard ? (const void*)c_balance_pass_sh_cols<K>
                                         : (const void*)c_balance_pass_sh_tiles<K>;
    return (int)cudaLaunchCooperativeKernel(kernel, dim3(p->t.grid), dim3(SH_THREADS), args,
                                            bytes, (cudaStream_t)stream);
  });
}

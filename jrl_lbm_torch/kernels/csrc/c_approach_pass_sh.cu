// JRL concentration approach on one shard of a mesh: a k-step pass (k =
// 1..4) in one cooperative launch (pass_sh.cuh), with the stored velocity's
// frame lerp and each step's tip-disk terms inside: sub-step j over the
// shard's rows (and on a column mesh its lanes) extended by 2 (k - 1 - j) a
// side in one wave of tiles, a
// grid barrier after each sub-step, h and C between sub-steps in two
// scratch buffers; after each barrier one block sums the step's disk terms
// of the rows the shard owns.
//
// Replaces k launches of the c_approach_sh.cu pair (the TPU kernel
// jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py::_step_approach, one step and
// its disk block a launch), the per-shard PyTorch lerp before each
// (models/jrl.py::stored_velocity) and the k exchanges of its h pieces: one
// exchange of the 2k-row pieces of h a pass (the step never reads the old
// C), the base flags' pieces once a run, each shard's frames cut once a run
// with their reach rows. c_approach_sh stays, as the yardstick
// (route="launches"). Plain twin: kernels/
// jrl_sharded.py::c_approach_pass_sh_ref. The cell code is jrl_c.cuh's
// approach_cell_at, the lerp jrl_c.cuh::frame_vel, the disk terms
// jrl_c.cuh::disk_sh_step (c_disk_sh_kernel's), each unchanged (with
// --fmad=false) on the values the whole-grid step reads, and the disk terms
// go into part in step order (part[0..1] +=, part[2..3] =), so a pass
// equals k launches of c_approach_sh after the lerp bit for bit, h, C and
// the partials. Step j of the pass is step0 + j in integers, converted
// once (jrl_common.cuh::tip_walks): the jnp form.
//
// Reach. As the balance: one row and column a step, two rows inward at an
// OUTFLOW cell of global row 0 or H - 1 (across the ring's edge on the
// extended rows), so 2k-row pieces; the velocity is read at the cell and at
// an OUTFLOW cell's source, both inside the frame window's 2k reach rows.
//
// Bound on the card: the bytes (h and the base flags read once, the two
// frames the steps read, h and C written once, the pieces; 3.9 us a pass of
// a 256x512 shard at 3.35 TB/s whatever k), the cell code ~335 float32
// operations a cell and step (2.6 us a k = 4 pass at 67 TFLOP/s). What held
// the c_approach_sh pair (15.3 us a step of that shard against its 3.5 us
// bound, and the lerp's three PyTorch launches of 14 planes) back, and what
// the pass does about it:
// - two launches, the lerp and an exchange of h a step, each a host call
//   per shard: one launch and one exchange a shard and k-step pass;
// - the tip SDF evaluated about ten times a cell (flag at the cell, in the
//   streaming, at the eight neighbours of the obstacle mask, phi): flag and
//   phi of every window cell once a sub-step into the tile's tables (by
//   ApproachGeo's own functions, as jrl_c.cuh::WindowGeo), computed while
//   the window's rows land;
// - every read decoded by the shard accessor: each window row's source
//   chosen once and copied by cp.async.bulk into the tile's h table;
// - the disk block's own launch: the sums run on the plan's block past the
//   tiles (pass_sh_plan gives the approach one more block where the card
//   holds it) while the other blocks run the next sub-step.
//
// A tile of R x S cells copies its window of h, rows -2 .. R + 1 and
// columns [sx0 - 2, sx1 + 2) cut to the grid and rounded out to 16 bytes
// (and columns 0 .. 3 after the last one where the strip ends at W);
// sub-step 0 from the body and the pieces, sub-step j > 0 from the scratch
// j - 1 wrote. Each cell runs approach_cell_at on the tables at its
// stored velocity (the lerp of its two frames) and writes h and C to the
// scratch (the last sub-step: h_out, C_out).
//
// A shard of a column mesh (c_approach_pass_sh_cols) has the balance's x
// window (c_balance_pass_sh.cu: sub-step j's lanes the shard's extended by
// 2 (k - 1 - j) a side and cut to the grid, the window rows of h from the
// blocks of sh_pass_xh(k) lanes at sub-step 0, the base flags read from
// theirs), and two things of its own:
// - frames with lanes: a cell of sub-step j < k - 1 past the shard's
//   columns is a real cell and reads the stored velocity at its own lane
//   (jrl_shard.cuh::ShardVel reads 0 off the body, right only for the
//   launches' one-column recompute), so each shard's frames are cut with
//   2k reach lanes a side, cut to the grid (kernels/jrl_sharded.py::
//   shard_frames), and read by PassVelCols;
// - the disk's column past the shard: for a flat tip the flux term dC_r at
//   the shard's last column reads the new C one column right, the next
//   shard's. Below the last sub-step it lies in the scratch (the sub-step's
//   lanes reach past the shard); at the last one the disk block recomputes
//   it (jrl_c.cuh::approach_C, as c_disk_sh_kernel) from the h that
//   sub-step read: the scratch sub-step k - 2 wrote, or at k = 1 the body,
//   the pieces and the right block (CEdgeIn), the base flags from the
//   shard's and the blocks (CColFlags), the velocity from the frames' lanes.
#include "pass_sh.cuh"

// Mirrors kernels/jrl_sharded.py::CApproachPassShParams.
struct CApproachPassShParams {
  CApproachParams p;
  ShardGeom s;     // the shard's place (a column shard: xh = sh_pass_xh(k))
  ShTilePlan t;
  int fl_rows;     // rows of each base flag piece or a block's past the shard (at least 2k;
                   // 0 on a mesh of one row and one column)
  int n_frames;    // frames of the whole history
  int b0;          // the history's frame that the window's frame 0 is
  int vrow0;       // the window's row of shard row 0 (its reach rows a side)
  int vrows;       // the window's rows
};

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

// tools/c_pass_sh_probe.py builds timing probes with wrong results with
// -DJRL_CAPS_NO_CELLS (no cell code), -DJRL_CAPS_NO_GEO (no tip table) and
// -DJRL_CAPS_NO_DISK (no disk sums). 1024 threads a block (64 registers,
// 88 bytes spilled) took 89.35 us a k = 4 pass of the (4, 1) shard against
// 87.71 with 512 (PERF.md §6).
constexpr int CA_THREADS = SH_THREADS;

// A tile's tables, in words from the start of the dynamic shared memory
// (rows of RS = smax + 8 words, WP = rmax + 4 window rows): the window's h
// [9][WP][RS], phi [WP][RS], the flag codes [WP][RS] (ints), then the disk
// sum's tree [4][DISK_SH_THREADS]. Mirrored by kernels/jrl_sharded.py::
// c_tile_smem_bytes.
struct CaLayout {
  int rs, wp;
  __host__ __device__ CaLayout(int rmax, int smax) : rs(smax + 8), wp(rmax + 4) {}
  __host__ __device__ int phi() const { return 9 * wp * rs; }
  __host__ __device__ int codes() const { return 10 * wp * rs; }
  __host__ __device__ int red() const { return 11 * wp * rs; }
  __host__ __device__ int bytes() const { return 4 * (red() + 4 * DISK_SH_THREADS); }
};

template <int K>
__global__ void __launch_bounds__(CA_THREADS, 1) c_approach_pass_sh_tiles(
    CPassShSrc src, const float* area, float* h_out, float* C_out, float* part, float* scr0,
    float* scr1, int step0, CApproachPassShParams pp) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const CaLayout lay(pp.t.rmax, pp.t.smax);
  // a launch whose plan the host got wrong stops (an error, not wrong
  // cells): its tables must fit the shared memory
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)lay.bytes() > dyn) __trap();
  const CApproachParams& p = pp.p;
  const ShardGeom& s = pp.s;
  const int H = s.H, W = s.W, hw = s.h * s.w, tid = threadIdx.x;
  const bool whole = s.h == s.H;       // a mesh of one row
  const int soff = whole ? 0 : 2 * K;  // scratch row of shard row 0
  const int splane = (whole ? H : s.h + 4 * K) * W;  // words a scratch plane
  const int RS = lay.rs, WP = lay.wp;
  float* const in = smem;
  float* const phis = smem + lay.phi();
  int* const codes = reinterpret_cast<int*>(smem + lay.codes());
  float(&red)[4][DISK_SH_THREADS] =
      *reinterpret_cast<float(*)[4][DISK_SH_THREADS]>(smem + lay.red());
  const uint32_t bar_a = smem_addr(&bar);
  if (tid == 0) {
    mbar_init(bar_a);
    mbar_init_fence();
    fence_proxy_async();  // the initialised mbarrier visible to the async proxy
  }
  __syncthreads();
  uint32_t parity = 0;
  cg::grid_group grid = cg::this_grid();
  // shard row r of the base flags
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
    // shard row r of h plane q before sub-step j
    const auto h_row = [&](int q, int r) -> const void* {
      if (j > 0) return s_in + q * splane + (whole ? wrap1(r, H) : r + soff) * W;
      return sh_row<float>(src.h, src.top, src.bot, s, 2 * K, q, r);
    };
    // the step's stored velocity and moving tip
    const int step = step0 + j;
    int bf;
    const PassVel pv{frame_vel(src.frames, pp.n_frames, pp.b0, pp.vrows * W, step, p.v, bf), H,
                     W, s.row0, s.h, pp.vrow0, whole};
    auto g0 = approach_geo_on(OneFlag{0}, pv, step, p);
    const int nty = sh_nty(pp.t, j), ntiles = nty * pp.t.ntx;
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const ShTile tl(t, nty, pp.t.ntx, E, W);
      const int R = tl.e1 - tl.e0, S = tl.sx1 - tl.sx0, ncols = tl.cx1 - tl.cx0;
      const int rb0 = r_lo + tl.e0;                  // shard row of the first cell row
      const int ybase = wrap1(s.row0 + rb0 - 2, H);  // global row of window row 0
      const int wr = R + 4;
      const bool wrap = tl.cx1 == W;
      const int gcols = ncols + (wrap ? 4 : 0);  // table columns
      if (R < 1 || R > pp.t.rmax || S < 1 || S > pp.t.smax || gcols > RS) __trap();
      // the barrier orders the expected bytes before every copy and the tile
      // before's reads of the tables before this tile's writes
      if (tid == 0) mbar_expect(bar_a, c_window_bytes(9, wr, ncols, wrap));
      __syncthreads();
      c_copy_window(smem_addr(in), 9, WP, RS, wr, rb0 - 2, tl.cx0, ncols, wrap, h_row, bar_a);
      // the tip's flag and phi once a window cell, while the rows land
#ifndef JRL_CAPS_NO_GEO
      for (int n = tid; n < wr * gcols; n += CA_THREADS) {
        const int i = n / gcols, c = n - i * gcols;
        const int y = wrap1(ybase + i, H), x = c < ncols ? tl.cx0 + c : c - ncols;
        const float ph = g0.phi(y, x);
        g0.base.v = fl_row(rb0 - 2 + i)[x];
        codes[i * RS + c] = g0.flag_at(y, x, ph);
        phis[i * RS + c] = ph;
      }
#endif
      __syncthreads();
      mbar_wait(bar_a, parity);
      parity ^= 1;
      CTileGeo<PassVel> g;
      static_cast<ApproachGeo<PassVel, OneFlag>&>(g) = g0;
      g.codes = codes;
      g.phis = phis;
      g.win = CWin{H, W, ybase, RS, tl.cx0};
#pragma unroll 1
      for (int n = tid; n < R * S; n += CA_THREADS) {
        const int bi = n / S, bc = n - bi * S, x = tl.sx0 + bc, i = bi + 2, c = x - tl.cx0;
        const int y = wrap1(ybase + i, H), rr = rb0 + bi;  // global row, shard row
        const int vi = pv.idx_r(rr, x);
        const CTileIn a{in, RS, WP, i, c};
#ifdef JRL_CAPS_NO_CELLS
        const float hv = a.F(0, 0, 0) + pv.fv.u(vi) + (float)codes[i * RS + c];
        float* const ho = j < K - 1 ? s_out : h_out;
        ho[(j < K - 1 ? (whole ? rr : rr + soff) * W : rr * s.w) + x] = hv;
        continue;
#endif
        if (j < K - 1)
          approach_cell_at(a, g, p, y, x, pv.fv.u(vi), pv.fv.v(vi), s_out, s_out + 9 * splane,
                           (whole ? rr : rr + soff) * W + x, splane);
        else
          approach_cell_at(a, g, p, y, x, pv.fv.u(vi), pv.fv.v(vi), h_out, C_out,
                           rr * s.w + x, hw);
      }
    }
    // sub-step j + 1 and the disk read what every block wrote (a proxy fence
    // before the bulk copies, which read through the async proxy)
    grid.sync();
    // the step's disk terms from its new C, by the last block (the plan's
    // block past the tiles, where the card holds one: it takes no tile),
    // before sub-step j + 2 writes that buffer again (after the next barrier)
#ifndef JRL_CAPS_NO_DISK
    if (blockIdx.x == gridDim.x - 1) {
      const float* const Cn = j < K - 1 ? s_out + 9 * splane + soff * W : C_out;
      const auto cn = [&](int r, int x) { return Cn[(r - s.row0) * W + x]; };
      disk_sh_step(cn, g0, p, area, part, s.row0, s.h, s.col0, s.w, red);
    }
#endif
  }
}

// h before the last sub-step of a column shard's pass around a cell of the
// column past the shard (the disk's recompute of its new C): at k = 1 the
// body, the pieces (h, top, bot) and the right block, else the scratch
// sub-step k - 2 wrote (shard row r at scratch row r + soff, global column x
// at x + sx). jrl_common.cuh::GlobalState's interface at global coordinates.
template <int K>
struct CEdgeIn {
  const float *h, *top, *bot, *right, *scr;
  ShardGeom s;
  int splane, SW, sx, soff, y, x;
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    const int r = c_shard_row(s, 2 * K, wrap1(y + dy, s.H)), xx = x + dx;
    if (scr) return scr[q * splane + (s.h == s.H ? wrap1(r, s.H) : r + soff) * SW + xx + sx];
    const int lx = xx - s.col0;
    if (lx < s.w) return sh_row<float>(h, top, bot, s, 2 * K, q, r)[lx];
    return right[((size_t)q * (s.h + 4 * K) + c_block_row(s, 2 * K, r)) * s.xh + lx - s.w];
  }
  __device__ __forceinline__ CEdgeIn at(int dy, int dx) const {
    CEdgeIn a = *this;
    a.y = wrap1(y + dy, s.H);
    a.x = x + dx;
    return a;
  }
};

// The pass of a column shard at depth K: the row kernel above with sub-step
// j over the shard's lanes extended by 2 (k - 1 - j) a side too (sh_lanes),
// the lanes past the shard from `cols`: a window row of h at sub-step 0 from
// the left block, the body or piece row and the right block (c_copy_cols),
// later one copy of a scratch row of w + 2 xh lanes; the base flags from the
// shard's and the blocks (c_col_flag); the stored velocity from the frame
// window's lanes (PassVelCols); the disk's column past the shard from the
// scratch below the last sub-step, recomputed at the last (CEdgeIn).
template <int K>
__global__ void __launch_bounds__(CA_THREADS, 1) c_approach_pass_sh_cols(
    CPassShSrc src, const float* area, float* h_out, float* C_out, float* part, float* scr0,
    float* scr1, int step0, CApproachPassShParams pp, CPassShCols cols) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const CaLayout lay(pp.t.rmax, pp.t.smax);
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)lay.bytes() > dyn) __trap();
  const CApproachParams& p = pp.p;
  const ShardGeom& s = pp.s;
  const int H = s.H, W = s.W, hw = s.h * s.w, tid = threadIdx.x;
  const bool whole = s.h == s.H;       // a mesh of one row
  const int soff = whole ? 0 : 2 * K;  // scratch row of shard row 0
  // a scratch row's words, and the scratch column of global column 0
  const int SW = s.w + 2 * s.xh, sx = s.xh - s.col0;
  const int splane = (whole ? H : s.h + 4 * K) * SW;  // words a scratch plane
  const int RS = lay.rs, WP = lay.wp;
  float* const in = smem;
  float* const phis = smem + lay.phi();
  int* const codes = reinterpret_cast<int*>(smem + lay.codes());
  float(&red)[4][DISK_SH_THREADS] =
      *reinterpret_cast<float(*)[4][DISK_SH_THREADS]>(smem + lay.red());
  const uint32_t bar_a = smem_addr(&bar);
  if (tid == 0) {
    mbar_init(bar_a);
    mbar_init_fence();
    fence_proxy_async();  // the initialised mbarrier visible to the async proxy
  }
  __syncthreads();
  uint32_t parity = 0;
  cg::grid_group grid = cg::this_grid();

#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const int lvl = K - 1 - j;
    const int E = whole ? H : s.h + 4 * lvl;  // cell rows of the sub-step
    const int r_lo = whole ? 0 : -2 * lvl;    // shard row of extended row 0
    const float* const s_in = (j & 1) ? scr0 : scr1;  // what sub-step j - 1 wrote
    float* const s_out = (j & 1) ? scr1 : scr0;
    // shard row r of h plane q before sub-step j: at j = 0 the body or a
    // piece (shard column 0 at [0]), at j > 0 the scratch (global column 0
    // at [0])
    const auto h_row = [&](int q, int r) -> const float* {
      if (j > 0) return s_in + q * splane + (whole ? wrap1(r, H) : r + soff) * SW + sx;
      return sh_row<float>(src.h, src.top, src.bot, s, 2 * K, q, r);
    };
    // the step's stored velocity and moving tip
    const int step = step0 + j;
    int bf;
    const PassVelCols pv{
        frame_vel(src.frames, pp.n_frames, pp.b0, pp.vrows * cols.vcols, step, p.v, bf), s,
        pp.vrow0, cols.vcols, cols.vcol0 - s.col0};
    auto g0 = approach_geo_on(OneFlag{0}, pv, step, p);
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
      if (tid == 0) mbar_expect(bar_a, c_window_bytes(9, wr, ncols, false));
      __syncthreads();
      for (int n = tid; n < 9 * wr; n += CA_THREADS) {
        const int q = n / wr, i = n - q * wr, r = rb0 - 2 + i;
        const uint32_t dst = smem_addr(in) + 4u * (uint32_t)((q * WP + i) * RS);
        fence_proxy_async();         // the block's reads of the tables before the copy
        fence_proxy_async_global();  // the scratch rows written before grid.sync
        if (j > 0)
          bulk_g2s(dst, h_row(q, r) + tl.cx0, 4u * (uint32_t)ncols, bar_a);
        else
          c_copy_cols<float>(dst, h_row(q, r), cols.left, cols.right,
                             ((size_t)q * (s.h + 4 * K) + c_block_row(s, 2 * K, r)) * s.xh,
                             s.xh, s, tl.cx0, tl.cx1, bar_a);
      }
      // the tip's flag and phi once a window cell, while the rows land
#ifndef JRL_CAPS_NO_GEO
      for (int n = tid; n < wr * ncols; n += CA_THREADS) {
        const int i = n / ncols, c = n - i * ncols;
        const int y = wrap1(ybase + i, H), x = tl.cx0 + c;
        const float ph = g0.phi(y, x);
        g0.base.v = c_col_flag(src, cols, s, pp.fl_rows, rb0 - 2 + i, x);
        codes[i * RS + c] = g0.flag_at(y, x, ph);
        phis[i * RS + c] = ph;
      }
#endif
      __syncthreads();
      mbar_wait(bar_a, parity);
      parity ^= 1;
      CTileGeo<PassVelCols> g;
      static_cast<ApproachGeo<PassVelCols, OneFlag>&>(g) = g0;
      g.codes = codes;
      g.phis = phis;
      g.win = CWin{H, W, ybase, RS, tl.cx0};
#pragma unroll 1
      for (int n = tid; n < R * S; n += CA_THREADS) {
        const int bi = n / S, bc = n - bi * S, x = tl.sx0 + bc, i = bi + 2, c = x - tl.cx0;
        const int y = wrap1(ybase + i, H), rr = rb0 + bi;  // global row, shard row
        const int vi = pv.idx_r(rr, x);
        const CTileIn a{in, RS, WP, i, c};
        // the cell's place in the scratch, or in the outputs at the last sub-step
        const int oi = j < K - 1 ? (whole ? rr : rr + soff) * SW + x + sx : rr * s.w + x - s.col0;
#ifdef JRL_CAPS_NO_CELLS
        (j < K - 1 ? s_out : h_out)[oi] = a.F(0, 0, 0) + pv.fv.u(vi) + (float)codes[i * RS + c];
        continue;
#endif
        if (j < K - 1)
          approach_cell_at(a, g, p, y, x, pv.fv.u(vi), pv.fv.v(vi), s_out, s_out + 9 * splane,
                           oi, splane);
        else
          approach_cell_at(a, g, p, y, x, pv.fv.u(vi), pv.fv.v(vi), h_out, C_out, oi, hw);
      }
    }
    // sub-step j + 1 and the disk read what every block wrote (a proxy fence
    // before the bulk copies, which read through the async proxy)
    grid.sync();
    // the step's disk terms from its new C, by the last block, before
    // sub-step j + 2 writes that buffer again (after the next barrier); the
    // column past the shard (dC_r of its last column) in the scratch below
    // the last sub-step, whose lanes reach past it, recomputed at the last
    // from the h that sub-step read
#ifndef JRL_CAPS_NO_DISK
    if (blockIdx.x == gridDim.x - 1) {
      const int c1 = s.col0 + s.w;
      const auto cn = [&](int r, int x) -> float {
        if (j < K - 1) return s_out[9 * splane + (r - s.row0 + soff) * SW + x + sx];
        if (x < c1) return C_out[(r - s.row0) * s.w + x - s.col0];
        const auto ge = approach_geo_on(CColFlags{src, cols, s, pp.fl_rows}, pv, step, p);
        const CEdgeIn<K> e{src.h, src.top, src.bot, cols.right, K > 1 ? s_in : nullptr,
                           s, splane, SW, sx, soff, r, x};
        float hs[9];
        return approach_C(e, ge, p, r, x, ge.flag(r, x), hs);
      };
      disk_sh_step(cn, g0, p, area, part, s.row0, s.h, s.col0, s.w, red);
    }
#endif
  }
}

}  // namespace

// Registers per thread and local (spill) bytes of the instance at depth k.
extern "C" int jrl_c_approach_pass_sh_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(c_approach_pass_sh_tiles<decltype(kc)::value>, regs, local_bytes);
  });
}

// The same of the column instance.
extern "C" int jrl_c_approach_pass_sh_cols_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(c_approach_pass_sh_cols<decltype(kc)::value>, regs, local_bytes);
  });
}

// The launch shape, which the host plan mirrors (kernels/jrl_sharded.py::
// pass_sh_plan, kind "approach"): threads a block, the shared memory a block
// may take, the bytes a tile of rmax x smax cells takes, and the blocks of
// that size the card holds at once at depth k.
extern "C" int jrl_c_approach_pass_sh_tile_shape(int k, int rmax, int smax, int* threads,
                                                 int* smem_cap, int* bytes, int* coresident) {
  if (rmax < 1 || smax < 4 || smax % 4) return (int)cudaErrorInvalidValue;
  *threads = CA_THREADS;
  *smem_cap = SH_SMEM_CAP;
  *bytes = CaLayout(rmax, smax).bytes();
  return with_tile_k(k, [&](auto kc) {
    return sh_coresident<c_approach_pass_sh_tiles<decltype(kc)::value>>(*bytes, coresident);
  });
}

// The same of the column instance.
extern "C" int jrl_c_approach_pass_sh_cols_tile_shape(int k, int rmax, int smax, int* threads,
                                                      int* smem_cap, int* bytes,
                                                      int* coresident) {
  if (rmax < 1 || smax < 4 || smax % 4) return (int)cudaErrorInvalidValue;
  *threads = CA_THREADS;
  *smem_cap = SH_SMEM_CAP;
  *bytes = CaLayout(rmax, smax).bytes();
  return with_tile_k(k, [&](auto kc) {
    return sh_coresident<c_approach_pass_sh_cols<decltype(kc)::value>>(*bytes, coresident);
  });
}

// One k-step approach pass of a shard from step step0. src: h, the base
// flags and their pieces and the frame window, rows 16-byte aligned (W % 4
// == 0); cols: a column shard's blocks (p->s.xh = sh_pass_xh(k)), 16-byte
// aligned, and its frame window's lanes (null on a row mesh); the outputs
// apart from them; area [rint]; part [4] (the shard's disk sums, updated in
// step order). A cooperative grid of p->t.grid blocks (refused, nothing
// launched, over the co-resident limit); scratch buffers scr0 (k >= 2) and
// scr1 (k >= 3), each of at least 10 planes of h + 4k rows (a mesh of one
// row: H) x W (a column shard: w + 2 xh).
extern "C" int jrl_c_approach_pass_sh(const CPassShSrc* src, const CPassShCols* cols,
                                      const float* area, float* h_out, float* C_out, float* part,
                                      float* scr0, float* scr1, int step0, int k,
                                      const CApproachPassShParams* p, void* stream) {
  int err = c_pass_check(p->s, k, p->t, *src, p->fl_rows, scr0, scr1, cols, true);
  if (err) return err;
  const ShardGeom& s = p->s;
  const bool whole = s.h == s.H, col_shard = s.w != s.W;
  if (!src->frames || p->n_frames < 1 || p->b0 < 0 ||
      (whole ? (p->vrow0 != 0 || p->vrows != s.H)
             : (p->vrow0 < 2 * k || p->vrows - p->vrow0 - s.h < 2 * k)) ||
      p->p.rint >= s.W - 1)
    return (int)cudaErrorInvalidValue;
  const int bytes = CaLayout(p->t.rmax, p->t.smax).bytes();
  if (bytes > SH_SMEM_CAP) return (int)cudaErrorInvalidValue;
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    int most = 0;
    const int e = col_shard ? sh_coresident<c_approach_pass_sh_cols<K>>(bytes, &most)
                            : sh_coresident<c_approach_pass_sh_tiles<K>>(bytes, &most);
    if (e != (int)cudaSuccess) return e;
    if (p->t.grid < 1 || p->t.grid > most) return (int)cudaErrorCooperativeLaunchTooLarge;
    CPassShSrc a0 = *src;
    CApproachPassShParams a9 = *p;
    CPassShCols a10 = col_shard ? *cols : CPassShCols{};
    int a8 = step0;
    void* args[] = {&a0, &area, &h_out, &C_out, &part, &scr0, &scr1, &a8, &a9, &a10};
    const void* const kernel = col_shard ? (const void*)c_approach_pass_sh_cols<K>
                                         : (const void*)c_approach_pass_sh_tiles<K>;
    return (int)cudaLaunchCooperativeKernel(kernel, dim3(p->t.grid), dim3(CA_THREADS), args,
                                            bytes, (cudaStream_t)stream);
  });
}

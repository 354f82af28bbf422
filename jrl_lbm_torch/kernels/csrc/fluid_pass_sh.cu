// JRL fluid phase on one shard of a mesh: a k-step pass (k = 1..4) in one
// launch, k steps of fluid step A and B fused, the full class (the moving
// tip, the walls) or, on a row mesh, the lean class (a shard above the tip
// front) on the whole shard. One persistent cooperative grid, no larger
// than the co-resident limit: sub-step j runs over the whole shard (its
// rows, and on a column mesh its lanes, extended by 2 (k - 1 - j) a side)
// in 2D tiles on every SM, a grid barrier between sub-steps, the
// sub-steps' planes in two scratch buffers.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_fluid_k_kernel with shard=True (k steps of one TH-row tile with
// +-2k-row halos, the cross-shard pieces swapped in on the shard's first
// and last tiles, the global row offset from SMEM), and with it the A/B
// pair of a sharded step (fluid_a_sh.cu, fluid_b_sh.cu; kept, and the
// yardstick route="launches"). Plain twin: kernels/jrl_sharded.py::
// fluid_pass_sh_ref. The cell code is jrl_fluid.cuh's, unchanged (with
// --fmad=false), and every cell of sub-step j is computed from the values
// the whole-grid step j reads, so the launch equals k steps of the pair
// bit for bit. Step j of the pass is step0 + j in integers, converted once
// (jrl_common.cuh::tip_walks): the jnp form.
//
// Bound on the card: the bytes, whatever k: the shard's f, rho and vel read
// once and written once, and the 2k-row pieces (12 planes) a side (~15 us
// a pass on the 1024x512 grid at 3.35 TB/s, against ~28 us a step for the
// pair); the cell code is ~650 float32 operations a full cell and step
// (~420 lean). What the pair pays, and what the pass does about it:
// - two launches and two halo exchanges a step, each a host call per
//   shard: one exchange of 2k rows and one launch a shard per k steps;
// - every read decoded by the shard accessor (jrl_shard.cuh::ShardState:
//   body, row piece or column block per value): the source is chosen once
//   a window row (a body row, a row of the top or bottom piece, or a
//   scratch row), and the row is copied by cp.async.bulk (pass_state.cuh);
// - the tip SDF evaluated once per neighbour read: once per window cell
//   and sub-step, into a geometry table (TileGeo, pass_state.cuh::RingGeo).
// What the cell code costs on the card: one A and B chain a thread takes
// ~7 us with one 512-thread block an SM (latency, not issue rate), so the
// pass's time is the chains a thread runs in turn. The first design, a
// row wavefront of (strip, run) blocks with the k sub-steps five rows apart in
// each block, ran R + 7k - 4 chains for a run of R rows, and one wave of
// blocks made the runs short (~10 rows at k = 4 on a 256x512 shard: 23% of
// the chains useful); the tiles run every chain on useful or halo cells,
// at the cost of the level pyramid's extended rows (12 of 256 a side at k =
// 4, j = 0) and of k - 1 round trips of the planes through the scratch
// (PERF.md §6).
//
// Sub-step j (lvl = k - 1 - j) computes B on the extended rows e = 0 ..
// E_j - 1, E_j = h + 4 lvl (shard row e - 2 lvl; on a mesh of one row E_j =
// H, the rows wrap and nothing is extended), cut into nty[j] row bands x
// ntx column strips (ends on multiples of 4); block b takes tiles b, b +
// grid, ... of each sub-step. A tile runs A and B on its cells from its
// window (fluid_tile.cuh, shared with fused_fluid_tl.cu): sub-step 0 from
// the body and the pieces (fpt_row), sub-step j > 0 from the scratch that j
// - 1 wrote. The last sub-step writes f_out, rho_out and vel_out; the
// others write B's f and A's rho, u, v (f alone for the lean class) to the
// scratch buffer j % 2, [12][SR][W] with shard row r at scratch row r + 2k
// (on a mesh of one row: [12][H][W], row r at r). One grid.sync() ends each
// sub-step but the last: sub-step j + 1 reads what every block wrote (a
// proxy fence before its bulk copies, which read through the async proxy).
// The launch form (the tile of a sub-step, the co-resident limit, the proxy
// fence) is pass_sh.cuh's, shared with the C phases' passes.
//
// A shard of a column mesh (w < W; fluid_pass_sh_cols, the full class
// only, as JAX keeps its lean pair off 2D meshes: fused_jrl_sharded.py:312)
// has the x window of JAX's 2D-mesh per-step route (_xblocks, the
// extended windows of _step_a / _step_b) k steps deep: sub-step j's B
// lanes [X0, X1) are the shard's columns extended by 2 (k - 1 - j) a side
// and cut to the grid (pass_sh.cuh::sh_lanes: the x edges reflect, so the
// outer shards' ring lanes are never read, as JAX's at_x0 / at_xW masks
// say); its strips end on multiples of 4 inside, on X0 and X1 outside.
// The lanes beyond the shard come from halo.exchange's column blocks of
// [f, vel, rho]: xh = 4 ceil(2k / 4) lanes (k = 1, 3: 4 and 8, not 2 and
// 6, so that every block row is whole 16-byte words and one bulk copy; the
// other choice, word-by-word copies of 2 or 6 lanes, would add a second
// copy path and its ordering) of the rows row0 - 2k .. row0 + h + 2k - 1,
// corners included (the second hop of halo.exchange, as JAX's _xblocks).
// A window row of sub-step 0 is then up to three bulk copies, each a
// multiple of 16 bytes (col0, w, xh and the window's ends on multiples of
// 4): the left block's lanes, the body or piece row, the right block's
// lanes. The scratch rows cover the lanes, w + 2 xh of them with shard
// column c at scratch column c + xh, so a later sub-step's window row is
// one copy; its first and last lanes, which no sub-step writes, are copied
// into the window's 16-byte ends and never read.
#include "fluid_tile.cuh"

// Mirrors kernels/jrl_sharded.py::PassShParams (outside the unnamed
// namespace: the C entry point takes it, and must keep external linkage).
struct FluidPassShParams {
  FluidParams a;
  FluidBParams b;
  ShardGeom s;   // the shard's place (a column shard: xh = sh_pass_xh(k))
  int lean;      // the lean class on the whole shard
  ShTilePlan t;  // the tiles (rmax, smax: the largest tile's B rows and columns)
};

// The shard's planes and its 2k-row pieces: top holds the rows row0 - 2k ..
// row0 - 1, bot the rows row0 + h .. row0 + h + 2k - 1, each [12][2k][w] in
// the planes of halo.exchange's group [f, vel, rho] (f 0-8, u 9, v 10, rho
// 11); both null on a mesh of one row.
struct FluidPassShSrc {
  const float* f;    // [9][h][w]
  const float* rho;  // [h][w]
  const float* vel;  // [2][h][w]
  const float* top;
  const float* bot;
};

// A column shard's blocks (halo.exchange's left and right of [f, vel, rho]
// with rows = 2k): [12][h + 4k][xh], the columns col0 - xh .. col0 - 1 and
// col0 + w .. col0 + w + xh - 1 of the rows row0 - 2k .. row0 + h + 2k - 1
// (on a mesh of one row rows 2k .. h + 2k - 1 hold the shard's rows).
// Mirrors kernels/jrl_sharded.py::PassShCols.
struct FluidPassShCols {
  const float* left;
  const float* right;
};

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

// The probes' -D builds (fluid_tile.cuh: JRL_FPT_NO_CELLS, JRL_FPT_NO_GEO,
// JRL_FPT_SDF) time tools/fluid_pass_sh_probe.py's variants
constexpr int FPT_THREADS = SH_THREADS;  // threads a block, one block an SM

// Shard row r (-2k <= r < h + 2k) of plane q (f 0-8, rho 9, u 10, v 11): a
// body row, or a row of a piece; on a mesh of one row the body mod h.
template <int K>
__device__ __forceinline__ const float* fpt_row(const FluidPassShSrc& src, const ShardGeom& s,
                                                int q, int r) {
  constexpr int R2 = 2 * K;
  if (s.h == s.H || (r >= 0 && r < s.h)) {
    const int y = wrap1(r, s.h);
    if (q < 9) return src.f + (q * s.h + y) * s.w;
    if (q == 9) return src.rho + y * s.w;
    return src.vel + ((q - 10) * s.h + y) * s.w;
  }
  const int pq = q < 9 ? q : (q == 9 ? 11 : q - 1);
  if (r < 0) return src.top + (pq * R2 + r + R2) * s.w;
  return src.bot + (pq * R2 + r - s.h) * s.w;
}

// Columns [cx0, cx1) of plane q of shard row r (-2k <= r < h + 2k) at
// sub-step 0 of a column shard into the shared words at `dst`: the left
// block's lanes, the body or piece row (fpt_row), the right block's lanes,
// each copy a multiple of 16 bytes, counted on `bar`.
template <int K>
__device__ __forceinline__ void fpt_copy_cols(const FluidPassShSrc& src,
                                              const FluidPassShCols& cols, const ShardGeom& s,
                                              int q, int r, int cx0, int cx1, float* dst,
                                              uint32_t bar) {
  const int c0 = s.col0, c1 = s.col0 + s.w, xh = s.xh;
  const int pq = q < 9 ? q : (q == 9 ? 11 : q - 1);  // the plane in [f, vel, rho]
  const int br = (s.h == s.H ? wrap1(r, s.h) : r) + 2 * K;  // the blocks' row
  const size_t boff = ((size_t)pq * (s.h + 4 * K) + br) * xh;
  fence_proxy_async();  // the block's reads of the tables before the copy
  const uint32_t d = smem_addr(dst);
  if (cx0 < c0)
    bulk_g2s(d, cols.left + boff + (cx0 - (c0 - xh)), 4u * (uint32_t)(min(cx1, c0) - cx0), bar);
  const int m0 = max(cx0, c0), m1 = min(cx1, c1);
  if (m0 < m1)
    bulk_g2s(d + 4u * (uint32_t)(m0 - cx0), fpt_row<K>(src, s, q, r) + (m0 - c0),
             4u * (uint32_t)(m1 - m0), bar);
  if (cx1 > c1) {
    const int x0 = max(cx0, c1);
    bulk_g2s(d + 4u * (uint32_t)(x0 - cx0), cols.right + boff + (x0 - c1),
             4u * (uint32_t)(cx1 - x0), bar);
  }
}

// The pass of class CLS at depth K over every tile of the launch; COLS: a
// shard of a column mesh (the full class), its lanes beyond the shard from
// `cols`.
template <int CLS, int K, bool COLS = false>
__device__ __forceinline__ void fpt_run(const FluidPassShSrc& src, float* f_out, float* rho_out,
                                        float* vel_out, float* scr0, float* scr1, int step0,
                                        const FluidPassShParams& p, float* smem, uint64_t* bar,
                                        const FluidPassShCols& cols = {}) {
  constexpr bool LEAN = CLS == TILE_LEAN;
  const ShardGeom& s = p.s;
  const int H = s.H, W = s.W, hw = s.h * s.w;
  const bool whole = s.h == s.H;  // a mesh of one row
  const int soff = whole ? 0 : 2 * K;  // scratch row of shard row 0
  // a scratch row's floats, and the scratch column of global column 0
  const int SW = COLS ? s.w + 2 * s.xh : W, sx = COLS ? s.xh - s.col0 : 0;
  const size_t splane = (size_t)(whole ? H : s.h + 4 * K) * SW;  // floats a scratch plane
  const uint32_t bar_a = fluid_tile_bar(bar);
  uint32_t parity = 0;
  cg::grid_group grid = cg::this_grid();

#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const int lvl = K - 1 - j;
    const int E = whole ? H : s.h + 4 * lvl;  // B rows of the sub-step
    const int r_lo = whole ? 0 : -2 * lvl;    // shard row of extended row 0
    const float* const s_in = (j & 1) ? scr0 : scr1;  // what sub-step j - 1 wrote
    float* const s_out = (j & 1) ? scr1 : scr0;
    const FluidGeo fg = fluid_geo(step0 + j, p.a);
    const int nty = sh_nty(p.t, j), ntiles = nty * p.t.ntx;
    int X0 = 0, X1 = W;  // the sub-step's B lanes
    if constexpr (COLS) sh_lanes(s, K, j, X0, X1);
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const ShTile tl = COLS ? ShTile(t, nty, p.t.ntx, E, X0, X1, W)
                             : ShTile(t, nty, p.t.ntx, E, W);
      const int rb0 = r_lo + tl.e0;  // shard row of the first B row
      // sub-step 0 from the body and the pieces, sub-step j > 0 from the
      // scratch that j - 1 wrote
      const auto row_of = [&](int q, int i) {
        const int r = rb0 - 2 + i;
        return j == 0 ? fpt_row<K>(src, s, q, r)
                      : s_in + q * splane + (size_t)(whole ? wrap1(r, H) : r + soff) * SW + sx;
      };
      // the last sub-step writes f_out, rho_out and vel_out; the others B's
      // f and A's rho, u, v (f alone for the lean class) to the scratch
      const auto store = [&](int bi, int x, const float* fo, float r, float u, float v) {
        const int rr = rb0 + bi;  // shard row
        if (j < K - 1) {
          float* const dst = s_out + (size_t)(rr + soff) * SW + sx + x;
#pragma unroll
          for (int q = 0; q < 9; ++q) dst[q * splane] = fo[q];
          if (!LEAN) {
            dst[9 * splane] = r;
            dst[10 * splane] = u;
            dst[11 * splane] = v;
          }
        } else {
          const int o = rr * s.w + x - (COLS ? s.col0 : 0);
#pragma unroll
          for (int q = 0; q < 9; ++q) f_out[q * hw + o] = fo[q];
          rho_out[o] = r;
          vel_out[o] = u;
          vel_out[hw + o] = v;
        }
      };
      if constexpr (COLS) {
        // sub-step 0 from the blocks, the body and the pieces; later ones
        // one copy of a scratch row
        const auto copy_row = [&](int q, int i, float* dst) {
          if (j == 0) {
            fpt_copy_cols<K>(src, cols, s, q, rb0 - 2 + i, tl.cx0, tl.cx1, dst, bar_a);
            return;
          }
          const float* const row = row_of(q, i);
          fence_proxy_async();         // the block's reads of the tables before the copy
          fence_proxy_async_global();  // the rows other blocks wrote before grid.sync
          bulk_g2s(smem_addr(dst), row + tl.cx0, 4u * (uint32_t)(tl.cx1 - tl.cx0), bar_a);
        };
        fluid_tile<LEAN>(tl, wrap1(s.row0 + rb0 - 2, H), fg, p.a, p.b, p.t.rmax, p.t.smax, smem,
                         bar_a, parity, row_of, store, copy_row);
      } else {
        fluid_tile<LEAN>(tl, wrap1(s.row0 + rb0 - 2, H), fg, p.a, p.b, p.t.rmax, p.t.smax, smem,
                         bar_a, parity, row_of, store);
      }
    }
    if (j < K - 1) grid.sync();
  }
}

template <int K>
__global__ void __launch_bounds__(FPT_THREADS, 1) fluid_pass_sh_tiles(
    FluidPassShSrc src, float* f_out, float* rho_out, float* vel_out, float* scr0, float* scr1,
    int step0, FluidPassShParams p) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  fluid_tile_smem_check(p.t.rmax, p.t.smax);
  if (p.lean)
    fpt_run<TILE_LEAN, K>(src, f_out, rho_out, vel_out, scr0, scr1, step0, p, smem, &bar);
  else
    fpt_run<TILE_FULL, K>(src, f_out, rho_out, vel_out, scr0, scr1, step0, p, smem, &bar);
}

// The pass of a column shard at depth K: the full class.
template <int K>
__global__ void __launch_bounds__(FPT_THREADS, 1) fluid_pass_sh_cols(
    FluidPassShSrc src, float* f_out, float* rho_out, float* vel_out, float* scr0, float* scr1,
    int step0, FluidPassShParams p, FluidPassShCols cols) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  fluid_tile_smem_check(p.t.rmax, p.t.smax);
  fpt_run<TILE_FULL, K, true>(src, f_out, rho_out, vel_out, scr0, scr1, step0, p, smem, &bar,
                              cols);
}

}  // namespace

// Registers per thread and local (spill) bytes of the instance at depth k.
extern "C" int jrl_fluid_pass_sh_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(fluid_pass_sh_tiles<decltype(kc)::value>, regs, local_bytes);
  });
}

// The same of the column instance.
extern "C" int jrl_fluid_pass_sh_cols_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(fluid_pass_sh_cols<decltype(kc)::value>, regs, local_bytes);
  });
}

// The launch shape, which the host plan mirrors (kernels/jrl_sharded.py::
// pass_sh_plan): threads a block, the shared memory a block may take, the
// bytes a tile of rmax x smax B cells takes, and the blocks of that size
// the card holds at once at depth k.
extern "C" int jrl_fluid_pass_sh_tile_shape(int k, int rmax, int smax, int* threads,
                                            int* smem_cap, int* bytes, int* coresident) {
  if (rmax < 1 || smax < 4 || smax % 4) return (int)cudaErrorInvalidValue;
  *threads = FPT_THREADS;
  *smem_cap = SH_SMEM_CAP;
  *bytes = FptLayout(rmax, smax).bytes();
  return with_tile_k(k, [&](auto kc) {
    return sh_coresident<fluid_pass_sh_tiles<decltype(kc)::value>>(*bytes, coresident);
  });
}

// The same of the column instance.
extern "C" int jrl_fluid_pass_sh_cols_tile_shape(int k, int rmax, int smax, int* threads,
                                                 int* smem_cap, int* bytes, int* coresident) {
  if (rmax < 1 || smax < 4 || smax % 4) return (int)cudaErrorInvalidValue;
  *threads = FPT_THREADS;
  *smem_cap = SH_SMEM_CAP;
  *bytes = FptLayout(rmax, smax).bytes();
  return with_tile_k(k, [&](auto kc) {
    return sh_coresident<fluid_pass_sh_cols<decltype(kc)::value>>(*bytes, coresident);
  });
}

// One k-step pass of a shard from step step0. src: the shard's planes and
// its 2k-row pieces, rows 16-byte aligned (W % 4 == 0); cols: a column
// shard's blocks of p->s.xh = sh_pass_xh(k) lanes, 16-byte aligned (null
// on a row mesh); the outputs apart from them. A cooperative grid of
// p->t.grid blocks (refused, nothing launched, over the co-resident limit);
// scratch buffers scr0 (k >= 2) and scr1 (k >= 3), each of at least 12
// planes (the lean class: 9) of h + 4k rows (a mesh of one row: H) x W (a
// column shard: w + 2 xh).
extern "C" int jrl_fluid_pass_sh(const FluidPassShSrc* src, const FluidPassShCols* cols,
                                 float* f_out, float* rho_out, float* vel_out, float* scr0,
                                 float* scr1, int step0, int k, const FluidPassShParams* p,
                                 void* stream) {
  const ShardGeom& s = p->s;
  const bool col_shard = s.w != s.W;
  const int bad = sh_plan_check(s, k, p->t, scr0, scr1, true);
  if (bad) return bad;
  if (s.h < s.H && (!src->top || !src->bot)) return (int)cudaErrorInvalidValue;
  if (col_shard && (p->lean || !cols || !cols->left || !cols->right))
    return (int)cudaErrorInvalidValue;
  const int bytes = FptLayout(p->t.rmax, p->t.smax).bytes();
  if (bytes > SH_SMEM_CAP) return (int)cudaErrorInvalidValue;
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    int most = 0;
    const int err = col_shard ? sh_coresident<fluid_pass_sh_cols<K>>(bytes, &most)
                              : sh_coresident<fluid_pass_sh_tiles<K>>(bytes, &most);
    if (err != (int)cudaSuccess) return err;
    if (p->t.grid < 1 || p->t.grid > most) return (int)cudaErrorCooperativeLaunchTooLarge;
    FluidPassShSrc a0 = *src;
    FluidPassShParams a7 = *p;
    FluidPassShCols a8 = col_shard ? *cols : FluidPassShCols{};
    int a6 = step0;
    void* args[] = {&a0, &f_out, &rho_out, &vel_out, &scr0, &scr1, &a6, &a7, &a8};
    const void* const kernel = col_shard ? (const void*)fluid_pass_sh_cols<K>
                                         : (const void*)fluid_pass_sh_tiles<K>;
    return (int)cudaLaunchCooperativeKernel(kernel, dim3(p->t.grid), dim3(FPT_THREADS), args,
                                            bytes, (cudaStream_t)stream);
  });
}

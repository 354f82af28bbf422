// JRL fluid phase on one shard of a row mesh: a k-step pass (k = 1..4) in
// one launch, k steps of fluid step A and B fused, the full class (the
// moving tip, the walls) or the lean class (a shard above the tip front)
// on the whole shard. One persistent cooperative grid, no larger than the
// co-resident limit: sub-step j runs over the whole shard (its rows
// extended by 2 (k - 1 - j) a side) in 2D tiles on every SM, a grid
// barrier between sub-steps, the sub-steps' planes in two scratch buffers.
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
#include "fluid_tile.cuh"

// Mirrors kernels/jrl_sharded.py::PassShParams (outside the unnamed
// namespace: the C entry point takes it, and must keep external linkage).
struct FluidPassShParams {
  FluidParams a;
  FluidBParams b;
  ShardGeom s;   // the shard's place: a row mesh (w == W, col0 == 0, xh == 0)
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

// The pass of class CLS at depth K over every tile of the launch.
template <int CLS, int K>
__device__ __forceinline__ void fpt_run(const FluidPassShSrc& src, float* f_out, float* rho_out,
                                        float* vel_out, float* scr0, float* scr1, int step0,
                                        const FluidPassShParams& p, float* smem, uint64_t* bar) {
  constexpr bool LEAN = CLS == TILE_LEAN;
  const ShardGeom& s = p.s;
  const int H = s.H, W = s.W, hw = s.h * s.w;
  const bool whole = s.h == s.H;  // a mesh of one row
  const int soff = whole ? 0 : 2 * K;  // scratch row of shard row 0
  const size_t splane = (size_t)(whole ? H : s.h + 4 * K) * W;  // floats a scratch plane
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
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const ShTile tl(t, nty, p.t.ntx, E, W);
      const int rb0 = r_lo + tl.e0;  // shard row of the first B row
      // sub-step 0 from the body and the pieces, sub-step j > 0 from the
      // scratch that j - 1 wrote
      const auto row_of = [&](int q, int i) {
        const int r = rb0 - 2 + i;
        return j == 0 ? fpt_row<K>(src, s, q, r)
                      : s_in + q * splane + (size_t)(whole ? wrap1(r, H) : r + soff) * W;
      };
      // the last sub-step writes f_out, rho_out and vel_out; the others B's
      // f and A's rho, u, v (f alone for the lean class) to the scratch
      const auto store = [&](int bi, int x, const float* fo, float r, float u, float v) {
        const int rr = rb0 + bi;  // shard row
        if (j < K - 1) {
          float* const dst = s_out + (size_t)(rr + soff) * W + x;
#pragma unroll
          for (int q = 0; q < 9; ++q) dst[q * splane] = fo[q];
          if (!LEAN) {
            dst[9 * splane] = r;
            dst[10 * splane] = u;
            dst[11 * splane] = v;
          }
        } else {
          const int o = rr * s.w + x;
#pragma unroll
          for (int q = 0; q < 9; ++q) f_out[q * hw + o] = fo[q];
          rho_out[o] = r;
          vel_out[o] = u;
          vel_out[hw + o] = v;
        }
      };
      fluid_tile<LEAN>(tl, wrap1(s.row0 + rb0 - 2, H), fg, p.a, p.b, p.t.rmax, p.t.smax, smem,
                       bar_a, parity, row_of, store);
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

}  // namespace

// Registers per thread and local (spill) bytes of the instance at depth k.
extern "C" int jrl_fluid_pass_sh_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(fluid_pass_sh_tiles<decltype(kc)::value>, regs, local_bytes);
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

// One k-step pass of a shard from step step0. src: the shard's planes and
// its 2k-row pieces, rows 16-byte aligned (W % 4 == 0); the outputs apart
// from them. A cooperative grid of p->t.grid blocks (refused, nothing
// launched, over the co-resident limit); scratch buffers scr0 (k >= 2) and
// scr1 (k >= 3), each of at least 12 planes (the lean class: 9) of h + 4k
// rows (a mesh of one row: H) x W.
extern "C" int jrl_fluid_pass_sh(const FluidPassShSrc* src, float* f_out, float* rho_out,
                                 float* vel_out, float* scr0, float* scr1, int step0, int k,
                                 const FluidPassShParams* p, void* stream) {
  const ShardGeom& s = p->s;
  const int bad = sh_plan_check(s, k, p->t, scr0, scr1);
  if (bad) return bad;
  if (s.h < s.H && (!src->top || !src->bot)) return (int)cudaErrorInvalidValue;
  const int bytes = FptLayout(p->t.rmax, p->t.smax).bytes();
  if (bytes > SH_SMEM_CAP) return (int)cudaErrorInvalidValue;
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    int most = 0;
    const int err = sh_coresident<fluid_pass_sh_tiles<K>>(bytes, &most);
    if (err != (int)cudaSuccess) return err;
    if (p->t.grid < 1 || p->t.grid > most) return (int)cudaErrorCooperativeLaunchTooLarge;
    FluidPassShSrc a0 = *src;
    FluidPassShParams a7 = *p;
    int a6 = step0;
    void* args[] = {&a0, &f_out, &rho_out, &vel_out, &scr0, &scr1, &a6, &a7};
    return (int)cudaLaunchCooperativeKernel((const void*)fluid_pass_sh_tiles<K>, dim3(p->t.grid),
                                            dim3(FPT_THREADS), args, bytes,
                                            (cudaStream_t)stream);
  });
}

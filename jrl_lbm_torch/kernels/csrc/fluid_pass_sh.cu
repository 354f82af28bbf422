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
// grid, ... of each sub-step. A tile of R x S B cells:
// - copies its window, rows -2 .. R + 1 and columns [sx0 - 2, sx1 + 2)
//   cut to the grid and rounded out to 16 bytes, of 12 planes (f 0-8, rho
//   9, u 10, v 11; the lean class: f alone) by cp.async.bulk counted on
//   one mbarrier, one plane row a thread (one warp issuing them all cost
//   up to 40 us a pass): sub-step 0 from the body and the pieces
//   (fpt_row), sub-step j > 0 from the scratch that j - 1 wrote;
// - the full class's geometry (flag with the tip bit, phi) of every window
//   cell at step step0 + j, once, into a table (TileGeo);
// - A on (R + 2) x (S + 2) cells (rows -1 .. R, columns one past the
//   strip inside the grid): rho, u, v into a window-shaped table, f into a
//   table of the R x S B cells (B reads f at its own cell only); then one
//   __syncthreads and B on R x S, threads on consecutive columns;
// - the last sub-step writes f_out, rho_out and vel_out; the others write
//   B's f and A's rho, u, v (f alone for the lean class) to the scratch
//   buffer j % 2, [12][SR][W] with shard row r at scratch row r + 2k (on a
//   mesh of one row: [12][H][W], row r at r).
// One grid.sync() ends each sub-step but the last: sub-step j + 1 reads
// what every block wrote (a proxy fence before its bulk copies, which read
// through the async proxy). Reach: A reads one cell away, except an
// OUTFLOW cell of row 0, which recomputes row 1's streaming and reads two
// rows up; on the window's last A row that lands one row past the copied
// window (a padding row of the tables), where the window wraps past H:
// only the top wall row's B reads that A, and an OBSTACLE cell's B reads
// nothing around it. Every other read of a real cell stays in the window.
// The x edges reflect (jrl_common.cuh::at_dx): nothing reads past them.
// The launch form (the tile of a sub-step, the co-resident limit, the proxy
// fence) is pass_sh.cuh's, shared with the C phases' passes.
#include "pass_sh.cuh"

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

// -DJRL_FPT_NO_CELLS (no cell code: A and B copy their cell) and
// -DJRL_FPT_NO_GEO (no geometry table) build timing probes with wrong
// results (tools/fluid_pass_sh_probe.py variants)
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

// The pass of class CLS at depth K over every tile of the launch.
template <int CLS, int K>
__device__ __forceinline__ void fpt_run(const FluidPassShSrc& src, float* f_out, float* rho_out,
                                        float* vel_out, float* scr0, float* scr1, int step0,
                                        const FluidPassShParams& p, float* smem, uint64_t* bar) {
  constexpr bool LEAN = CLS == TILE_LEAN;
  constexpr int NPL = LEAN ? 9 : PASS_NP;  // planes of a window row and of the scratch
  const ShardGeom& s = p.s;
  const int H = s.H, W = s.W, hw = s.h * s.w, tid = threadIdx.x;
  const bool whole = s.h == s.H;  // a mesh of one row
  const int soff = whole ? 0 : 2 * K;  // scratch row of shard row 0
  const size_t splane = (size_t)(whole ? H : s.h + 4 * K) * W;  // floats a scratch plane
  const FptLayout lay(p.t.rmax, p.t.smax);
  const int RS = lay.rs, WP = lay.wp;
  float* const in = smem;
  float* const rv = smem + lay.rv();
  float* const phis = smem + lay.phi();
  float* const fa = smem + lay.fa();
  unsigned char* const codes = reinterpret_cast<unsigned char*>(smem) + lay.codes_bytes();
  const uint32_t bar_a = smem_addr(bar);
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
    const int E = whole ? H : s.h + 4 * lvl;  // B rows of the sub-step
    const int r_lo = whole ? 0 : -2 * lvl;    // shard row of extended row 0
    const float* const s_in = (j & 1) ? scr0 : scr1;  // what sub-step j - 1 wrote
    float* const s_out = (j & 1) ? scr1 : scr0;
    const FluidGeo fg = fluid_geo(step0 + j, p.a);
    const int nty = sh_nty(p.t, j), ntiles = nty * p.t.ntx;
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const ShTile tl(t, nty, p.t.ntx, E, W);
      const int R = tl.e1 - tl.e0, S = tl.sx1 - tl.sx0, ncols = tl.cx1 - tl.cx0;
      const int rb0 = r_lo + tl.e0;                  // shard row of the first B row
      const int ybase = wrap1(s.row0 + rb0 - 2, H);  // global row of window row 0
      const int wr = R + 4;
      if (R < 1 || R > p.t.rmax || S < 1 || S > p.t.smax || ncols > RS) __trap();
      // the window's rows, a copy a plane row, one a thread; the barrier
      // orders the expected bytes before every copy and the tile before's
      // reads of the tables before this tile's writes
      if (tid == 0) mbar_expect(bar_a, 4u * (uint32_t)(ncols * NPL * wr));
      __syncthreads();
      for (int n = tid; n < NPL * wr; n += FPT_THREADS) {
        const int q = n / wr, i = n - q * wr, r = rb0 - 2 + i;
        const float* const row =
            j == 0 ? fpt_row<K>(src, s, q, r)
                   : s_in + q * splane + (size_t)(whole ? wrap1(r, H) : r + soff) * W;
        fence_proxy_async();         // the block's reads of the tables before the copy
        fence_proxy_async_global();  // the scratch rows written before grid.sync
        bulk_g2s(smem_addr(in + (q * WP + i) * RS), row + tl.cx0, 4u * (uint32_t)ncols, bar_a);
      }
      // the tip's values once per window cell and its padding row
#ifndef JRL_FPT_NO_GEO
      if (!LEAN)
        for (int n = tid; n < (wr + 1) * ncols; n += FPT_THREADS) {
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
          return TileGeo{H, W, ybase, RS, tl.cx0, fg.flat, fg.vel_obs, phis, codes};
        }
      }();
      // A on rows -1 .. R and one column past the strip
      const int ax0 = max(tl.sx0 - 1, 0), acols = min(tl.sx1 + 1, W) - ax0;
#pragma unroll 1
      for (int n = tid; n < (R + 2) * acols; n += FPT_THREADS) {
        const int ia = n / acols, x = ax0 + n - ia * acols, i = ia + 1, c = x - tl.cx0;
        float fo[9], r, u, v;
#ifdef JRL_FPT_NO_CELLS
        const TileIn a{in, RS, WP, i, c};
        for (int q = 0; q < 9; ++q) fo[q] = a.F(q, 0, 0);
        r = a.R(0, 0), u = a.U(0, 0), v = a.V(0, 0);
#else
        fluid_a_cell(TileIn{in, RS, WP, i, c}, geo, p.a.cs2tau, wrap1(ybase + i, H), x, fo, r, u,
                     v);
#endif
        rv[i * RS + c] = r;
        rv[(WP + i) * RS + c] = u;
        rv[(2 * WP + i) * RS + c] = v;
        const int bi = i - 2, bc = x - tl.sx0;
        if (bi >= 0 && bi < R && bc >= 0 && bc < S) {
#pragma unroll
          for (int q = 0; q < 9; ++q) fa[(q * p.t.rmax + bi) * p.t.smax + bc] = fo[q];
        }
      }
      __syncthreads();
      // B on the tile's cells
#pragma unroll 1
      for (int n = tid; n < R * S; n += FPT_THREADS) {
        const int bi = n / S, bc = n - bi * S, x = tl.sx0 + bc, i = bi + 2, c = x - tl.cx0;
        float fo[9];
#ifdef JRL_FPT_NO_CELLS
        for (int q = 0; q < 9; ++q) fo[q] = fa[(q * p.t.rmax + bi) * p.t.smax + bc];
#else
        fluid_b_cell(TileB{rv, fa + bi * p.t.smax + bc, RS, WP, p.t.rmax * p.t.smax, i, c}, geo,
                     p.b,
                     wrap1(ybase + i, H), x, fo);
#endif
        const float r = rv[i * RS + c], u = rv[(WP + i) * RS + c], v = rv[(2 * WP + i) * RS + c];
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
  // a launch whose plan the host got wrong stops (an error, not wrong
  // cells): its tables must fit the shared memory
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)FptLayout(p.t.rmax, p.t.smax).bytes() > dyn) __trap();
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

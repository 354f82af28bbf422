// JRL fluid phase on one shard of a row mesh: a k-step pass (k = 1..4) in
// one launch, k steps of fluid step A and B fused, the shard's rows
// streamed through rings of rows in shared memory, the full class (the
// moving tip, the walls) or the lean class (a shard above the tip front)
// on every run of the launch.
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
// (~420 lean). What the pair pays, and what this design does about it:
// - two launches and two halo exchanges a step, each a host call per
//   shard: one exchange of 2k rows and one launch a shard per k steps;
// - A's f, rho and vel written to device memory and read back by B: A and
//   B share a phase of one block, A's rows kept in shared memory;
// - every read decoded by the shard accessor (jrl_shard.cuh::ShardState:
//   body, row piece or column block per value): the source is chosen once
//   a ring row (a body row, or a row of the top or bottom piece), and the
//   row is copied by cp.async.bulk (pass_state.cuh);
// - the tip SDF evaluated once per neighbour read: once per window cell
//   and sub-step, into a geometry ring (pass_state.cuh::RingGeo).
//
// Items. Block (strip, run) writes the shard rows [y0, y1) of run r
// ([r h / nruns, (r + 1) h / nruns)) x the columns [sx0, sx1) of strip s
// (multiples of 4). Its window is the rows y0 - 2k .. y1 + 2k - 1 (window
// row i is shard row y0 - 2k + i: a body row, or a row of a piece; on a
// mesh of one row the body's own rows mod h) and the columns [sx0 - 2k,
// sx1 + 2k) cut to the grid (the x edges reflect: nothing reads past them)
// and rounded out to 16 bytes. Sub-step j (0 .. k-1, lvl = k - 1 - j)
// runs A on window rows [2j + 1, n_in - 2j - 1) and columns 2 lvl + 1 past
// the strip, B on one row and column fewer a side: the level pyramid of
// the JAX kernel, whose last B gives the run's cells.
//
// Wavefront. The block's threads are k groups of fps_cols(k) (a multiple
// of 32); group j runs sub-step j, one column a thread, A and B on one
// column each phase. Phase t runs A_j on window row t + 1 - 5j and B_j two
// rows behind it: B_j reads A_j's rho and vel one row away and its f at the
// cell, A_{j+1} reads B_j's f up to two rows away (an OUTFLOW cell of row
// 0 recomputes row 1's streaming) and A_j's rho and vel one row away, all
// written in earlier phases; one barrier a phase. Rings of each sub-step
// (pass_state.cuh's, one row a slot, its window row modulo the slots):
// - its input, PASS_D = 5 slots of 12 planes (f 0-8, rho 9, u 10, v 11):
//   for j = 0 the rows copied by one thread four rows ahead, counted on the
//   slot's mbarrier; for j > 0 written by B_{j-1}, which also copies A_{j-1}'s
//   rho, u and v of its row there (a lean pass: f alone);
// - A's f, PASS_FA = 3 slots, each cell read back by the thread that wrote
//   it; A's rho, u, v, PASS_RV = 4 slots;
// - the geometry (full class): flag, tip bit and phi of the window's cells
//   at the sub-step's step, PASS_G = 8 slots, filled by the group four rows
//   ahead of its A.
// The only read past a ring's valid rows is that OUTFLOW source two rows
// away at the window's last A row: it lands on a row 0 past a grid that
// wraps there, whose A only the top wall row's B reads, and an OBSTACLE
// cell's B reads nothing around it.
#include "jrl_shard.cuh"
#include "pass_state.cuh"

// Mirrors kernels/jrl_sharded.py::PassShParams (outside the unnamed
// namespace: the C entry point takes it, and must keep external linkage).
struct FluidPassShParams {
  FluidParams a;
  FluidBParams b;
  ShardGeom s;  // the shard's place: a row mesh (w == W, col0 == 0, xh == 0)
  int nstrips;  // column strips (FpsStrip)
  int nruns;    // row runs: run r is the shard rows [r h / nruns, (r + 1) h / nruns)
  int rs;       // floats of a ring row: the widest strip window (a multiple of 4)
  int lean;     // the lean class on every run
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

constexpr int FPS_THREADS = 512;
constexpr int FPS_LAG = 5;  // rows A_{j+1} runs behind A_j
// floats a ring column takes per sub-step (input, A's f, A's rho u v, phi)
constexpr int FPS_FLOATS = PASS_D * PASS_NP + PASS_FA * 9 + PASS_RV * 3 + PASS_G;
constexpr int FPS_BYTES = FPS_FLOATS * 4 + PASS_G;  // and the geometry codes
constexpr int FPS_SMEM_MAX = 232448;                 // a block's dynamic shared memory

// Columns of a group of threads at depth k (the A columns of sub-step 0).
__host__ __device__ constexpr int fps_cols(int k) { return (FPS_THREADS / k) & ~31; }
__host__ __device__ constexpr int fps_smem_bytes(int k, int rs) { return k * FPS_BYTES * rs; }
// The widest ring row at depth k: a group's columns and a strip window's
// 16-byte ends, within the shared memory.
__host__ __device__ constexpr int fps_max_rs(int k) {
  return fps_cols(k) + 8 < ((FPS_SMEM_MAX / (k * FPS_BYTES)) & ~3)
             ? fps_cols(k) + 8
             : (FPS_SMEM_MAX / (k * FPS_BYTES)) & ~3;
}

// Strip s of ns: the columns [sx0, sx1) it writes (ends on multiples of
// 4, W % 4 == 0) and the window [cx0, cx1) its ring rows hold.
struct FpsStrip {
  int sx0, sx1, cx0, cx1;
  __device__ FpsStrip(int s, int ns, int W, int halo) {
    sx0 = (s * W / ns) & ~3;
    sx1 = s + 1 == ns ? W : ((s + 1) * W / ns) & ~3;
    cx0 = max(sx0 - halo, 0) & ~3;
    cx1 = min((sx1 + halo + 3) & ~3, W);
  }
};

// Shard row r (-2k <= r < h + 2k) of ring plane q (f 0-8, rho 9, u 10, v
// 11): a body row, or a row of a piece; on a mesh of one row the body mod h.
template <int K>
__device__ __forceinline__ const float* fps_row(const FluidPassShSrc& src, const ShardGeom& s,
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

// The pass of one block (strip, run) of class CLS at depth K.
template <int CLS, int K>
__device__ __forceinline__ void fps_run(const FluidPassShSrc& src, float* f_out, float* rho_out,
                                        float* vel_out, int step0, const FluidPassShParams& p,
                                        float* smem, uint64_t* bars) {
  constexpr bool LEAN = CLS == TILE_LEAN;
  constexpr int CW = fps_cols(K);
  constexpr int NPL = LEAN ? 9 : PASS_NP;  // planes an input row loads
  const ShardGeom& s = p.s;
  const int H = s.H, W = s.W, hw = s.h * s.w, RS = p.rs;
  const FpsStrip st(blockIdx.x, p.nstrips, W, 2 * K);
  const int y0 = blockIdx.y * s.h / p.nruns, y1 = (blockIdx.y + 1) * s.h / p.nruns;
  const int n_in = y1 - y0 + 4 * K;                   // window rows
  const int ybase = wrap1(s.row0 + y0 - 2 * K, H);    // global row of window row 0
  const int ncols = st.cx1 - st.cx0;
  const int tid = threadIdx.x;
  const int j = tid / CW, lane = tid - j * CW;  // sub-step (j >= K: idle) and column
  const bool active = j < K;
  const int jj = active ? j : 0, lvl = K - 1 - jj;

  // sub-step jj's rings: its input, A's f, A's rho u v, phi; the codes after
  // every sub-step's floats
  float* const in = smem + jj * FPS_FLOATS * RS;
  float* const fa = in + PASS_D * PASS_NP * RS;
  float* const rv = fa + PASS_FA * 9 * RS;
  float* const phis = rv + PASS_RV * 3 * RS;
  unsigned char* const codes =
      reinterpret_cast<unsigned char*>(smem + K * FPS_FLOATS * RS) + jj * PASS_G * RS;
  float* const next = smem + (jj + 1) * FPS_FLOATS * RS;  // sub-step jj + 1's input

  if (tid == 0) {
    for (int i = 0; i < PASS_D; ++i) mbar_init(smem_addr(bars + i));
    mbar_init_fence();
    // the initialised mbarriers visible to the async proxy, whose copies
    // complete on them (pass_state.cuh)
    fence_proxy_async();
  }
  __syncthreads();
  // thread 0: window row i into slot i % PASS_D of sub-step 0's input
  auto issue = [&](int i) {
    const int sl = i % PASS_D, r = y0 - 2 * K + i;
    const uint32_t bar = smem_addr(bars + sl), bytes = 4u * (uint32_t)ncols;
    mbar_expect(bar, bytes * NPL);
    float* const dst = smem + sl * PASS_NP * RS;
#pragma unroll
    for (int q = 0; q < NPL; ++q)
      bulk_g2s(smem_addr(dst + q * RS), fps_row<K>(src, s, q, r) + st.cx0, bytes, bar);
  };
  auto wait_row = [&](int i) { mbar_wait(smem_addr(bars + i % PASS_D), (i / PASS_D) & 1); };
  if (tid == 0)
    for (int i = 0; i < PASS_D && i < n_in; ++i) issue(i);

  // sub-step jj's tip: FluidGeo's values once per window cell, into its ring
  const FluidGeo fg = fluid_geo(step0 + jj, p.a);
  auto geo_row = [&](int i) {
    const int y = wrap1(ybase + i, H);
    float* const ph = phis + (i & (PASS_G - 1)) * RS;
    unsigned char* const cd = codes + (i & (PASS_G - 1)) * RS;
    for (int c = lane; c < ncols; c += CW) cd[c] = geo_code(fg, y, st.cx0 + c, ph[c]);
  };
  const auto geo = [&] {
    if constexpr (LEAN) {
      return LeanGeo{H, W};
    } else {
      return RingGeo{H, W, ybase, RS, st.cx0, fg.flat, fg.vel_obs, phis, codes};
    }
  }();
  if (!LEAN && active)
    for (int i = 0; i < 4 && i < n_in; ++i) geo_row(i);
  __syncthreads();  // the geometry rows the first A reads

  // this thread's column, counted from sub-step 0's first A column
  const int x = max(st.sx0 - (2 * K - 1), 0) + lane, c = x - st.cx0;
  const bool a_on = active && x >= max(st.sx0 - (2 * lvl + 1), 0) &&
                    x < min(st.sx1 + 2 * lvl + 1, W);
  const bool b_on = active && x >= max(st.sx0 - 2 * lvl, 0) && x < min(st.sx1 + 2 * lvl, W);
  const int a_lo = 2 * jj + 1, a_hi = n_in - 2 * jj - 1;  // A's window rows
  const int t_end = n_in + 3 * K - 4;                      // the last B of sub-step k - 1, + 1

#pragma unroll 1
  for (int t = 0; t < t_end; ++t) {
    // slot (t + 4) % PASS_D: its row t - 1 was last read in phase t - 1
    if (tid == 0 && t >= 1 && t + 4 < n_in) {
      fence_proxy_async();
      issue(t + 4);
    }
    const int ia = t + 1 - FPS_LAG * jj, ib = ia - 2;
    const bool do_a = a_on && ia >= a_lo && ia < a_hi;
    const bool do_b = b_on && ib > a_lo && ib < a_hi - 1;
    if (j == 0 && do_a) {
      if (t == 0)
        for (int i = 0; i < 3; ++i) wait_row(i);
      if (t + 3 < n_in) wait_row(t + 3);
    }
    if (!LEAN && active && ia + 3 >= 4 && ia + 3 < n_in) geo_row(ia + 3);
    if (do_a) {
      const int y = wrap1(ybase + ia, H), kf = ia % PASS_FA, kr = ia & (PASS_RV - 1);
      float fo[9], r, u, v;
      fluid_a_cell(PassIn{in, RS, ia % PASS_D, c}, geo, p.a.cs2tau, y, x, fo, r, u, v);
#pragma unroll
      for (int q = 0; q < 9; ++q) fa[(kf * 9 + q) * RS + c] = fo[q];
      rv[(kr * 3 + 0) * RS + c] = r;
      rv[(kr * 3 + 1) * RS + c] = u;
      rv[(kr * 3 + 2) * RS + c] = v;
    }
    if (do_b) {
      const int y = wrap1(ybase + ib, H), kr = ib & (PASS_RV - 1);
      float fo[9];
      fluid_b_cell(PassB{rv, fa + (ib % PASS_FA) * 9 * RS, RS, kr, c}, geo, p.b, y, x, fo);
      const float r = rv[(kr * 3 + 0) * RS + c], u = rv[(kr * 3 + 1) * RS + c],
                  v = rv[(kr * 3 + 2) * RS + c];
      if (jj < K - 1) {
        float* const dst = next + (ib % PASS_D) * PASS_NP * RS + c;
#pragma unroll
        for (int q = 0; q < 9; ++q) dst[q * RS] = fo[q];
        if (!LEAN) {
          dst[9 * RS] = r;
          dst[10 * RS] = u;
          dst[11 * RS] = v;
        }
      } else {
        const int o = (y0 - 2 * K + ib) * s.w + x;
#pragma unroll
        for (int q = 0; q < 9; ++q) f_out[q * hw + o] = fo[q];
        rho_out[o] = r;
        vel_out[o] = u;
        vel_out[hw + o] = v;
      }
    }
    __syncthreads();
  }
}

template <int K>
__global__ void __launch_bounds__(FPS_THREADS, 1) fluid_pass_sh_kernel(
    FluidPassShSrc src, float* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, int step0, FluidPassShParams p) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[PASS_D];
  // a block whose plan the host got wrong stops the launch (an error, not
  // wrong cells): its rings must fit the shared memory, its strip the
  // threads and the ring rows, its window the grid's rows once
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  const FpsStrip st(blockIdx.x, p.nstrips, p.s.W, 2 * K);
  const int y0 = blockIdx.y * p.s.h / p.nruns, y1 = (blockIdx.y + 1) * p.s.h / p.nruns;
  if (p.rs > fps_max_rs(K) || (unsigned)fps_smem_bytes(K, p.rs) > dyn ||
      st.cx1 - st.cx0 > p.rs || st.sx0 >= st.sx1 ||
      min(st.sx1 + 2 * K - 1, p.s.W) - max(st.sx0 - (2 * K - 1), 0) > fps_cols(K) || y0 >= y1 ||
      y1 - y0 + 4 * K > p.s.H)
    __trap();
  if (p.lean)
    fps_run<TILE_LEAN, K>(src, f_out, rho_out, vel_out, step0, p, smem, bars);
  else
    fps_run<TILE_FULL, K>(src, f_out, rho_out, vel_out, step0, p, smem, bars);
}

}  // namespace

// Registers per thread and local (spill) bytes of the instance at depth k.
extern "C" int jrl_fluid_pass_sh_info(int k, int* regs, int* local_bytes) {
  return with_tile_k(k, [&](auto kc) {
    return kernel_info(fluid_pass_sh_kernel<decltype(kc)::value>, regs, local_bytes);
  });
}

// The launch's shape at depth k, which the host plan mirrors
// (kernels/jrl_sharded.py::pass_sh_plan): threads a block, columns a
// group, the widest ring row, shared-memory bytes per ring column.
extern "C" int jrl_fluid_pass_sh_shape(int k, int* threads, int* cols, int* max_rs,
                                       int* bytes_per_col) {
  if (k < 1 || k > TILE_KMAX) return (int)cudaErrorInvalidValue;
  *threads = FPS_THREADS;
  *cols = fps_cols(k);
  *max_rs = fps_max_rs(k);
  *bytes_per_col = k * FPS_BYTES;
  return (int)cudaSuccess;
}

// One k-step pass of a shard from step step0: p->nstrips x p->nruns blocks.
// src: the shard's planes and its 2k-row pieces, rows 16-byte aligned
// (W % 4 == 0); the outputs apart from them.
extern "C" int jrl_fluid_pass_sh(const FluidPassShSrc* src, float* f_out, float* rho_out,
                                 float* vel_out, int step0, int k, const FluidPassShParams* p,
                                 void* stream) {
  const ShardGeom& s = p->s;
  if (k < 1 || k > TILE_KMAX || p->rs < 4 || p->rs % 4 || p->rs > fps_max_rs(k) || s.W % 4 ||
      s.w != s.W || s.col0 != 0 || s.xh != 0 || p->nstrips < 1 || p->nruns < 1 ||
      p->nruns > s.h || (s.h < s.H && (!src->top || !src->bot || 2 * k > s.h)) || 4 * k >= s.H)
    return (int)cudaErrorInvalidValue;
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const int bytes = fps_smem_bytes(K, p->rs);
    const int err = smem_attr_once<fluid_pass_sh_kernel<K>>(fps_smem_bytes(K, fps_max_rs(K)));
    if (err != (int)cudaSuccess) return err;
    fluid_pass_sh_kernel<K><<<dim3(p->nstrips, p->nruns), FPS_THREADS, bytes,
                              (cudaStream_t)stream>>>(*src, f_out, rho_out, vel_out, step0, *p);
    return (int)cudaGetLastError();
  });
}
